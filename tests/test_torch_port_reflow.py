"""Reflow distillation of the PyTorch port (flow/reflow.py, cli/reflow.py)
against the JAX package, on the CPU (where the GroupNorm wrapper and its
backward run their plain versions).

* reflow_loss with t injected from JAX's draw: rtol 1e-6 (the same float32
  operations);
* one make_reflow_train_step step (small U-Net: 16 channels, channel_mult
  (1, 2), one res block, 16 px, dropout 0, B = 4, t from JAX's `kt`): loss
  rtol 1e-5, post-Adam parameters within 1e-4·max|ref| + 1e-6. Two
  channels a GroupNorm group at least: with one, a conv bias before the
  norm has an analytically zero gradient, and Adam's first step moves it
  by ±lr on the sign of float32 noise, in either framework;
* generate_couplings: x1 against JAX ode_scan on the port's x0 (1e-4),
  batch i's x0 from derive_seed(seed, i), and JAX's constant-field case
  (10 pairs at a generation batch of 4 give 12, x1 = x0 + c);
* the reflow CLI end to end from reference-layout teachers, writing the
  `_reflow_best.pth` files that the sample CLIs load with --reflow, bit for
  bit reproducible from its seed; its refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.flow import reflow as jreflow
from ratio_guided_multimodal_fm_tpu.models import FlexibleUNet as JUNet
from ratio_guided_multimodal_fm_tpu.train import steps as jsteps
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    reflow as reflow_cli,
    sample,
    sample_mnist_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.common import velocity_fn
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow import reflow as preflow
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.models import FlexibleUNet as PUNet
from ratio_guided_multimodal_fm_tpu_torch.train import checkpoint as pck
from ratio_guided_multimodal_fm_tpu_torch.train.steps import create_fm_state

torch.set_num_threads(2)

H = 16
KW = dict(in_channels=1, img_size=H, model_channels=16, channel_mult=(1, 2),
          num_res_blocks=1, dropout=0.0)
BRIDGE = dict(channel_mult=(1, 2), num_res_blocks=1)


def _jax_net(seed=0):
    net = JUNet(**KW)
    v = jax.tree_util.tree_map(np.asarray, dict(net.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, H, 1)), jnp.zeros((1,)))))
    rng = np.random.RandomState(seed + 1)
    oc = v["params"]["out_conv"]
    oc["kernel"] = (rng.randn(*oc["kernel"].shape) * 0.1).astype(np.float32)
    oc["bias"] = (rng.randn(*oc["bias"].shape) * 0.1).astype(np.float32)
    return net, v


def _port_net(v):
    net = PUNet(**KW)
    net.load_state_dict(unet_state_dict(v, **BRIDGE), strict=True)
    return net


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_reflow_loss_matches_jax():
    key = jax.random.PRNGKey(3)
    x0, x1 = _np(5, H, H, 1, seed=1), _np(5, H, H, 1, seed=2)

    def jvel(x, t):
        return jnp.sin(x) * t[:, None, None, None]

    want = float(jreflow.reflow_loss(jvel, key, jnp.asarray(x0),
                                     jnp.asarray(x1)))
    t = np.array(jax.random.uniform(key, (5,), jnp.float32))
    got = preflow.reflow_loss(
        lambda x, tt: torch.sin(x) * tt[:, None, None, None],
        torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_reflow_loss_zero_for_the_exact_field():
    x0, x1 = torch.from_numpy(_np(8, 4, seed=3)), torch.from_numpy(
        _np(8, 4, seed=4))
    g = torch.Generator().manual_seed(0)
    assert float(preflow.reflow_loss(lambda x, t: x1 - x0, x0, x1,
                                     generator=g)) < 1e-10
    assert float(preflow.reflow_loss(lambda x, t: torch.zeros_like(x), x0, x1,
                                     generator=g)) > 0.1


def test_reflow_step_matches_jax():
    jnet, v = _jax_net(0)
    x0, x1 = _np(4, H, H, 1, seed=5), _np(4, H, H, 1, seed=6)
    key = jax.random.PRNGKey(11)
    jstate = jsteps.create_fm_state(jnet, jax.random.PRNGKey(0), (H, H, 1),
                                    lr=1e-4).replace(params=v["params"])
    jstate, jloss = jreflow.make_reflow_train_step(jnet, donate=False)(
        jstate, jnp.asarray(x0), jnp.asarray(x1), key)
    kt, _ = jax.random.split(key)
    t = np.array(jax.random.uniform(kt, (4,), jnp.float32))

    state = create_fm_state(_port_net(v), "cpu", lr=1e-4)
    loss = preflow.make_reflow_train_step()(
        state, torch.from_numpy(x0), torch.from_numpy(x1),
        t=torch.from_numpy(t))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = unet_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params)}, **BRIDGE)
    got = state.model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for k, ref in want.items():
        ref = ref.numpy()
        assert np.abs(got[k].numpy() - ref).max() <= \
            1e-4 * np.abs(ref).max() + 1e-6, k
        moved = max(moved, float(np.abs(ref - unet_state_dict(
            v, **BRIDGE)[k].numpy()).max()))
    assert moved > 5e-5          # the step moved the parameters (lr 1e-4)
    with pytest.raises(ValueError, match="generator"):
        preflow.make_reflow_train_step()(state, torch.from_numpy(x0),
                                         torch.from_numpy(x1))


def test_reflow_step_draws_from_its_generator():
    _, v = _jax_net(1)
    x0, x1 = torch.from_numpy(_np(4, H, H, 1, seed=7)), torch.from_numpy(
        _np(4, H, H, 1, seed=8))
    losses = []
    for seed in (1, 1, 2):
        state = create_fm_state(_port_net(v), "cpu")
        losses.append(float(preflow.make_reflow_train_step()(
            state, x0, x1, torch.Generator().manual_seed(seed))))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_generate_couplings_matches_jax_ode_scan(solver):
    jnet, v = _jax_net(2)
    net = _port_net(v).eval()
    x0, x1 = preflow.generate_couplings(
        lambda m, x, t: velocity_fn(m)(x, t), net, 5, 6, (H, H, 1),
        num_steps=3, solver=solver, gen_batch_size=4, device="cpu")
    assert x0.shape == x1.shape == (8, H, H, 1)
    for i in range(2):           # batch i: its own position-addressed draw
        g = torch.Generator().manual_seed(derive_seed(5, i))
        assert torch.equal(x0[4 * i:4 * (i + 1)],
                           torch.randn((4, H, H, 1), generator=g))
    want = np.asarray(jcfm.ode_scan(lambda x, t: jnet.apply(v, x, t),
                                    jnp.asarray(x0.numpy()), 3,
                                    solver=solver))
    assert np.abs(want - x0.numpy()).max() > 1e-2
    np.testing.assert_allclose(x1.numpy(), want, rtol=1e-4, atol=1e-4)


def test_generate_couplings_constant_field():
    """v(x, t) = c: x1 = x0 + c; 10 pairs at a batch of 4 give 12 (JAX's
    case, tests/test_reflow.py)."""
    c = 0.37
    x0, x1 = preflow.generate_couplings(
        lambda p, x, t: torch.full_like(x, p["c"]), {"c": c}, 0,
        num_pairs=10, shape=(3, 3, 1), num_steps=7, gen_batch_size=4,
        device="cpu")
    assert len(x0) == 12 and len(x1) == 12
    np.testing.assert_allclose(x1.numpy(), x0.numpy() + c, rtol=1e-5,
                               atol=1e-5)
    assert float(x0.std()) > 0.5           # prior draws, not zeros
    jx0, jx1 = jreflow.generate_couplings(
        lambda p, x, t: jnp.full_like(x, p["c"]), {"c": c},
        jax.random.PRNGKey(0), num_pairs=10, shape=(3, 3, 1), num_steps=7,
        gen_batch_size=4)
    assert jx0.shape == tuple(x0.shape)
    np.testing.assert_allclose(jx1 - jx0, (x1 - x0).numpy(), rtol=1e-5,
                               atol=1e-5)


# ---- the CLI ----------------------------------------------------------------

def _save_teacher(root, make, fname, seed, full_dict=False):
    torch.manual_seed(seed)
    net = make()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        net.out_conv.weight.copy_(torch.randn(net.out_conv.weight.shape,
                                              generator=g) * 0.02)
    (root / "checkpoints").mkdir(exist_ok=True)
    sd = net.state_dict()
    torch.save({"model_state_dict": sd, "epoch": 1, "best_loss": 1.0}
               if full_dict else sd, root / "checkpoints" / fname)
    return sd


SMALL = ["--device", "cpu", "--pairs", "6", "--gen_batch_size", "4",
         "--teacher_steps", "2", "--epochs", "2", "--batch_size", "4"]


def test_reflow_cli_exp1_then_sample_with_reflow(tmp_path, monkeypatch):
    """Both experiment-1 flows distilled from bare state dicts; the sample
    CLI loads the students with --reflow; a second run of the same seed
    writes the same student bit for bit."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="checkpoint not found"):
        reflow_cli.main(SMALL)
    _save_teacher(tmp_path, pm.FlowMatchingUNet, "flow_x_best.pth", 0)
    teacher_y = _save_teacher(tmp_path, pm.FlowMatchingUNet,
                              "flow_y_rotate90_best.pth", 2)
    best = reflow_cli.main(SMALL + ["--modality", "x"])
    assert np.isfinite(best)
    reflow_cli.main(SMALL + ["--modality", "y", "--transform_type",
                             "rotate90"])
    out = tmp_path / "checkpoints" / "flow_y_rotate90_reflow_best.pth"
    ck = pck.load_checkpoint(str(out))
    assert set(ck) == {"model_state_dict", "optimizer_state_dict", "epoch",
                       "best_loss"}
    assert ck["epoch"] == 2 and np.isfinite(ck["best_loss"])
    assert set(ck["model_state_dict"]) == set(teacher_y)
    assert any(not torch.equal(ck["model_state_dict"][k], teacher_y[k])
               for k in teacher_y)       # the student moved
    x1, y1, diags = sample.main(["--device", "cpu", "--reflow",
                                 "--num_samples", "2", "--num_steps", "2"])
    assert x1.shape == y1.shape == (2, 28, 28, 1) and diags == {}
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    first = ck["model_state_dict"]
    reflow_cli.main(SMALL + ["--modality", "y"])
    again = pck.load_checkpoint(str(out))["model_state_dict"]
    assert all(torch.equal(first[k], again[k]) for k in first)


def test_reflow_cli_exp2_rounds(tmp_path, monkeypatch):
    """Experiment 2 from the train CLIs' full training dicts, two rounds
    (the second re-couples from the first student), then the sample CLI
    with --reflow."""
    monkeypatch.chdir(tmp_path)
    _save_teacher(tmp_path, lambda: pm.FlowMatchingUNetMNIST(img_size=32),
                  "flow_mnist32_best.pth", 4, full_dict=True)
    _save_teacher(tmp_path, pm.FlowMatchingUNetSVHN, "flow_svhn_best.pth", 6,
                  full_dict=True)
    for flow in ("mnist32", "svhn"):
        reflow_cli.main(SMALL + ["--experiment", "mnist_svhn", "--flow",
                                 flow, "--rounds", "2", "--epochs", "1",
                                 "--solver", "midpoint"])
        assert (tmp_path / "checkpoints" /
                f"flow_{flow}_reflow_best.pth").exists()
    x1, y1, _ = sample_mnist_svhn.main(["--device", "cpu", "--reflow",
                                        "--num_samples", "2", "--num_steps",
                                        "1"])
    assert x1.shape == (2, 32, 32, 1) and y1.shape == (2, 32, 32, 3)


@pytest.mark.parametrize("argv,exc,match", [
    # one process (no coordinator, or no count): the runtime flags pass
    # and the CLI goes on to look for its teacher flows
    (["--coordinator_address", "h:1"], SystemExit, "checkpoint not found"),
    (["--process_id", "0"], SystemExit, "checkpoint not found"),
    (["--num_processes", "2"], SystemExit, "checkpoint not found"),
    (["--experiment", "cifar"], SystemExit, None),
])
def test_reflow_cli_refusals(tmp_path, monkeypatch, argv, exc, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc, match=match):
        reflow_cli.main(["--device", "cpu"] + argv)
