"""Flow-matching training of the PyTorch port against the JAX package, on
the CPU (where the GroupNorm wrapper and its backward run their plain
versions).

Random streams cannot cross frameworks, so t and x_0 come from the JAX
keys' draws (or numpy) and are injected into the port; dropout is off.
Tolerances, each with its reason:

* interpolate / cfm_loss: rtol 1e-6 (the same float32 operations);
* one step's loss rtol 1e-5 and every gradient max |Δ| <= 1e-4·max|g| + 1e-6
  (float32 convolutions and sums in two frameworks, small U-Net: ch 16,
  channel_mult (1, 2), one res block, 16 px, B = 4);
* three Adam updates from injected gradients: rtol 1e-6, atol 1e-7
  (torch forms lr·m̂/(√v/√bc₂ + eps), optax lr·m̂/(√v̂ + eps));
* the EMA update: rtol 1e-6 (XLA may contract d·e + (1−d)·p into an FMA);
* a port-written .pth through the JAX importer: forward to 1e-5;
* resume and preemption: bit for bit (position-addressed randomness and
  batch order, float64 loss sums);
* loaders: equal batch for batch.
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.data import mnist_dataset as jmd
from ratio_guided_multimodal_fm_tpu.data import mnist_svhn as jms
from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.interop.torch_import import (
    import_state_dict,
)
from ratio_guided_multimodal_fm_tpu.models import (
    FlexibleUNet as JUNet,
    FlowMatchingUNetMNIST as JUNetMNIST,
)
from ratio_guided_multimodal_fm_tpu.train import steps as jsteps
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    train_flow,
    train_flow_mnist32,
    train_flow_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, derive_seed
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_dataset as pmd
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_svhn as pms
from ratio_guided_multimodal_fm_tpu_torch.flow import cfm as pcfm
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleUNet as PUNet,
    FlowMatchingUNetMNIST as PUNetMNIST,
)
from ratio_guided_multimodal_fm_tpu_torch.train import checkpoint as pck
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    EarlyStopper,
    finish_preemptible,
    restore_preempt,
    train_flow_matching_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.preemption import (
    PreemptionGuard,
    request_preemption,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    make_fm_train_step,
)

torch.set_num_threads(2)

H = 16
KW = dict(in_channels=1, img_size=H, model_channels=16, channel_mult=(1, 2),
          num_res_blocks=1, dropout=0.0)
BRIDGE = dict(channel_mult=(1, 2), num_res_blocks=1)


def _jax_net(seed=0):
    """A small JAX U-Net and its variables, out_conv perturbed (zero-init
    otherwise, which leaves the inner gradients zero)."""
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


def _x1(seed=3, b=4):
    return np.random.RandomState(seed).randn(b, H, H, 1).astype(np.float32)


def _keys_draws(key, b):
    """The t and x_0 that JAX's _fm_substep draws from `key`."""
    kt, kn, _ = jax.random.split(key, 3)
    t = jax.random.uniform(kt, (b,), jnp.float32)
    x0 = jax.random.normal(kn, (b, H, H, 1), jnp.float32)
    return np.array(t), np.array(x0)


def _sd_np(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


# ---- losses ---------------------------------------------------------------

def test_interpolate_matches_jax():
    key = jax.random.PRNGKey(5)
    x1 = _x1()
    t = np.random.RandomState(6).rand(4).astype(np.float32)
    jxt, ju = jcfm.interpolate(key, jnp.asarray(x1), jnp.asarray(t))
    x0 = np.array(jax.random.normal(key, x1.shape, jnp.float32))
    pxt, pu = pcfm.interpolate(torch.from_numpy(x1), torch.from_numpy(t),
                               torch.from_numpy(x0))
    np.testing.assert_allclose(pxt.numpy(), np.asarray(jxt), rtol=1e-6)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-6)


def test_cfm_loss_matches_jax():
    key = jax.random.PRNGKey(7)
    x1 = _x1()

    def jvel(x, t):
        return jnp.sin(x) * t[:, None, None, None]

    want = float(jcfm.cfm_loss(jvel, key, jnp.asarray(x1)))
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.uniform(kt, (4,), jnp.float32))
    x0 = np.array(jax.random.normal(kn, x1.shape, jnp.float32))
    got = pcfm.cfm_loss(lambda x, tt: torch.sin(x) * tt[:, None, None, None],
                        torch.from_numpy(x1), torch.from_numpy(t),
                        torch.from_numpy(x0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cfm_loss_draws_from_its_generator():
    x1 = torch.from_numpy(_x1())

    def vel(x, t):
        return x * t[:, None, None, None]

    a = pcfm.cfm_loss(vel, x1, generator=torch.Generator().manual_seed(1))
    b = pcfm.cfm_loss(vel, x1, generator=torch.Generator().manual_seed(1))
    c = pcfm.cfm_loss(vel, x1, generator=torch.Generator().manual_seed(2))
    assert float(a) == float(b) != float(c)


# ---- one step: loss, gradients, Adam, EMA ----------------------------------

def test_fm_step_loss_and_gradients_match_jax():
    jnet, v = _jax_net(0)
    x1 = _x1()
    key = jax.random.PRNGKey(11)
    t, x0 = _keys_draws(key, 4)
    _, kn, kd = jax.random.split(key, 3)

    def loss_fn(params):       # _fm_substep's loss (train/steps.py:52-56)
        x_t, u = jcfm.interpolate(kn, jnp.asarray(x1), jnp.asarray(t))
        out = jnet.apply({"params": params}, x_t, jnp.asarray(t),
                         deterministic=False, rngs={"dropout": kd})
        return jnp.mean((out.astype(jnp.float32) - u.astype(jnp.float32))
                        ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = unet_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)}, **BRIDGE)

    state = create_fm_state(_port_net(v), "cpu", lr=1e-4)
    loss = make_fm_train_step()(state, torch.from_numpy(x1),
                                t=torch.from_numpy(t),
                                x0=torch.from_numpy(x0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = dict(state.model.named_parameters())
    assert set(grads) == set(want)
    for k, g in want.items():
        g = g.numpy()
        got = grads[k].grad.numpy()
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max() + 1e-6, k
    assert np.abs(want["encoder_blocks.0.norm1.weight"].numpy()).max() > 0


def test_adam_three_updates_match_optax():
    _, v = _jax_net(1)
    params = v["params"]
    state = create_fm_state(_port_net(v), "cpu", lr=1e-3)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def adam(g, opt_state, params):
        upd, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    rng = np.random.RandomState(2)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), params)
        params, opt_state = adam(g, opt_state, params)
        g_sd = unet_state_dict({"params": g}, **BRIDGE)
        for n, p in state.model.named_parameters():
            p.grad = g_sd[n].clone()
        state.optimizer.step()
    want = unet_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, params)}, **BRIDGE)
    got = _sd_np(state.model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_ema_update_matches_fm_substep():
    """One step at lr 0 (params unchanged) from an EMA unlike the params:
    ema = d·ema + (1−d)·params, on a copy."""
    jnet, v = _jax_net(2)
    d = 0.9
    jstate = jsteps.create_fm_state(jnet, jax.random.PRNGKey(0), (H, H, 1),
                                    lr=0.0, ema_decay=d)
    jstate = jstate.replace(params=v["params"])
    rng = np.random.RandomState(4)
    ema0 = jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 0.2).astype(np.float32),
        v["params"])
    jstate = jstate.replace(ema_params=ema0)
    key = jax.random.PRNGKey(13)
    x1 = _x1()
    jstate, _ = jax.jit(jsteps._fm_substep(jnet, d))(jstate, jnp.asarray(x1),
                                                    key)
    want = unet_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jstate.ema_params)}, **BRIDGE)

    state = create_fm_state(_port_net(v), "cpu", lr=0.0, ema_decay=d)
    params0 = _sd_np(state.model)
    for k, e in unet_state_dict({"params": ema0}, **BRIDGE).items():
        state.ema[k].copy_(e)
    t, x0 = _keys_draws(key, 4)
    make_fm_train_step(d)(state, torch.from_numpy(x1), t=torch.from_numpy(t),
                          x0=torch.from_numpy(x0))
    for k, w in want.items():
        assert state.ema[k].data_ptr() != \
            dict(state.model.named_parameters())[k].data_ptr()
        np.testing.assert_array_equal(_sd_np(state.model)[k], params0[k])
        np.testing.assert_allclose(state.ema[k].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_step_is_a_function_of_its_generator():
    """Same weights and generator seed: the same loss and weights (t, x_0
    and the dropout masks are drawn from the step's generator)."""
    _, v = _jax_net(3)
    out = []
    for _ in range(2):
        net = PUNet(**{**KW, "dropout": 0.1})
        net.load_state_dict(unet_state_dict(v, **BRIDGE))
        state = create_fm_state(net, "cpu", ema_decay=0.99)
        step = make_fm_train_step(0.99)
        torch.manual_seed(123 + len(out))     # must not matter
        losses = [float(step(state, torch.from_numpy(_x1()),
                             RNG(5).generator(0, i))) for i in range(2)]
        out.append((losses, _sd_np(state.model)))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k])
    with pytest.raises(ValueError, match="generator"):
        make_fm_train_step()(state, torch.from_numpy(_x1()))


def test_dropout_sits_after_norm2_before_conv2():
    """The JAX ResBlock drops out after GroupNorm_1+SiLU and before conv2
    (models/layers.py:281-284); so does the port's, in train mode only."""
    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        place_for_training,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import ResBlock

    block = place_for_training(ResBlock(8, 8, 16, dropout=0.5), "cpu")
    seen = {}
    block.norm2.register_forward_hook(
        lambda m, a, o: seen.__setitem__("norm2", o.detach()))
    block.conv2.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("conv2_in", a[0].detach()))
    torch.manual_seed(0)
    block(torch.randn(2, 8, 4, 4), torch.randn(2, 16))
    kept = seen["conv2_in"] != 0
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(seen["conv2_in"][kept],
                               2.0 * seen["norm2"][kept])
    block.eval()
    block(torch.randn(2, 8, 4, 4), torch.randn(2, 16))
    torch.testing.assert_close(seen["conv2_in"], seen["norm2"])


# ---- checkpoints -----------------------------------------------------------

def test_checkpoint_names():
    assert pck.checkpoint_path("flow", "y", "rotate90", None, "ema",
                               "best") == \
        os.path.join("checkpoints", "flow_y_rotate90_ema_best.pth")
    assert pck.ema_checkpoint_path("runs/flow_x_best.pth") == \
        "runs/flow_x_ema_best.pth"
    assert pck.ema_checkpoint_path("flow_svhn_best.pth") == \
        "flow_svhn_ema_best.pth"


def test_save_is_atomic(tmp_path):
    path = str(tmp_path / "a" / "m.pth")
    pck.save_checkpoint(path, {"w": torch.ones(3)})
    assert pck.checkpoint_exists(path)
    assert os.listdir(tmp_path / "a") == ["m.pth"]       # no temporary left
    assert torch.equal(pck.load_checkpoint(path)["w"], torch.ones(3))


def test_port_checkpoint_through_jax_importer(tmp_path):
    """A .pth the port's trainer wrote (full dict) and its EMA file (bare
    state dict) import with the JAX package's importer; the JAX forward
    equals the port's."""
    torch.manual_seed(0)
    net = PUNetMNIST(img_size=32)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.01 * torch.randn_like(p))   # out_conv off zero
    state = create_fm_state(net, "cpu", ema_decay=0.5)
    path = str(tmp_path / "flow_mnist32_best.pth")
    pck.save_train_checkpoint(path, state, 3, 0.5)
    pck.save_checkpoint(pck.ema_checkpoint_path(path), state.ema)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    for f, net in ((path, state.model),
                   (pck.ema_checkpoint_path(path), None)):
        sd = torch.load(f, weights_only=True)
        variables = import_state_dict(
            {k: v.numpy() for k, v in (sd.get("model_state_dict", sd)
                                       ).items()}, "unet_mnist")
        want = np.asarray(jax.jit(JUNetMNIST(img_size=32).apply)(
            variables, x, t))
        port = pck.load_params(f, PUNetMNIST(img_size=32)).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = torch.load(path, weights_only=True)
    assert set(full) == {"model_state_dict", "optimizer_state_dict", "epoch",
                         "best_loss"}
    assert full["epoch"] == 3 and full["best_loss"] == 0.5


# ---- the epoch driver: early stopping, preemption, resume ------------------

N_BATCHES = 4


def _data_iter_fn(epoch):
    rng = np.random.RandomState(100 + epoch)        # per-epoch seeded
    for _ in range(N_BATCHES):
        yield torch.from_numpy(rng.randn(8, 8, 8, 1).astype(np.float32))


def _fresh(ema=None):
    torch.manual_seed(0)
    net = PUNet(in_channels=1, img_size=8, model_channels=8,
                channel_mult=(1, 2), num_res_blocks=1)
    return create_fm_state(net, "cpu", lr=1e-3, ema_decay=ema), \
        make_fm_train_step(ema)


def _quiet(*_):
    pass


def test_early_stopper():
    s = EarlyStopper(patience=2)
    assert s.update(1.0) and s.best == 1.0 and not s.should_stop
    assert not s.update(1.0) and s.counter == 1 and not s.should_stop
    assert s.update(0.5) and s.counter == 0
    assert not s.update(0.7) and not s.update(0.6)
    assert s.should_stop and s.best == 0.5


def test_guard_restores_handlers_and_keeps_pending():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)         # a real SIGTERM
        assert g.preempted
    assert signal.getsignal(signal.SIGTERM) is before
    request_preemption()                  # before entry: honoured inside
    with PreemptionGuard() as outer:
        with PreemptionGuard() as inner:
            assert inner.preempted
        assert outer.preempted
    with PreemptionGuard() as g:
        assert not g.preempted


@pytest.mark.parametrize("ema", [None, 0.9])
def test_sigterm_resume_matches_uninterrupted(tmp_path, ema):
    ck = str(tmp_path / "preempt.pth")
    ref, step = _fresh(ema)
    ref, _, hist_ref = train_flow_matching_epochs(
        ref, step, _data_iter_fn, 3, RNG(7), log_fn=_quiet)

    state, step = _fresh(ema)
    count = {"n": 0}

    def sigterm_step(st, x1, gen):
        count["n"] += 1
        if count["n"] == N_BATCHES + 2:            # epoch 1, step 2
            os.kill(os.getpid(), signal.SIGTERM)
        return step(st, x1, gen)

    _, _, hist = train_flow_matching_epochs(
        state, sigterm_step, _data_iter_fn, 3, RNG(7), preempt_path=ck,
        log_fn=_quiet)
    assert hist[-1]["preempted"] and hist[-1]["preempted_at_step"] == 2
    assert finish_preemptible(hist, ck, log_fn=_quiet)
    saved = pck.load_checkpoint(ck)
    assert (saved["epoch"], saved["step"]) == (1, 2)

    resumed, step = _fresh(ema)
    resumed, resume = restore_preempt(ck, resumed)
    assert (resume["start_epoch"], resume["start_step"]) == (1, 2)
    resumed, _, hist_r = train_flow_matching_epochs(
        resumed, step, _data_iter_fn, 3, RNG(7), log_fn=_quiet, **resume)
    for k, w in _sd_np(ref.model).items():
        np.testing.assert_array_equal(_sd_np(resumed.model)[k], w)
    if ema is not None:
        for k, w in ref.ema.items():
            assert torch.equal(resumed.ema[k], w)
    ref_opt = ref.optimizer.state_dict()["state"]
    for i, s in resumed.optimizer.state_dict()["state"].items():
        assert torch.equal(s["exp_avg_sq"], ref_opt[i]["exp_avg_sq"])
    ref_loss = {h["epoch"]: h["loss"] for h in hist_ref}
    res_loss = {h["epoch"]: h["loss"] for h in hist_r}
    assert set(res_loss) == {2, 3}
    for e in res_loss:                  # the restart epoch's carried sums
        assert res_loss[e] == ref_loss[e]
    assert not finish_preemptible(hist_r, ck, log_fn=_quiet)
    assert not os.path.exists(ck)                  # consumed


def test_resume_keeps_early_stop_state(tmp_path):
    ck = str(tmp_path / "preempt.pth")
    best = str(tmp_path / "flow_x_best.pth")
    state, step = _fresh(0.9)
    count = {"n": 0}

    def counting_step(st, x1, gen):
        count["n"] += 1
        if count["n"] == 2 * N_BATCHES + 1:         # epoch 2, step 1
            request_preemption()
        return step(st, x1, gen)

    _, _, hist = train_flow_matching_epochs(
        state, counting_step, _data_iter_fn, 4, RNG(7), best_path=best,
        preempt_path=ck, log_fn=_quiet)
    assert hist[-1]["preempted"]
    saved = pck.load_checkpoint(ck)
    completed = [h["loss"] for h in hist if "loss" in h]
    assert saved["best_loss"] == min(completed)
    assert saved["patience_counter"] == (
        0 if completed[-1] == min(completed) else 1)
    assert os.path.exists(best) and os.path.exists(
        pck.ema_checkpoint_path(best))
    fresh, _ = _fresh(0.9)
    _, resume = restore_preempt(ck, fresh)
    assert resume["start_best"] == min(completed)
    assert resume["start_patience_counter"] == saved["patience_counter"]
    assert resume["start_partial_count"] == 1


# ---- data ------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    """One synthetic-digit root for each framework (their caches apart)."""
    os.environ["RGMF_SYNTH_N"] = "300"
    yield [str(tmp_path_factory.mktemp(n)) for n in ("jax", "port")]
    os.environ.pop("RGMF_SYNTH_N")


def _same_batches(jl, pl, keys):
    for e in (0, 1):
        jb, pb = list(jl.epoch(e)), list(pl.epoch(e))
        assert len(jb) == len(pb) == len(jl) == len(pl) > 0
        for a, b in zip(jb, pb):
            for k in keys:
                got = b[k].numpy() if isinstance(b[k], torch.Tensor) \
                    else b[k]
                np.testing.assert_array_equal(got, np.asarray(a[k]),
                                              err_msg=k)


@pytest.mark.parametrize("transform", [None, "rotate90"])
def test_exp1_flow_loader_matches_jax(data_roots, transform):
    jl = jmd.get_flow_dataloader(transform, 64, True, data_roots[0], seed=3)
    pl = pmd.get_flow_dataloader(transform, 64, True, data_roots[1], seed=3,
                                 device="cpu")
    _same_batches(jl, pl, ("x", "y", "label"))
    np.testing.assert_array_equal(
        pmd.get_flow_dataset(transform, True, data_roots[1],
                             device="cpu").numpy(),
        np.asarray(jmd.get_flow_dataset(transform, True, data_roots[0])))


@pytest.mark.parametrize("which", ["mnist32", "svhn"])
def test_exp2_flow_loaders_match_jax(data_roots, which):
    make_j = {"mnist32": jms.get_mnist32_flow_dataloader,
              "svhn": jms.get_svhn_flow_dataloader}[which]
    make_p = {"mnist32": pms.get_mnist32_flow_dataloader,
              "svhn": pms.get_svhn_flow_dataloader}[which]
    jl = make_j(64, True, data_roots[0], seed=4)
    keys = ("x", "label") + (("y",) if which == "svhn" else ())
    for device in (None, "cpu"):       # numpy batches, or gathered tensors
        _same_batches(jl, make_p(64, True, data_roots[1], seed=4,
                                 device=device), keys)


# ---- the train CLIs --------------------------------------------------------

def _cli_env(tmp_path, monkeypatch, n=16):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", str(n))
    return ["--device", "cpu", "--data_root", str(tmp_path / "data")]


def test_train_cli_mnist32_resume_matches_uninterrupted(tmp_path,
                                                        monkeypatch):
    """Two epochs in one run against one epoch, then --resume from the
    epoch-1 full dict for the second: the same weights bit for bit."""
    base = _cli_env(tmp_path, monkeypatch) + ["--batch_size", "4",
                                              "--save_every", "1"]
    ref, _, hist = train_flow_mnist32.main(base + ["--epochs", "2"])
    assert [h["epoch"] for h in hist] == [1, 2]
    os.remove("checkpoints/flow_mnist32_epoch2.pth")
    train_flow_mnist32.main(base + ["--epochs", "1"])
    res, _, hist_r = train_flow_mnist32.main(
        base + ["--epochs", "2", "--resume",
                "checkpoints/flow_mnist32_epoch1.pth"])
    assert [h["epoch"] for h in hist_r] == [2]
    for k, w in _sd_np(ref.model).items():
        np.testing.assert_array_equal(_sd_np(res.model)[k], w)


@pytest.mark.parametrize("cli,argv,files", [
    (train_flow_mnist32, [], ["flow_mnist32_best.pth",
                              "flow_mnist32_ema_best.pth",
                              "flow_mnist32_epoch1.pth"]),
    (train_flow_svhn, [], ["flow_svhn_best.pth", "flow_svhn_ema_best.pth",
                           "flow_svhn_epoch1.pth"]),
    (train_flow, ["--modality", "y"], ["flow_y_rotate90_best.pth",
                                       "flow_y_rotate90_ema_best.pth",
                                       "flow_y_rotate90_epoch1.pth"]),
], ids=["mnist32", "svhn", "exp1_y"])
def test_train_clis_run_on_cpu(tmp_path, monkeypatch, cli, argv, files):
    base = _cli_env(tmp_path, monkeypatch, n=8)
    state, best, hist = cli.main(base + argv + [
        "--epochs", "1", "--batch_size", "4", "--ema_decay", "0.999",
        "--save_every", "1", "--preempt_path", "ck/preempt.pth"])
    assert np.isfinite(best) and hist[-1]["epoch"] == 1
    assert sorted(os.listdir("checkpoints")) == files
    assert not os.path.exists("ck/preempt.pth")
    assert state.model.training
    assert all(p.requires_grad for p in state.model.parameters())


MP = ["--coordinator_address", "127.0.0.1:1", "--num_processes", "2",
      "--process_id", "0"]


@pytest.mark.parametrize("argv,exc,match", [
    (["--fused_steps", "2"], None, None),           # runs: 2 steps a macro
    (["--fast_rng"], SystemExit, "no meaning in torch"),
    # a coordinator alone, or a process count alone, is one process (JAX)
    (["--coordinator_address", "h:1"], None, None),
    (["--process_id", "0"], None, None),
    (["--num_processes", "2"], None, None),
    (["--fused_steps", "2"] + MP, SystemExit, "single-process only"),
])
def test_train_cli_refusals(tmp_path, monkeypatch, argv, exc, match):
    """What the runtime flags do: the refusals, and the single-process
    runs of the flags that do not ask for several processes."""
    base = _cli_env(tmp_path, monkeypatch, n=8)
    argv = base + ["--modality", "x", "--epochs", "1", "--batch_size",
                   "4"] + argv
    if exc is not None:
        with pytest.raises(exc, match=match):
            train_flow.main(argv)
        return
    _, best, hist = train_flow.main(argv)
    assert np.isfinite(best) and hist[-1]["epoch"] == 1
    assert os.path.exists("checkpoints/flow_x_best.pth")


def test_derive_seed_is_position_addressed():
    assert derive_seed(1, 0, 3) == derive_seed(1, 0, 3)
    assert len({derive_seed(1, e, s) for e in range(3)
                for s in range(3)}) == 9
    a = RNG(4).generator(2, 5)
    b = RNG(4).generator(2, 5)
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))
