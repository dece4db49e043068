"""Evaluation-classifier training and the Inception-FID pipeline of the
PyTorch port against the JAX package, on the CPU.

Dropout masks cannot cross frameworks: the JAX classifier step always
draws them (`deterministic=False`), so the test monkeypatches flax's
`Dropout` module to the identity while the JAX step is traced, and the
port's `nn.Dropout` gets p = 0. The JAX step is the package's own
`make_classifier_train_step`; its gradient is taken with the same
`model.apply(..., train=True, mutable=['batch_stats'])` and
`optax.softmax_cross_entropy_with_integer_labels` composition through
`jax.grad`. Tolerances, each with its reason:

* one step of MNISTClassifier and SVHNClassifier (B = 4): loss rtol 1e-5
  and the accuracy equal; every gradient max |Δ| <= 1e-4·max|g| + 1e-6
  (float32 convolutions and sums in two frameworks); SVHN's BatchNorm
  running_mean / running_var against flax's batch_stats 1e-5;
* a port-written classifier .pth (BatchNorm buffers included) through the
  JAX importer: forward to 1e-5;
* the classifier loader on a device: equal to JAX's batch for batch;
* `compute_inception_fid` against the JAX function on a tiny TorchScript
  stand-in written to a temporary file: rtol 1e-6 (the same torch ops on
  the same CPU).
"""
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.data import mnist_dataset as jmd
from ratio_guided_multimodal_fm_tpu.eval import fid as jfid
from ratio_guided_multimodal_fm_tpu.interop.torch_import import (
    import_state_dict,
)
from ratio_guided_multimodal_fm_tpu.train import steps as jsteps
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    evaluate_mnist_svhn,
    train_classifier,
    train_classifiers_mnist_svhn,
    train_ratio_mnist_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_dataset as pmd
from ratio_guided_multimodal_fm_tpu_torch.eval import fid as pfid
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.train import checkpoint as pck
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_classifier_state,
    make_classifier_train_step,
)

torch.set_num_threads(2)

B = 4
CLASSIFIERS = {
    # bridge: (JAX module, port factory, input shape, dropout, BatchNorm)
    "classifier_mnist": (jm.MNISTClassifier, pm.MNISTClassifier,
                         (28, 28, 1), 0.25, False),
    "classifier_mnist32": (jm.MNISTClassifier32, pm.MNISTClassifier32,
                           (32, 32, 1), 0.25, False),
    "classifier_svhn": (jm.SVHNClassifier, pm.SVHNClassifier, (32, 32, 3),
                        0.3, True),
}


class _NoDropout(fnn.Module):
    """flax's Dropout made the identity (same constructor arguments)."""
    rate: float
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jax_classifier(kind, seed=0):
    jcls, _, shape, _, bn = CLASSIFIERS[kind]
    v = jax.tree_util.tree_map(np.asarray, dict(jcls().init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + shape))))
    rng = np.random.RandomState(seed + 1)
    if bn:                              # non-trivial BatchNorm state
        for name, st in v["batch_stats"].items():
            st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(
                np.float32)
            p = v["params"][name]
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(
                np.float32)
            p["bias"] = (rng.randn(*p["bias"].shape) * 0.1).astype(
                np.float32)
    return v


def _port(kind, v, dropout=True):
    net = CLASSIFIERS[kind][1]()
    net.load_state_dict(state_dict_from_jax(v, kind), strict=True)
    if not dropout:
        net.dropout.p = 0.0
    return net


# ---- the model ------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(CLASSIFIERS))
def test_dropout_follows_fc1_relu_in_train_mode_only(kind):
    """Dropout at JAX's rate after fc1's ReLU, before fc2; none in eval mode
    or in the FID features; no state-dict key of its own."""
    v = _jax_classifier(kind)
    net = _port(kind, v)
    assert net.dropout.p == CLASSIFIERS[kind][3]
    assert set(net.state_dict()) == set(state_dict_from_jax(v, kind))
    x = torch.from_numpy(_np(8, *CLASSIFIERS[kind][2], seed=1))
    seen = {}
    net.dropout.register_forward_hook(lambda m, a, o: seen.update(
        drop_in=a[0].detach(), drop_out=o.detach()))
    net.fc2.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("fc2_in", a[0].detach()))
    p = CLASSIFIERS[kind][3]
    net.train()
    torch.manual_seed(0)
    net(x)
    assert torch.equal(seen["fc2_in"], seen["drop_out"])
    kept = seen["drop_out"] != 0
    assert ((seen["drop_in"] != 0) & ~kept).any()       # some dropped
    torch.testing.assert_close(seen["drop_out"][kept],
                               seen["drop_in"][kept] / (1 - p))
    net.eval()
    with torch.no_grad():
        feats = net.features(x)
        net(x)
    torch.testing.assert_close(seen["fc2_in"], feats, rtol=0, atol=0)
    torch.testing.assert_close(seen["drop_in"], feats, rtol=0, atol=0)


# ---- one step -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["classifier_mnist", "classifier_svhn"])
def test_classifier_step_matches_jax(monkeypatch, kind):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    jcls, _, shape, _, bn = CLASSIFIERS[kind]
    jnet = jcls()
    v = _jax_classifier(kind, seed=3)
    x = _np(B, *shape, seed=4)
    labels = np.array([3, 1, 3, 7], np.int32)
    key = jax.random.PRNGKey(5)

    def loss_fn(params):   # make_classifier_train_step's loss (:247-262)
        variables = {"params": params}
        if bn:
            variables["batch_stats"] = v["batch_stats"]
            logits, _ = jnet.apply(variables, x, train=True,
                                   deterministic=False,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": key})
        else:
            logits = jnet.apply(variables, x, deterministic=False,
                                rngs={"dropout": key})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), labels).mean()

    jgrads = jax.jit(jax.grad(loss_fn))(v["params"])
    jstate = jsteps.create_classifier_state(jnet, jax.random.PRNGKey(0),
                                            shape).replace(
        params=v["params"], batch_stats=v.get("batch_stats"))
    jstate, (jloss, jacc) = jsteps.make_classifier_train_step(
        jnet, has_batch_stats=bn, donate=False)(jstate, x, labels, key)

    state = create_classifier_state(_port(kind, v, dropout=False), "cpu")
    assert state.clip_norm is None and state.ema is None
    loss, acc = make_classifier_train_step()(state, torch.from_numpy(x),
                                             labels)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    gv = {"params": jax.tree_util.tree_map(np.asarray, jgrads)}
    if bn:
        gv["batch_stats"] = v["batch_stats"]
    want = state_dict_from_jax(gv, kind)
    for k, p in state.model.named_parameters():
        g = want[k].numpy()
        assert np.abs(p.grad.numpy() - g).max() <= \
            1e-4 * np.abs(g).max() + 1e-6, k
    if bn:
        stats = state_dict_from_jax({"params": v["params"], "batch_stats":
                                     jax.tree_util.tree_map(
                                         np.asarray, jstate.batch_stats)},
                                    kind)
        for k, t in state.model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["classifier_mnist32", "classifier_svhn"])
def test_port_classifier_checkpoint_through_jax_importer(tmp_path, kind):
    """Two train steps (the BatchNorm statistics move), a bare state dict
    written as the train CLIs write it, then the JAX importer's variables
    and the port's strict load give the same eval logits."""
    v = _jax_classifier(kind, seed=6)
    state = create_classifier_state(_port(kind, v), "cpu", lr=1e-2)
    step = make_classifier_train_step()
    x = _np(8, *CLASSIFIERS[kind][2], seed=7)
    for i in range(2):
        step(state, torch.from_numpy(x), np.arange(8) % 10,
             torch.Generator().manual_seed(i))
    path = str(tmp_path / "c.pth")
    pck.save_checkpoint(path, state.model.state_dict())
    sd = torch.load(path, weights_only=True)
    variables = import_state_dict({k: t.numpy() for k, t in sd.items()},
                                  kind)
    want = np.asarray(CLASSIFIERS[kind][0]().apply(variables, x))
    port = pck.load_params(path, CLASSIFIERS[kind][1]()).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- data -----------------------------------------------------------------

def test_classifier_loader_on_a_device_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("RGMF_SYNTH_N", "300")
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    for train in (True, False):
        jl = jmd.get_classifier_dataloader(64, train, roots[0], seed=2)
        pl = pmd.get_classifier_dataloader(64, train, roots[1], seed=2,
                                           device="cpu")
        for e in (0, 1):
            jb, pb = list(jl.epoch(e)), list(pl.epoch(e))
            assert len(jb) == len(pb) == len(pl) > 0
            for a, b in zip(jb, pb):
                assert isinstance(b["x"], torch.Tensor)
                np.testing.assert_array_equal(b["x"].numpy(), a["x"])
                np.testing.assert_array_equal(b["label"], a["label"])


# ---- Inception-FID --------------------------------------------------------

class _StandIn(torch.nn.Module):
    """A tiny network in Inception's place: 3-channel NCHW images to 6
    features."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 6, 7, stride=6)

    def forward(self, x):
        return torch.tanh(self.conv(x)).mean(dim=(2, 3))


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("inception") / "stand_in.pt")
    torch.jit.script(_StandIn()).save(path)
    return path


@pytest.mark.parametrize("channels", [1, 3])
def test_inception_fid_matches_jax(stand_in, channels):
    real = np.tanh(_np(40, 16, 16, channels, seed=8))
    gen = np.tanh(_np(40, 16, 16, channels, seed=9) * 0.7 + 0.2)
    want = jfid.compute_inception_fid(real, gen, stand_in, batch_size=16)
    got = pfid.compute_inception_fid(real, gen, stand_in, batch_size=16,
                                     device="cpu")
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    same = pfid.compute_inception_fid(torch.from_numpy(real), real,
                                      stand_in, device="cpu")
    assert abs(same) < 1e-6


def test_inception_fid_without_a_file_raises(tmp_path):
    missing = str(tmp_path / "none.pt")
    x = np.zeros((4, 8, 8, 1), np.float32)
    with pytest.raises(FileNotFoundError, match="Inception weights"):
        jfid.compute_inception_fid(x, x, missing)
    with pytest.raises(FileNotFoundError, match="Inception weights"):
        pfid.compute_inception_fid(x, x, missing, device="cpu")


# ---- the train CLIs -------------------------------------------------------

def _cli_env(tmp_path, monkeypatch, n=64):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", str(n))
    return ["--device", "cpu", "--data_root", str(tmp_path / "data")]


def test_classifier_cli_on_cpu(tmp_path, monkeypatch):
    base = _cli_env(tmp_path, monkeypatch)
    state, hist = train_classifier.main(base + ["--epochs", "2",
                                                "--batch_size", "16"])
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and 0 <= h["test_acc"] <= 1
               for h in hist)
    assert os.listdir("checkpoints") == ["mnist_classifier.pth"]
    net = pck.load_params("checkpoints/mnist_classifier.pth",
                          pm.MNISTClassifier())
    for k, t in state.model.state_dict().items():
        assert torch.equal(net.state_dict()[k], t), k


def test_trained_checkpoints_feed_the_evaluate_cli(tmp_path, monkeypatch,
                                                   stand_in):
    """train_classifiers_mnist_svhn and train_ratio_mnist_svhn (with an
    EMA) write the files evaluate_mnist_svhn reads; it runs on them with
    --ratio_ema, --fid and --inception_weights (the stand-in)."""
    base = _cli_env(tmp_path, monkeypatch)
    out = train_classifiers_mnist_svhn.main(base + ["--epochs", "1",
                                                    "--batch_size", "16"])
    assert sorted(out) == ["checkpoints/mnist32_classifier.pth",
                           "checkpoints/svhn_classifier.pth"]
    svhn_sd = pck.load_checkpoint("checkpoints/svhn_classifier.pth")
    assert int(svhn_sd["bn1.num_batches_tracked"]) == 4   # 64 / 16 steps
    train_ratio_mnist_svhn.main(base + ["--epochs", "1", "--batch_size",
                                        "32", "--ema_decay", "0.9"])
    torch.manual_seed(0)
    for net, fname in ((pm.FlowMatchingUNetMNIST(img_size=32),
                        "flow_mnist32_best.pth"),
                       (pm.FlowMatchingUNetSVHN(), "flow_svhn_best.pth")):
        torch.save(net.state_dict(), os.path.join("checkpoints", fname))
    results = evaluate_mnist_svhn.main(base + [
        "--num_samples", "8", "--num_steps", "2", "--mc_batch_size", "3",
        "--guidance_methods", "none", "mc_feng", "--guidance_strengths",
        "0.5", "--ratio_ema", "--fid", "--inception_weights", stand_in,
        "--eval_chunks", "1"])
    assert [r["method"] for r in results] == ["mc_feng"]
    r = results[0]
    assert np.isfinite(r["classifier_fid_mnist"])
    assert np.isfinite(r["inception_fid_mnist"])
    saved = json.loads(open(os.path.join(
        "outputs", "mnist_svhn", "evaluation_results.json")).read())
    assert saved == results


@pytest.mark.parametrize("argv,exc,match", [
    # a coordinator alone, a process count alone or a process id alone is
    # one process, as in JAX: the CLI trains
    (["--coordinator_address", "h:1"], None, None),
    (["--num_processes", "2"], None, None),
    (["--process_id", "0"], None, None),
])
@pytest.mark.parametrize("cli", [train_classifier,
                                 train_classifiers_mnist_svhn],
                         ids=["mnist", "mnist_svhn"])
def test_classifier_cli_refusals(tmp_path, monkeypatch, cli, argv, exc,
                                 match):
    base = _cli_env(tmp_path, monkeypatch)
    cli.main(base + ["--epochs", "1", "--batch_size", "32"] + argv)
    assert any(f.endswith("classifier.pth")
               for f in os.listdir("checkpoints"))
