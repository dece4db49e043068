"""Ratio-net training of the PyTorch port against the JAX package, on the
CPU (where the GroupNorm wrapper and its backward run their plain
versions).

Random streams cannot cross frameworks, so the batches come from numpy and
dropout is off on both sides: the JAX package's `_ratio_substep` always
draws dropout masks (`deterministic=False`), so the test monkeypatches
flax's `Dropout` module to the identity while the JAX step is traced; the
port's `nn.Dropout` modules get p = 0. The JAX step itself (clip, Adam,
EMA, batch_stats) is the package's own `_ratio_substep`; its gradient is
taken with the same `model.apply(..., train=True, mutable=
['batch_stats'])` and `flow/losses.py` composition, through
`jax.grad`. Tolerances, each with its reason:

* the losses and their metrics: rtol 1e-6 (the same float32 operations);
* one step of each ratio family (FlexibleRatioEstimator(feature_dim=32,
  hidden_dim=64) at 28 px, the full-width RatioEstimatorMNISTSVHN; B = 4):
  loss and metrics rtol 1e-5, every post-clip gradient max |Δ| <=
  1e-4·max|g| + 1e-6 (float32 convolutions and sums in two frameworks),
  BatchNorm running_mean / running_var against flax's batch_stats 1e-5;
* clip_by_global_norm against optax's, clip active and inactive: rtol
  1e-6;
* BatchNorm's train forward against flax's BatchNorm: 1e-5; its eval
  forward: bit for bit the formula it had before it learned train mode;
* a port-written .pth (BatchNorm buffers, the EMA sibling) through the
  JAX importer: forward to 1e-5;
* the loaders: equal batch for batch; a SIGTERM resume: bit for bit.
"""
import os
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.data import mnist_dataset as jmd
from ratio_guided_multimodal_fm_tpu.data import mnist_svhn as jms
from ratio_guided_multimodal_fm_tpu.data import pipeline as jpipe
from ratio_guided_multimodal_fm_tpu.flow import losses as jlosses
from ratio_guided_multimodal_fm_tpu.interop.torch_import import (
    import_state_dict,
)
from ratio_guided_multimodal_fm_tpu.train import steps as jsteps
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli import (
    train_ratio,
    train_ratio_mnist_svhn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_dataset as pmd
from ratio_guided_multimodal_fm_tpu_torch.data import mnist_svhn as pms
from ratio_guided_multimodal_fm_tpu_torch.data import pipeline as ppipe
from ratio_guided_multimodal_fm_tpu_torch.flow import losses as plosses
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.models.ratio import BatchNorm2d
from ratio_guided_multimodal_fm_tpu_torch.train import checkpoint as pck
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    finish_preemptible,
    restore_preempt,
    train_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    clip_by_global_norm,
    create_ratio_state,
    make_ratio_eval_step,
    make_ratio_train_step,
)

torch.set_num_threads(2)

B = 4
IS_REAL = np.array([1, 0, 1, 0], np.float32)


class _NoDropout(fnn.Module):
    """flax's Dropout made the identity (same constructor arguments)."""
    rate: float
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _randomise_norms(tree, rng):
    """Non-trivial norm params: GroupNorm/LayerNorm/BatchNorm scale and
    bias away from (1, 0)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if k.startswith(("gn", "ln", "bn")):
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                    np.float32)
                v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(
                    np.float32)
            else:
                _randomise_norms(v, rng)


def _randomise_stats(tree, rng):
    for k, v in tree.items():
        if "mean" in v:
            v["mean"] = (rng.randn(*v["mean"].shape) * 0.1).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(
                np.float32)
        else:
            _randomise_stats(v, rng)


FAMILIES = {
    # kind: (JAX module, port factory, bridge, x shape, y shape, BatchNorm)
    "flex": (lambda lt: jm.FlexibleRatioEstimator(
        feature_dim=32, hidden_dim=64, loss_type=lt),
        lambda lt: pm.FlexibleRatioEstimator(feature_dim=32, hidden_dim=64,
                                             loss_type=lt),
        "ratio_mnist", (28, 28, 1), (28, 28, 1), False),
    "mnist_svhn": (lambda lt: jm.RatioEstimatorMNISTSVHN(loss_type=lt),
                   lambda lt: pm.RatioEstimatorMNISTSVHN(loss_type=lt),
                   "ratio_mnist_svhn", (32, 32, 1), (32, 32, 3), True),
}


def _family(kind, loss_type="disc", seed=0):
    """(JAX net, its numpy variables, port net from the same variables with
    dropout off, x, y)."""
    jmod, pmod, bridge, xs, ys, bn = FAMILIES[kind]
    jnet = jmod(loss_type)
    v = jax.tree_util.tree_map(np.asarray, dict(jnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + xs),
        jnp.zeros((1,) + ys))))
    rng = np.random.RandomState(seed + 1)
    _randomise_norms(v["params"], rng)
    if bn:
        _randomise_stats(v["batch_stats"], rng)
    net = pmod(loss_type)
    net.load_state_dict(state_dict_from_jax(v, bridge), strict=True)
    for m in net.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    x = _np(B, *xs, seed=seed + 2)
    y = _np(B, *ys, seed=seed + 3)
    return jnet, v, net, x, y


def _to_port(tree, kind, stats=None):
    """A JAX params-shaped tree (e.g. gradients) in the port's key layout
    (BatchNorm families need a batch_stats tree beside it)."""
    v = {"params": tree}
    if FAMILIES[kind][5]:
        v["batch_stats"] = stats
    return state_dict_from_jax(v, FAMILIES[kind][2])


# ---- losses ---------------------------------------------------------------

@pytest.mark.parametrize("loss_type", ["disc", "rulsif"])
@pytest.mark.parametrize("mask", ["mixed", "all_real", "all_fake"])
def test_losses_match_jax(loss_type, mask):
    s = _np(16, seed=4, scale=2.0)
    m = {"mixed": (np.arange(16) % 3 == 0),
         "all_real": np.ones(16, bool),
         "all_fake": np.zeros(16, bool)}[mask].astype(np.float32)
    kw = dict(alpha=0.3, lambda_penalty=0.2)
    jl, jmet = jlosses.get_ratio_loss(loss_type, **kw)(jnp.asarray(s),
                                                       jnp.asarray(m))
    pl, pmet = plosses.get_ratio_loss(loss_type, **kw)(torch.from_numpy(s),
                                                       torch.from_numpy(m))
    assert set(pmet) == set(jmet)
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for k in jmet:
        assert np.isfinite(float(pmet[k])), k
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    pl2, _ = plosses.masked_ratio_loss(torch.from_numpy(s),
                                       torch.from_numpy(m), loss_type, **kw)
    assert float(pl2) == float(pl)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss type"):
        plosses.get_ratio_loss("bce")


# ---- clip, BatchNorm ------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.05, 100.0], ids=["active",
                                                        "inactive"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(5)
    gs = [(rng.randn(*s) * 0.1).astype(np.float32)
          for s in ((3, 4), (7,), (2, 2, 5))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        [jnp.asarray(g) for g in gs])), rtol=1e-6)
    assert (float(norm) >= max_norm) == (max_norm == 0.05)
    for a, b, g in zip(got, want, gs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        if max_norm == 100.0:
            np.testing.assert_array_equal(a.numpy(), g)


def test_batchnorm_train_forward_matches_flax():
    x = _np(6, 5, 5, 8, seed=6, scale=2.0) + 0.7       # NHWC
    rng = np.random.RandomState(7)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    mean0 = (rng.randn(8) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    jv = {"params": {"scale": scale, "bias": bias},
          "batch_stats": {"mean": mean0, "var": var0}}
    jy, mut = jbn.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    # torch's own train-mode BatchNorm feeds the unbiased variance
    ref = torch.nn.BatchNorm2d(8, momentum=0.1)
    ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=1e-5)


def test_batchnorm_eval_forward_unchanged_bit_for_bit():
    """Eval mode keeps the formula the port had before train mode: float32
    (x − running_mean)·(rsqrt(running_var + eps)·weight) + bias."""
    torch.manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm2d(16, dtype=dtype)
        with torch.no_grad():
            for t in (bn.weight, bn.bias, bn.running_mean):
                t.copy_(torch.randn(16))
            bn.running_var.copy_(torch.rand(16) + 0.5)
        bn.eval()
        x = torch.randn(3, 16, 4, 4).to(dtype)
        before = {k: v.clone() for k, v in bn.state_dict().items()}
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        want = ((x.to(torch.float32) - bn.running_mean[None, :, None, None])
                * mul[None, :, None, None]
                + bn.bias[None, :, None, None]).to(dtype)
        assert torch.equal(bn(x), want)
        for k, v in bn.state_dict().items():
            assert torch.equal(v, before[k]), k


# ---- one step -------------------------------------------------------------

STEP_CASES = [("flex", "disc"), ("flex", "rulsif"), ("mnist_svhn", "disc")]


@pytest.mark.parametrize("kind,loss_type", STEP_CASES,
                         ids=[f"{k}-{lt}" for k, lt in STEP_CASES])
def test_ratio_step_matches_jax(no_flax_dropout, kind, loss_type):
    jnet, v, net, x, y = _family(kind, loss_type, seed=10)
    bn = FAMILIES[kind][5]
    kw = dict(alpha=0.2, lambda_penalty=0.1)
    key = jax.random.PRNGKey(3)
    loss_inner = jlosses.get_ratio_loss(loss_type, **kw)

    def loss_fn(params):           # _ratio_substep's loss (steps.py:134-151)
        variables = {"params": params}
        if bn:
            variables["batch_stats"] = v["batch_stats"]
            scores, _ = jnet.apply(variables, x, y, train=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": key},
                                   deterministic=False)
        else:
            scores = jnet.apply(variables, x, y, rngs={"dropout": key},
                                deterministic=False)
        return loss_inner(scores, IS_REAL)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(v["params"])
    clipped, _ = optax.clip_by_global_norm(1.0).update(jgrads,
                                                       optax.EmptyState())
    jstate = jsteps.create_ratio_state(jnet, jax.random.PRNGKey(0),
                                       FAMILIES[kind][3], FAMILIES[kind][4],
                                       has_batch_stats=bn)
    jstate = jstate.replace(params=v["params"],
                            batch_stats=v.get("batch_stats"))
    jstate, jmet = jax.jit(jsteps._ratio_substep(
        jnet, loss_type, bn, None, **kw))(jstate, x, y, IS_REAL, key)

    state = create_ratio_state(net, "cpu", lr=1e-4, clip_norm=1.0)
    met = make_ratio_train_step(loss_type, **kw)(
        state, torch.from_numpy(x), torch.from_numpy(y), IS_REAL)
    assert set(met) == set(jmet)
    for k in jmet:
        assert met[k].dtype == torch.float32 and not met[k].requires_grad
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = _to_port(jax.tree_util.tree_map(np.asarray, clipped), kind,
                    v.get("batch_stats"))
    grads = dict(state.model.named_parameters())
    assert set(grads) <= set(want)
    for k, p in grads.items():
        g = want[k].numpy()
        assert np.abs(p.grad.numpy() - g).max() <= \
            1e-4 * np.abs(g).max() + 1e-6, k
    if bn:
        stats = _to_port(jax.tree_util.tree_map(np.asarray, v["params"]),
                         kind, jax.tree_util.tree_map(np.asarray,
                                                      jstate.batch_stats))
        sd = state.model.state_dict()
        for k in sd:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
            if k.endswith("num_batches_tracked"):
                assert int(sd[k]) == 1


def test_ratio_eval_step_matches_jax():
    jnet, v, net, x, y = _family("mnist_svhn", seed=20)
    jmet = jsteps.make_ratio_eval_step(jnet, "disc", has_batch_stats=True)(
        jsteps.create_ratio_state(jnet, jax.random.PRNGKey(0), (32, 32, 1),
                                  (32, 32, 3), has_batch_stats=True).replace(
            params=v["params"], batch_stats=v["batch_stats"]),
        x, y, IS_REAL)
    state = create_ratio_state(net, "cpu")
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    met = make_ratio_eval_step("disc")(state, torch.from_numpy(x),
                                       torch.from_numpy(y), IS_REAL)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert state.model.training
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_step_is_a_function_of_its_generator():
    """Same weights and generator: the same metrics and weights (the
    dropout masks are drawn from the step's generator)."""
    _, v, _, x, y = _family("flex", seed=30)
    out = []
    for i in range(2):
        net = pm.FlexibleRatioEstimator(feature_dim=32, hidden_dim=64)
        net.load_state_dict(state_dict_from_jax(v, "ratio_mnist"))
        state = create_ratio_state(net, "cpu", ema_decay=0.9)
        step = make_ratio_train_step("disc", ema_decay=0.9)
        torch.manual_seed(100 + i)                    # must not matter
        mets = [step(state, torch.from_numpy(x), torch.from_numpy(y),
                     IS_REAL, RNG(5).generator(0, j)) for j in range(2)]
        out.append(([float(m["loss"]) for m in mets],
                    {k: t.clone() for k, t in state.model.state_dict().items()},
                    {k: t.clone() for k, t in state.ema.items()}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k]), k


# ---- checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["flex", "mnist_svhn"])
def test_port_checkpoint_through_jax_importer(tmp_path, kind):
    """One port step (BatchNorm statistics move), then the best weights and
    the EMA sibling (the EMA params with the current running statistics,
    train/checkpoint.py:ema_state_dict) strict-load in the port and import
    with the JAX package's importer; the two eval forwards agree."""
    jnet, v, net, x, y = _family(kind, seed=40)
    state = create_ratio_state(net, "cpu", lr=1e-2, ema_decay=0.5)
    make_ratio_train_step("disc", ema_decay=0.5)(
        state, torch.from_numpy(x), torch.from_numpy(y), IS_REAL)
    best = str(tmp_path / "ratio_disc_x_best.pth")
    pck.save_checkpoint(best, state.model.state_dict())
    pck.save_checkpoint(pck.ema_checkpoint_path(best),
                        pck.ema_state_dict(state))
    ema_sd = pck.load_checkpoint(pck.ema_checkpoint_path(best))
    assert list(ema_sd) == list(state.model.state_dict())
    for k, t in state.model.state_dict().items():
        if k in state.ema:
            assert torch.equal(ema_sd[k], state.ema[k])
        else:
            assert torch.equal(ema_sd[k], t), k     # buffers: the current
    importer = "ratio" if kind == "flex" else "ratio_mnist_svhn"
    for f in (best, pck.ema_checkpoint_path(best)):
        sd = torch.load(f, weights_only=True)
        variables = import_state_dict({k: t.numpy() for k, t in sd.items()},
                                      importer)
        want = np.asarray(FAMILIES[kind][0]("disc").apply(variables, x, y))
        port = pck.load_params(f, FAMILIES[kind][1]("disc")).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(y).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- the epoch driver with metrics-dict steps -----------------------------

N_BATCHES = 3


def _ratio_iter_fn(shape_x, shape_y):
    def fn(epoch):
        rng = np.random.RandomState(200 + epoch)
        for _ in range(N_BATCHES):
            yield {"x": torch.from_numpy(rng.randn(4, *shape_x).astype(
                       np.float32)),
                   "y": torch.from_numpy(rng.randn(4, *shape_y).astype(
                       np.float32)),
                   "is_real": (rng.rand(4) < 0.5).astype(np.float32)}
    return fn


def _fresh(kind):
    torch.manual_seed(1)
    net = (pm.FlexibleRatioEstimator(feature_dim=16, hidden_dim=32)
           if kind == "flex" else pm.RatioEstimatorMNISTSVHN())
    state = create_ratio_state(net, "cpu", lr=1e-3, ema_decay=0.9)
    step = make_ratio_train_step("disc", ema_decay=0.9)
    return state, (lambda s, b, g: step(s, b["x"], b["y"], b["is_real"], g))


def _quiet(*_):
    pass


@pytest.mark.parametrize("kind", ["flex", "mnist_svhn"])
def test_sigterm_resume_matches_uninterrupted(tmp_path, kind):
    """A SIGTERM in epoch 1, then a restart from the preempt file: weights,
    BatchNorm buffers, EMA, Adam moments and every epoch metric equal the
    uninterrupted run's bit for bit."""
    shapes = ((8, 8, 1), (8, 8, 1)) if kind == "flex" else \
        ((16, 16, 1), (16, 16, 3))
    data = _ratio_iter_fn(*shapes)
    ck = str(tmp_path / "preempt.pth")
    ref, step = _fresh(kind)
    ref, _, hist_ref = train_epochs(ref, step, data, 3, RNG(7),
                                    loss_key="loss", log_fn=_quiet)
    assert set(hist_ref[0]) == {"epoch", "loss", "acc_real", "acc_fake",
                                "steps_per_sec"}

    state, step = _fresh(kind)
    count = {"n": 0}

    def sigterm_step(st, b, g):
        count["n"] += 1
        if count["n"] == N_BATCHES + 2:            # epoch 1, step 2
            os.kill(os.getpid(), signal.SIGTERM)
        return step(st, b, g)

    _, _, hist = train_epochs(state, sigterm_step, data, 3, RNG(7),
                              loss_key="loss", preempt_path=ck,
                              log_fn=_quiet)
    assert hist[-1]["preempted"] and hist[-1]["preempted_at_step"] == 2
    saved = pck.load_checkpoint(ck)
    assert set(saved["partial_sums"]) == {"loss", "acc_real", "acc_fake"}
    if kind == "mnist_svhn":
        assert "encoder_svhn.bn1a.running_var" in saved["model_state_dict"]

    resumed, step = _fresh(kind)
    resumed, resume = restore_preempt(ck, resumed)
    resumed, _, hist_r = train_epochs(resumed, step, data, 3, RNG(7),
                                      loss_key="loss", log_fn=_quiet,
                                      **resume)
    for k, t in ref.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], t), k
    for k, t in ref.ema.items():
        assert torch.equal(resumed.ema[k], t), k
    ref_opt = ref.optimizer.state_dict()["state"]
    for i, s in resumed.optimizer.state_dict()["state"].items():
        assert torch.equal(s["exp_avg_sq"], ref_opt[i]["exp_avg_sq"])
    by_epoch = {h["epoch"]: h for h in hist_ref}
    for h in hist_r:
        for k in ("loss", "acc_real", "acc_fake"):
            assert h[k] == by_epoch[h["epoch"]][k], (h["epoch"], k)
    assert not finish_preemptible(hist_r, ck, log_fn=_quiet)


# ---- data -----------------------------------------------------------------

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


RATIO_KEYS = ("x", "y", "is_real", "label_x", "label_y")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_exp1_ratio_loader_matches_jax(data_roots, device):
    jl = jmd.get_ratio_dataloader("rotate90", 64, 0.4, True, data_roots[0],
                                  seed=3)
    pl = pmd.get_ratio_dataloader("rotate90", 64, 0.4, True, data_roots[1],
                                  seed=3, device=device)
    _same_batches(jl, pl, RATIO_KEYS)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_exp2_ratio_loader_matches_jax(data_roots, device):
    jl = jms.get_mnist_svhn_ratio_dataloader(64, 0.5, True, data_roots[0],
                                             seed=4)
    pl = pms.get_mnist_svhn_ratio_dataloader(64, 0.5, True, data_roots[1],
                                             seed=4, device=device)
    _same_batches(jl, pl, RATIO_KEYS)
    if device is not None:
        assert isinstance(next(pl.epoch(0))["is_real"], torch.Tensor)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_exp2_paired_loader_matches_jax(data_roots, device):
    jl = jms.get_mnist_svhn_dataloader(64, True, data_roots[0], seed=5)
    pl = pms.get_mnist_svhn_dataloader(64, True, data_roots[1], seed=5,
                                       device=device)
    _same_batches(jl, pl, ("x", "y", "label"))


def test_pairing_matches_jax():
    labels = np.random.RandomState(9).randint(0, 10, 200)
    q = np.random.RandomState(10).randint(0, 10, 50)
    jp, pp = jpipe.Pairing(labels), ppipe.Pairing(labels)
    a, b = np.random.RandomState(11), np.random.RandomState(11)
    np.testing.assert_array_equal(pp.same_label(q, b), jp.same_label(q, a))
    for u, w in zip(pp.different_label(q, b), jp.different_label(q, a)):
        np.testing.assert_array_equal(u, w)
    idx, tgt = pp.different_label(q, b)
    assert (labels[idx] == tgt).all() and (tgt != q).all()
    with pytest.raises(ValueError, match="No samples for class 3"):
        ppipe.Pairing(np.array([0, 1, 2]), num_classes=4)


# ---- the train CLIs -------------------------------------------------------

def _cli_env(tmp_path, monkeypatch, n=64):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RGMF_SYNTH_N", str(n))
    return ["--device", "cpu", "--data_root", str(tmp_path / "data")]


@pytest.mark.parametrize("cli,argv,files", [
    (train_ratio, [], ["ratio_disc_rotate90_best.pth",
                       "ratio_disc_rotate90_ema_best.pth"]),
    (train_ratio, ["--loss_type", "rulsif", "--transform_type", "flip_h"],
     ["ratio_rulsif_flip_h_best.pth", "ratio_rulsif_flip_h_ema_best.pth"]),
    (train_ratio_mnist_svhn, [], ["ratio_disc_mnist_svhn_best.pth",
                                  "ratio_disc_mnist_svhn_ema_best.pth"]),
], ids=["exp1_disc", "exp1_rulsif", "mnist_svhn"])
def test_ratio_train_clis_run_on_cpu(tmp_path, monkeypatch, cli, argv,
                                     files):
    base = _cli_env(tmp_path, monkeypatch)
    state, best, hist = cli.main(base + argv + [
        "--epochs", "1", "--batch_size", "32", "--ema_decay", "0.999",
        "--preempt_path", "ck/preempt.pth"])
    assert np.isfinite(best) and hist[-1]["epoch"] == 1
    assert sorted(os.listdir("checkpoints")) == files
    assert not os.path.exists("ck/preempt.pth")
    assert state.model.training and state.clip_norm == 1.0
    net = (pm.RatioEstimatorMNISTSVHN() if cli is train_ratio_mnist_svhn
           else pm.RatioEstimatorMNIST())
    for f in files:                           # strict loads, as the CLIs do
        pck.load_params(os.path.join("checkpoints", f), net)


def test_ratio_cli_periodic_save_every_ten_epochs(tmp_path, monkeypatch):
    """save_every 10 and patience 5, as the reference fixes them: eleven
    short epochs write epoch10 and no other periodic file (or stop early
    after five epochs without a new best)."""
    base = _cli_env(tmp_path, monkeypatch)
    _, _, hist = train_ratio.main(base + ["--epochs", "11", "--batch_size",
                                          "64", "--lr", "1e-5"])
    periodic = [f for f in os.listdir("checkpoints") if "epoch" in f]
    if len(hist) >= 10:
        assert periodic == ["ratio_disc_rotate90_epoch10.pth"]
    else:                                       # stopped by patience 5
        losses = [h["loss"] for h in hist]
        assert len(hist) - 1 - int(np.argmin(losses)) == 5
        assert periodic == []


@pytest.mark.parametrize("argv,exc,match", [
    (["--fused_steps", "2", "--batch_size", "16"], None, None),
    (["--fast_rng"], SystemExit, "no meaning in torch"),
    # a process id alone, or a coordinator alone, is one process (JAX)
    (["--process_id", "0", "--batch_size", "16"], None, None),
    (["--coordinator_address", "h:1", "--batch_size", "16"], None, None),
    (["--fused_steps", "2", "--coordinator_address", "127.0.0.1:1",
      "--num_processes", "2", "--process_id", "1"], SystemExit,
     "single-process only"),
])
@pytest.mark.parametrize("cli", [train_ratio, train_ratio_mnist_svhn],
                         ids=["exp1", "mnist_svhn"])
def test_ratio_train_cli_refusals(tmp_path, monkeypatch, cli, argv, exc,
                                  match):
    """What the runtime flags do: the refusals, and the single-process
    runs (--fused_steps among them)."""
    base = _cli_env(tmp_path, monkeypatch)
    argv = base + ["--epochs", "1", "--batch_size", "4"] + argv
    if exc is not None:
        with pytest.raises(exc, match=match):
            cli.main(argv)
        return
    _, best, hist = cli.main(argv)
    assert np.isfinite(best) and hist[-1]["epoch"] == 1
