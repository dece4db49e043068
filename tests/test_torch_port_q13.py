"""The JAX public names that the port took last (on the CPU): the closure
sampler `make_guided_sampler`, the `euler_scan` aliases, the dtype policy
and `cast_floating`, async checkpoint saves with `wait_for_saves`, the
`get_checkpoint_path` alias, the GroupNorm factories and the resblock
plain version's JAX name; and every port net starting as flax initialises
the JAX ones.

The closure sampler equals `make_guided_sampler_p` bit for bit (same draws
in the same order) and the JAX closure sampler on bridged weights at
tests/test_torch_port_sampler.py's tolerances (1e-4 on states, 1e-3 on the
per-step ESS); the aliases equal their targets bit for bit; `cast_floating`
gives JAX's dtypes and values on the same numpy tree.
"""
import collections
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.core import dtypes as jdtypes
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core import dtypes as pdtypes
from ratio_guided_multimodal_fm_tpu_torch.flow import cfm as pcfm
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg
from ratio_guided_multimodal_fm_tpu_torch.train import checkpoint as pck
from test_torch_port_sampler import (
    X_SHAPE,
    Y_SHAPE,
    _np,
    _pair_of_unets,
    _ratio_pair,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nets():
    jx, px, mx = _pair_of_unets(1, 0)
    jy, py, my = _pair_of_unets(3, 1)
    jr, pr, mr = _ratio_pair()
    return dict(jx=jx, px=px, mx=mx, jy=jy, py=py, my=my, jr=jr, pr=pr,
                mr=mr)


def _cfg(mod, method="mc_feng", **kw):
    return mod.GuidedSamplerConfig(
        guidance_method=method, guidance_strength=0.5, num_steps=6,
        mc_batch_size=16, x_shape=X_SHAPE, y_shape=Y_SHAPE, **kw)


def _injected():
    noise = (_np(4, *X_SHAPE, seed=10), _np(4, *Y_SHAPE, seed=11))
    mc = (_np(16, *X_SHAPE, seed=12), _np(16, *Y_SHAPE, seed=13),
          np.exp(_np(16, seed=14)))
    return noise, mc


# ---- make_guided_sampler ---------------------------------------------------

@pytest.mark.parametrize("method,inject", [("mc_feng", True),
                                           ("mc_feng", False),
                                           ("none", False)])
def test_closure_sampler_equals_the_p_form_bit_for_bit(nets, method, inject):
    """The same models through closures and as call arguments: x1, y1 and
    every diagnostic equal, with injected noise and MC set or with both
    drawn from the same generator seed."""
    closure = pg.make_guided_sampler(nets["px"], nets["py"],
                                     _cfg(pg, method), nets["pr"])
    p_form = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), _cfg(pg, method),
        lambda m, x, y: ratio_log_fn(m)(x, y))
    kw = {}
    if inject:
        noise, mc = _injected()
        kw = dict(mc_set=tuple(map(torch.from_numpy, mc)),
                  init_noise=tuple(map(torch.from_numpy, noise)))
    a = closure(torch.Generator().manual_seed(3), 4, **kw)
    b = p_form((nets["mx"], nets["my"], nets["mr"]),
               torch.Generator().manual_seed(3), 4, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_closure_sampler_passes_the_merged_pair_and_shard_arguments(nets):
    """fm_pair_fn reaches the sampler as a bound pair function, and the
    sharding keywords go through: one data shard of two keeps its rows
    (the same draws; its convolutions run at another batch size, so to
    float32 rounding)."""
    calls = []

    def pair(x, y, t):
        calls.append(x.shape[0])
        return nets["px"](x, t), nets["px"](y, t)

    cfg = pg.GuidedSamplerConfig("none", 0.0, num_steps=3, mc_batch_size=4,
                                 x_shape=X_SHAPE, y_shape=X_SHAPE)
    px1 = pg.make_guided_sampler(nets["px"], nets["px"], cfg,
                                 fm_pair_fn=pair)
    assert px1(torch.Generator().manual_seed(1), 4)[0].shape == (4,) + X_SHAPE
    assert calls == [4, 4, 4]
    half = pg.make_guided_sampler(nets["px"], nets["px"], cfg,
                                  data_shard=(1, 2))
    full = pg.make_guided_sampler(nets["px"], nets["px"], cfg)
    h = half(torch.Generator().manual_seed(2), 4)[0]
    f = full(torch.Generator().manual_seed(2), 4)[0]
    assert h.shape == (2,) + X_SHAPE
    torch.testing.assert_close(h, f[2:], rtol=1e-5, atol=1e-5)


def test_closure_sampler_matches_jax(nets):
    """Injected init_noise and mc_set (B=4, N_mc=16, 6 steps, float32),
    JAX's closure sampler against the port's on bridged weights."""
    noise, mc = _injected()
    js = jg.make_guided_sampler(nets["jx"], nets["jy"], _cfg(jg),
                                nets["jr"])
    ps = pg.make_guided_sampler(nets["px"], nets["py"], _cfg(pg),
                                nets["pr"])
    jx1, jy1, jd = js(jax.random.PRNGKey(0), 4,
                      mc_set=tuple(map(jnp.asarray, mc)),
                      init_noise=tuple(map(jnp.asarray, noise)))
    px1, py1, pd = ps(torch.Generator().manual_seed(0), 4,
                      mc_set=tuple(map(torch.from_numpy, mc)),
                      init_noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pd["ess"].numpy(), np.asarray(jd["ess"]),
                               rtol=1e-3, atol=1e-3)


# ---- euler_scan aliases ------------------------------------------------------

def test_euler_scan_aliases_equal_their_targets(nets):
    x0 = torch.from_numpy(_np(3, *X_SHAPE, seed=5))
    y0 = torch.from_numpy(_np(3, *X_SHAPE, seed=6))
    assert torch.equal(pcfm.euler_scan(nets["px"], x0, 5),
                       pcfm.ode_scan(nets["px"], x0, 5, solver="euler"))

    def pair(x, y, t):
        return nets["px"](x, t), nets["px"](y, t)

    a = pcfm.euler_scan_pair(pair, x0, y0, 5)
    b = pcfm.ode_scan_pair(pair, x0, y0, 5, solver="euler")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---- the dtype policy ----------------------------------------------------------

def test_policies_mirror_jax():
    for name in ("DEFAULT_POLICY", "BF16_POLICY"):
        jp, pp = getattr(jdtypes, name), getattr(pdtypes, name)
        for field in ("param_dtype", "compute_dtype", "reduce_dtype"):
            assert (jnp.dtype(getattr(jp, field)).name
                    == str(getattr(pp, field)).replace("torch.", ""))
    assert pdtypes.Policy() == pdtypes.DEFAULT_POLICY


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cast_floating_matches_jax(dtype):
    """The same numpy tree through both: floating leaves cast, integer and
    bool leaves and Python scalars untouched, containers kept."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "n": [np.arange(5, dtype=np.int32),
                  (rng.randn(2).astype(np.float16), 3.5,
                   np.array([True, False]))],
            "h": {"x": rng.randn(4).astype(np.float32)}}
    jout = jdtypes.cast_floating(
        jax.tree_util.tree_map(jnp.asarray, tree), getattr(jnp, dtype))
    jleaves = jax.tree_util.tree_leaves(jout)   # keys sorted: h, n, w
    ptree = {"w": torch.from_numpy(tree["w"]),
             "n": [torch.from_numpy(tree["n"][0]),
                   (torch.from_numpy(tree["n"][1][0]), 3.5,
                    torch.from_numpy(tree["n"][1][2]))],
             "h": {"x": torch.from_numpy(tree["h"]["x"])}}
    pout = pdtypes.cast_floating(ptree, getattr(torch, dtype))
    assert isinstance(pout["n"], list) and isinstance(pout["n"][1], tuple)
    pleaves = [pout["h"]["x"], pout["n"][0], pout["n"][1][0],
               pout["n"][1][1], pout["n"][1][2], pout["w"]]
    assert len(pleaves) == len(jleaves)
    for p, j in zip(pleaves, jleaves):
        if not isinstance(p, torch.Tensor):
            assert p == j == 3.5
            continue
        assert str(p.dtype).replace("torch.", "") == np.asarray(j).dtype.name
        np.testing.assert_array_equal(p.double().numpy(),
                                      np.asarray(j).astype(np.float64))


def test_cast_floating_walks_a_state_dict():
    net = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    out = pdtypes.cast_floating(net.state_dict(), torch.bfloat16)
    assert isinstance(out, collections.OrderedDict)
    assert list(out) == list(net.state_dict())
    assert out["0.weight"].dtype == torch.bfloat16
    assert out["1.num_batches_tracked"].dtype == torch.int64


# ---- async checkpoint saves ---------------------------------------------------

def test_async_save_roundtrip(tmp_path):
    """tests/test_async_checkpoint.py:12 in the port: a non-blocking save,
    read back through load_checkpoint (which waits for it)."""
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": 1.5}
    path = str(tmp_path / "async_ck.pth")
    pck.save_checkpoint(path, tree, async_save=True)
    restored = pck.load_checkpoint(path)
    assert torch.equal(restored["w"], tree["w"])
    assert float(restored["b"]) == 1.5
    pck.wait_for_saves()                       # idempotent


def test_async_save_keeps_the_state_of_its_call(tmp_path, monkeypatch):
    """The host copy is made at the call: a model changed while the write
    is still in flight is saved as it was."""
    release = threading.Event()
    write = pck._write

    def slow_write(path, obj):
        release.wait(10)
        write(path, obj)

    monkeypatch.setattr(pck, "_write", slow_write)
    net = torch.nn.Linear(4, 3)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    path = str(tmp_path / "net.pth")
    pck.save_checkpoint(path, net.state_dict(), async_save=True)
    with torch.no_grad():
        net.weight.add_(1.0)
    assert not os.path.exists(path)            # still in flight
    release.set()
    pck.wait_for_saves()
    got = pck.load_checkpoint(path)
    for k, v in before.items():
        assert torch.equal(got[k], v)


def test_a_failing_writer_raises_at_wait_for_saves(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    pck.save_checkpoint(str(blocker / "ck.pth"), {"a": torch.ones(2)},
                        async_save=True)
    with pytest.raises(OSError):
        pck.wait_for_saves()
    pck.wait_for_saves()                       # reported once, then clear


def test_a_preempted_loop_leaves_no_save_in_flight(tmp_path, monkeypatch):
    """The best save of epoch 1 writes slowly; preemption in epoch 2 waits
    for it before the resumable save, and the loop returns with nothing
    pending and every file on disk."""
    from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
    from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
        train_flow_matching_epochs,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.preemption import (
        request_preemption,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        create_fm_state,
        make_fm_train_step,
    )

    write = pck._write

    def slow_write(path, obj):
        time.sleep(0.3)
        write(path, obj)

    monkeypatch.setattr(pck, "_write", slow_write)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 1, 1))

    class Velocity(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x, t):
            return self.net(x)

    state = create_fm_state(Velocity(), "cpu", lr=1e-3, ema_decay=0.9)
    step = make_fm_train_step(0.9)
    data = torch.from_numpy(_np(8, 4, 4, 1, seed=1))
    count = {"n": 0}

    def preempting_step(st, x1, gen):
        count["n"] += 1
        if count["n"] == 3:                    # epoch 2, step 1
            request_preemption()
        return step(st, x1, gen)

    best = str(tmp_path / "flow_x_best.pth")
    ck = str(tmp_path / "preempt.pth")
    _, _, hist = train_flow_matching_epochs(
        state, preempting_step, lambda e: [data[:4], data[4:]], 4, RNG(7),
        best_path=best, preempt_path=ck, log_fn=lambda *_: None)
    assert hist[-1]["preempted"]
    assert not pck._writer._pending and not pck._writer.requested
    for p in (best, pck.ema_checkpoint_path(best), ck):
        assert os.path.exists(p), p


# ---- aliases and factories -------------------------------------------------------

def test_get_checkpoint_path_is_checkpoint_path(tmp_path):
    base = str(tmp_path / "ck")
    assert pck.get_checkpoint_path("flow", "x", None, "best",
                                   base_dir=base) == pck.checkpoint_path(
        "flow", "x", None, "best", base_dir=base)
    assert not os.path.exists(base)            # unlike JAX, no mkdir


def test_group_norm_factories_and_the_resblock_alias():
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
        gn_silu,
        group_norm,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
        group_norm_silu_reference,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import resblock

    gn = group_norm(4)
    assert isinstance(gn, torch.nn.GroupNorm)
    assert (gn.num_groups, gn.num_channels, gn.eps) == (4, 4, 1e-6)
    assert group_norm(64).num_groups == 8
    m = gn_silu(16, dtype=torch.bfloat16)
    assert isinstance(m, GroupNormSiLU) and m.num_groups == 8
    x = torch.from_numpy(_np(2, 16, 3, 3, seed=2))
    assert torch.equal(gn_silu(16)(x), group_norm_silu_reference(
        x, torch.ones(16), torch.zeros(16), 8, 1e-6))
    assert resblock.reference_gn_silu_conv is (
        resblock.fused_gn_silu_conv_reference)


# ---- initialisation as flax's defaults ---------------------------------------

@pytest.mark.parametrize("make", [
    "RatioEstimatorMNIST", "RatioEstimatorMNISTSVHN", "FlowMatchingUNet",
    "FlowMatchingModel", "MNISTClassifier"])
def test_every_net_starts_as_flax_initialises_it(make):
    """Every kernel of a fresh port net has lecun_normal's spread (std
    sqrt(1 / fan_in), truncated at 2 std; a transposed convolution's fan_in
    is its input channels × taps) and zero biases, as flax draws the JAX
    nets'; its norm layers start at 1 and 0, and a U-Net's out_conv at 0
    (JAX unet.py's zero initialisers)."""
    import flax.linen as fnn

    from ratio_guided_multimodal_fm_tpu_torch import models

    torch.manual_seed(0)
    net = getattr(models, make)()
    n = 0
    for name, m in net.named_modules():
        if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm,
                          torch.nn.BatchNorm2d)):
            assert bool((m.weight == 1).all()) and not m.bias.any(), name
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
            continue
        n += 1
        assert not m.bias.any(), name
        if name == "out_conv":
            assert not m.weight.any()
            continue
        fan_in = (m.weight[:, 0] if isinstance(m, torch.nn.ConvTranspose2d)
                  else m.weight[0]).numel()
        std = fan_in ** -0.5
        assert float(m.weight.abs().max()) <= 2 * std / 0.8796 + 1e-7, name
        if m.weight.numel() >= 4096:
            assert abs(float(m.weight.std()) / std - 1) < 0.1, name
    assert n >= 4
    # flax's own draw of such a kernel has the same spread
    k = fnn.Dense(256).init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
    w = np.asarray(k["params"]["kernel"])
    assert abs(w.std() / 512 ** -0.5 - 1) < 0.05
    assert np.abs(w).max() <= 2 * 512 ** -0.5 / 0.8796 + 1e-6
