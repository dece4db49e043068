"""Gradient guidance of the PyTorch port against the JAX package, on the CPU.

* The GroupNorm+SiLU backward's plain version
  (ops/groupnorm.py:group_norm_silu_backward_reference) against
  torch.autograd through `group_norm_silu_reference` (float64 to 1e-10,
  float32 to rtol 1e-5 / atol 1e-6) and against jax.grad through the JAX
  FusedGroupNorm(fuse_silu=True) XLA path (float32, rtol 1e-4 / atol 1e-5);
  the autograd Function around it; `gn_backward_plan`'s cases are in
  tests/test_torch_port_plans.py.
* 'grad' and 'mc_feng+grad' guidance against JAX `make_guided_sampler_p`
  on injected noise (and MC set): Euler and midpoint, grad_scale 'const'
  and 'sigma', grad_t_max < 1, with an experiment-1 GroupNorm ratio net
  (FlexibleRatioEstimator) and an experiment-2 BatchNorm ratio net
  (RatioEstimatorMNISTSVHN); x1 and y1 to rtol 1e-4 / atol 1e-4, the
  tolerance of tests/test_torch_port_sampler.py.
* mc_refresh = 2 equal to the port's own segment-by-segment composition
  from the same generator, and the JAX package's three ValueErrors.
Small nets (FlexibleUNet, model_channels=16, 16x16); inputs from numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.models.layers import FusedGroupNorm
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import make_time_grid
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_backward,
    group_norm_silu_backward_reference,
    group_norm_silu_reference,
    gn_stats_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

torch.set_num_threads(2)

H = 16
UNET_KW = dict(img_size=H, model_channels=16, channel_mult=(1, 2),
               num_res_blocks=1, dropout=0.0)


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _gn_inputs(dtype, seed, channels_last=False, shape=(3, 16, 5, 6)):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape) * 2.0 + 0.5).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    C = shape[1]
    w = torch.from_numpy(rng.uniform(0.5, 1.5, C)).float()
    b = torch.from_numpy(rng.randn(C) * 0.1).float()
    dy = torch.from_numpy(rng.randn(*shape)).to(dtype)
    return x, w, b, dy


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float64, dict(rtol=1e-10, atol=1e-10)),
    (torch.float32, dict(rtol=1e-5, atol=1e-6))])
def test_gn_backward_reference_matches_autograd(dtype, tol, channels_last):
    x, w, b, dy = _gn_inputs(dtype, 0, channels_last)
    if dtype == torch.float64:
        w, b = w.double(), b.double()
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    want = torch.autograd.grad(group_norm_silu_reference(xs, ws, bs, 8),
                               (xs, ws, bs), dy)
    mean, rstd = gn_stats_reference(x, 8)
    got = group_norm_silu_backward_reference(dy, x, w, b, mean, rstd)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype
        torch.testing.assert_close(g, e, **tol)
    dx, dw, db = group_norm_silu_backward_reference(dy, x, w, b, mean, rstd,
                                                    weight_grads=False)
    assert dw is None and db is None and torch.equal(dx, got[0])


@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 32), 8),
                                          ((3, 7, 5, 16), 8),
                                          ((2, 3, 3, 128), 8),
                                          ((4, 6, 6, 4), 4)])
def test_gn_backward_reference_matches_jax_grad(shape, groups):
    """jax.vjp of the JAX FusedGroupNorm(fuse_silu=True) XLA path (NHWC)
    against the port's plain backward (NCHW), float32."""
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    C = shape[-1]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    mod = FusedGroupNorm(num_groups=groups, fuse_silu=True)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    y, vjp = jax.vjp(lambda p, xx: mod.apply(p, xx), params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mean, rstd = gn_stats_reference(xt, groups)
    got_y = group_norm_silu_reference(xt, torch.from_numpy(scale),
                                      torch.from_numpy(bias), groups)
    gx, gs, gb = group_norm_silu_backward_reference(
        torch.from_numpy(dy).permute(0, 3, 1, 2), xt, torch.from_numpy(scale),
        torch.from_numpy(bias), mean, rstd)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), **tol)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(dx), **tol)
    np.testing.assert_allclose(gs.numpy(), np.asarray(dp["params"]["scale"]),
                               **tol)
    np.testing.assert_allclose(gb.numpy(), np.asarray(dp["params"]["bias"]),
                               **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_is_an_autograd_function(dtype):
    """Under autograd the wrapper records the Function; its backward on the
    CPU is the plain backward, and frozen weights get no dγ, dβ."""
    x, w, b, dy = _gn_inputs(dtype, 1, channels_last=True)
    xs = x.clone().requires_grad_(True)
    y = group_norm_silu(xs, w, b, 8)
    assert y.grad_fn is not None and "GroupNormSiLU" in type(y.grad_fn).__name__
    assert torch.equal(y, group_norm_silu_reference(x, w, b, 8))
    (dx,) = torch.autograd.grad(y, xs, dy)
    mean, rstd = gn_stats_reference(x, 8)
    want, _, _ = group_norm_silu_backward_reference(dy, x, w, b, mean, rstd)
    assert torch.equal(dx, want)
    ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y = group_norm_silu(x, ws, bs, 8)
    assert xs.grad is None
    dw, db = torch.autograd.grad(y, (ws, bs), dy)
    _, w_want, b_want = group_norm_silu_backward(dy, x, w, b, mean, rstd)
    assert torch.equal(dw, w_want) and torch.equal(db, b_want)
    with torch.no_grad():                     # no recording: the plain path
        assert group_norm_silu(xs, ws, bs, 8).grad_fn is None
    assert group_norm_silu_backward.launches == 0    # no kernel on the CPU


def test_gn_backward_wrapper_checks_dy():
    x, w, b, dy = _gn_inputs(torch.float32, 2)
    mean, rstd = gn_stats_reference(x, 8)
    with pytest.raises(ValueError, match="dy"):
        group_norm_silu_backward(dy.to(torch.bfloat16), x, w, b, mean, rstd)


# ---- the grad methods of the sampler against JAX ---------------------------


def _randomise_norms(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            if k.startswith(("gn", "ln")):
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                    np.float32)
                v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(
                    np.float32)
            else:
                _randomise_norms(v, rng)


def _unets(in_chs, seed):
    out = []
    for i, in_ch in enumerate(in_chs):
        jnet = jm.FlexibleUNet(in_channels=in_ch, **UNET_KW)
        v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jnet.init)(
            jax.random.PRNGKey(seed + i), jnp.zeros((1, H, H, in_ch)),
            jnp.zeros((1,)))))
        oc = v["params"]["out_conv"]
        oc["kernel"] = (np.random.RandomState(seed + i).randn(
            *oc["kernel"].shape) * 0.1).astype(np.float32)
        pnet = pm.FlexibleUNet(in_channels=in_ch, **UNET_KW).eval()
        pnet.load_state_dict(unet_state_dict(v, channel_mult=(1, 2),
                                             num_res_blocks=1), strict=True)
        out.append((jnet, v, pnet))
    return out


@pytest.fixture(scope="module")
def exp1_nets():
    """Experiment 1 at 16x16: two 1-channel U-Nets and a GroupNorm ratio
    net (FlexibleRatioEstimator, narrow score MLP) with non-trivial norms."""
    jr = jm.FlexibleRatioEstimator(feature_dim=32, hidden_dim=64)
    vr = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jr.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, H, H, 1)),
        jnp.zeros((1, H, H, 1)))))
    _randomise_norms(vr["params"], np.random.RandomState(4))
    pr = pm.FlexibleRatioEstimator(feature_dim=32, hidden_dim=64).eval()
    pr.load_state_dict(state_dict_from_jax(vr, "ratio_mnist"), strict=True)
    return _unets((1, 1), 0), (jr, vr, pr), (H, H, 1), (H, H, 1)


@pytest.fixture(scope="module")
def exp2_nets():
    """Experiment 2 at 16x16: 1- and 3-channel U-Nets and the BatchNorm
    ratio net RatioEstimatorMNISTSVHN."""
    jr = jm.RatioEstimatorMNISTSVHN()
    vr = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jr.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, H, H, 1)),
        jnp.zeros((1, H, H, 3)))))
    pr = pm.RatioEstimatorMNISTSVHN().eval()
    pr.load_state_dict(state_dict_from_jax(vr, "ratio_mnist_svhn"),
                       strict=True)
    return _unets((1, 3), 10), (jr, vr, pr), (H, H, 1), (H, H, 3)


def _jax_sampler(nets, **cfg_kw):
    (ux, uy), (jr, vr, _), xs, ys = nets
    cfg = jg.GuidedSamplerConfig(x_shape=xs, y_shape=ys, **cfg_kw)
    return jg.make_guided_sampler_p(
        lambda p, x, t: ux[0].apply(p, x, t),
        lambda p, y, t: uy[0].apply(p, y, t), cfg,
        lambda p, x, y: jr.apply(p, x, y, method=jr.log_ratio)), \
        (ux[1], uy[1], vr)


def _port_sampler(nets, **cfg_kw):
    (ux, uy), (_, _, pr), xs, ys = nets
    cfg = pg.GuidedSamplerConfig(x_shape=xs, y_shape=ys, **cfg_kw)
    return pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), cfg,
        lambda m, x, y: ratio_log_fn(m)(x, y)), (ux[2], uy[2], pr)


def _samplers(nets, **cfg_kw):
    return _jax_sampler(nets, **cfg_kw), _port_sampler(nets, **cfg_kw)


GRAD_CASES = [
    ("grad", dict(solver="euler")),
    ("grad", dict(solver="midpoint")),
    ("grad", dict(solver="euler", grad_scale="sigma", grad_t_max=0.6)),
    ("grad", dict(solver="midpoint", grad_scale="sigma", grad_strength=3.0)),
    ("mc_feng+grad", dict(solver="euler", grad_strength=2.0)),
    ("mc_feng+grad", dict(solver="midpoint", grad_t_max=0.5)),
]


@pytest.mark.parametrize("exp", ["exp1", "exp2"])
@pytest.mark.parametrize("method,kw", GRAD_CASES)
def test_grad_sampler_matches_jax(exp1_nets, exp2_nets, exp, method, kw):
    """B=3, N_mc=8, 4 steps, injected noise and MC set, float32."""
    nets = exp1_nets if exp == "exp1" else exp2_nets
    xs, ys = nets[2], nets[3]
    cfg = dict(guidance_method=method, guidance_strength=0.5, num_steps=4,
               mc_batch_size=8, **kw)
    (js, jp), (ps, pp) = _samplers(nets, **cfg)
    noise = (_np(3, *xs, seed=20), _np(3, *ys, seed=21))
    mc = (_np(8, *xs, seed=22), _np(8, *ys, seed=23), np.exp(_np(8, seed=24)))
    jx1, jy1, jd = js(jp, jax.random.PRNGKey(0), 3,
                      mc_set=tuple(map(jnp.asarray, mc)),
                      init_noise=tuple(map(jnp.asarray, noise)))
    px1, py1, pd = ps(pp, torch.Generator().manual_seed(0), 3,
                      mc_set=tuple(map(torch.from_numpy, mc)),
                      init_noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    assert set(pd) <= set(jd) and bool(pd) == bool(jd)   # {} for 'grad'
    if method == "mc_feng+grad":
        np.testing.assert_allclose(pd["ess"].numpy(), np.asarray(jd["ess"]),
                                   rtol=1e-3, atol=1e-3)
    # the grad term moved the samples: the same call without it differs
    base = dict(cfg, guidance_method="none" if method == "grad"
                else "mc_feng")
    ps0, _ = _port_sampler(nets, **base)
    px0, py0, _ = ps0(pp, torch.Generator().manual_seed(0), 3,
                      mc_set=tuple(map(torch.from_numpy, mc)),
                      init_noise=tuple(map(torch.from_numpy, noise)))
    assert float((px1 - px0).abs().max() + (py1 - py0).abs().max()) > 1e-3


def test_grad_writes_no_parameter_grad(exp1_nets):
    ps, pp = _port_sampler(exp1_nets, guidance_method="grad",
                           guidance_strength=0.5, num_steps=2)
    x1, _, d = ps(pp, torch.Generator().manual_seed(1), 2)
    assert d == {} and torch.isfinite(x1).all()
    assert all(p.grad is None for m in pp for p in m.parameters())


def test_grad_term_is_gated_like_jax():
    """γ_g·[t > ε]·[t < grad_t_max]·σ_t² against the JAX expression, in
    float32, on a stand-in ratio whose gradient is 1 everywhere."""
    for scale, t_max in (("const", 1.0), ("sigma", 1.0), ("sigma", 0.55)):
        cfg = pg.GuidedSamplerConfig(guidance_method="grad",
                                     guidance_strength=0.7, grad_scale=scale,
                                     grad_t_max=t_max, x_shape=(2,),
                                     y_shape=(2,))
        step = pg._make_guided_step(
            lambda x, t: torch.zeros_like(x), lambda y, t: torch.zeros_like(y),
            cfg, None, lambda x, y: x.sum(1) + y.sum(1))
        for t in make_time_grid(10)[0]:
            x1, _, _ = step(torch.zeros(1, 2), torch.zeros(1, 2), t,
                            np.float32(1.0))
            tj = jnp.float32(t)
            gate = (tj > jg.EPS_T).astype(jnp.float32) * 0.7
            if t_max < 1.0:
                gate = gate * (tj < t_max).astype(jnp.float32)
            if scale == "sigma":
                sig = 1.0 - tj + jg.EPS_T
                gate = gate * sig * sig
            assert float(x1[0, 0]) == float(gate), (scale, t_max, t)


# ---- mc_refresh --------------------------------------------------------------


def test_mc_refresh_is_the_segment_composition(exp2_nets):
    """K = 2 equals drawing the noise, then per segment a fresh MC set and
    its half of the grid's steps, from the same generator."""
    ps, pp = _port_sampler(exp2_nets, guidance_method="mc_feng+grad",
                           guidance_strength=0.5, num_steps=4,
                           mc_batch_size=6, mc_refresh=2)
    x1, y1, d = ps(pp, torch.Generator().manual_seed(7), 3)
    assert d["ess"].shape == (4, 3) and d["w_max"].shape == (4,)
    cfg = pg.GuidedSamplerConfig(guidance_method="mc_feng+grad",
                                 guidance_strength=0.5, num_steps=4,
                                 mc_batch_size=6, x_shape=exp2_nets[2],
                                 y_shape=exp2_nets[3])
    fx, fy, lr = velocity_fn(pp[0]), velocity_fn(pp[1]), ratio_log_fn(pp[2])
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        x = torch.randn((3,) + cfg.x_shape, generator=g)
        y = torch.randn((3,) + cfg.y_shape, generator=g)
        ts, dts = make_time_grid(4)
        ess = []
        for k in range(2):
            mc = pg.generate_mc_set(fx, fy, lr, g, 6, cfg.x_shape,
                                    cfg.y_shape, 4)
            step = pg._make_guided_step(fx, fy, cfg, mc, lr)
            for t, dt in zip(ts[2 * k:2 * k + 2], dts[2 * k:2 * k + 2]):
                x, y, diag = step(x, y, t, dt)
                ess.append(diag["ess"])
    assert torch.equal(x1, x) and torch.equal(y1, y)
    assert torch.equal(d["ess"], torch.stack(ess))
    ps1, _ = _port_sampler(exp2_nets, guidance_method="mc_feng+grad",
                           guidance_strength=0.5, num_steps=4,
                           mc_batch_size=6)
    x1_one, _, _ = ps1(pp, torch.Generator().manual_seed(7), 3)
    assert not torch.equal(x1_one, x1)        # the second set mattered


@pytest.mark.parametrize("cfg_kw,call_mc", [
    (dict(mc_refresh=0), False),
    (dict(mc_refresh=3, num_steps=4), False),
    (dict(mc_refresh=2, num_steps=4), True)])
def test_mc_refresh_raises_as_jax(exp2_nets, cfg_kw, call_mc):
    """JAX's three ValueErrors: mc_refresh < 1, a refresh count that does
    not divide num_steps, and a caller's mc_set with mc_refresh > 1."""
    kw = dict(dict(guidance_method="mc_feng", guidance_strength=0.5,
                   num_steps=4, mc_batch_size=4), **cfg_kw)
    xs, ys = exp2_nets[2], exp2_nets[3]
    mc = (_np(4, *xs), _np(4, *ys), np.ones(4, np.float32))
    for make, key, arr in ((_jax_sampler, jax.random.PRNGKey(0), jnp.asarray),
                           (_port_sampler, torch.Generator().manual_seed(0),
                            torch.from_numpy)):
        with pytest.raises(ValueError, match="mc_refresh"):
            sampler, params = make(exp2_nets, **kw)
            if call_mc:
                sampler(params, key, 2, mc_set=tuple(map(arr, mc)))
