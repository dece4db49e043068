"""The PyTorch port's flow integration and guided sampler against the JAX
package, on the CPU (where the guidance wrapper runs its plain version).

Small velocity nets (FlexibleUNet, model_channels=16, 16x16) and the full
ratio net keep each case to seconds. Random streams cannot cross
frameworks, so x0, the initial noise and the MC set are drawn with numpy
and handed to both. Tolerances: 1e-4 on states (float32 convolutions in
two frameworks), 1e-3 on the per-step ESS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.models import (
    FlexibleUNet as JUNet,
    RatioEstimatorMNISTSVHN as JRatio,
)
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.flow import cfm as pcfm
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    ratio_mnist_svhn_state_dict,
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleUNet as PUNet,
    RatioEstimatorMNISTSVHN as PRatio,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

torch.set_num_threads(2)

H = 16
X_SHAPE, Y_SHAPE = (H, H, 1), (H, H, 3)
UNET_KW = dict(img_size=H, model_channels=16, channel_mult=(1, 2),
               num_res_blocks=1, dropout=0.0)


def _pair_of_unets(in_ch, seed):
    """A JAX and a port U-Net with the same (non-trivial) weights."""
    jnet = JUNet(in_channels=in_ch, **UNET_KW)
    v = jax.tree_util.tree_map(np.asarray, dict(jnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, H, in_ch)),
        jnp.zeros((1,)))))
    rng = np.random.RandomState(seed)
    oc = v["params"]["out_conv"]
    oc["kernel"] = (rng.randn(*oc["kernel"].shape) * 0.1).astype(np.float32)
    pnet = PUNet(in_channels=in_ch, **UNET_KW).eval()
    pnet.load_state_dict(unet_state_dict(v, channel_mult=(1, 2),
                                         num_res_blocks=1), strict=True)
    return (lambda x, t: jnet.apply(v, x, t)), velocity_fn(pnet), pnet


def _ratio_pair(seed=4):
    jnet = JRatio()
    v = jax.tree_util.tree_map(np.asarray, dict(jnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + X_SHAPE),
        jnp.zeros((1,) + Y_SHAPE))))
    pnet = PRatio().eval()
    pnet.load_state_dict(ratio_mnist_svhn_state_dict(v), strict=True)
    return ((lambda x, y: jnet.apply(v, x, y, method=jnet.log_ratio)),
            ratio_log_fn(pnet), pnet)


@pytest.fixture(scope="module")
def nets():
    jx, px, mx = _pair_of_unets(1, 0)
    jy, py, my = _pair_of_unets(3, 1)
    jr, pr, mr = _ratio_pair()
    return dict(jx=jx, px=px, mx=mx, jy=jy, py=py, my=my, jr=jr, pr=pr,
                mr=mr)


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("kind", jcfm.TIME_GRIDS)
def test_time_grid_bit_exact(kind):
    for n in (7, 100):
        jts, jdts = jcfm.make_time_grid(n, kind, 2.0)
        pts, pdts = pcfm.make_time_grid(n, kind, 2.0)
        assert pts.dtype == pdts.dtype == np.float32
        np.testing.assert_array_equal(pts, np.asarray(jts))
        np.testing.assert_array_equal(pdts, np.asarray(jdts))


@pytest.mark.parametrize("solver", pcfm.SOLVERS)
def test_ode_scan_matches_jax(nets, solver):
    x0 = _np(3, *Y_SHAPE, seed=2)
    want = np.asarray(jcfm.ode_scan(nets["jy"], jnp.asarray(x0), 4,
                                    solver=solver, grid="late"))
    with torch.no_grad():
        got = pcfm.ode_scan(nets["py"], torch.from_numpy(x0), 4,
                            solver=solver, grid="late")
    assert np.abs(want - x0).max() > 1e-2     # the nets moved the state
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_phase_a_matches_jax(nets):
    """Phase A on the same x0: both flows, the ratio net, safe_exp_log_r."""
    x0, y0 = _np(4, *X_SHAPE, seed=3), _np(4, *Y_SHAPE, seed=4)
    jx1 = jcfm.ode_scan(nets["jx"], jnp.asarray(x0), 5)
    jy1 = jcfm.ode_scan(nets["jy"], jnp.asarray(y0), 5)
    want = np.asarray(jg.safe_exp_log_r(nets["jr"](jx1, jy1)))
    with torch.no_grad():
        px1 = pcfm.ode_scan(nets["px"], torch.from_numpy(x0), 5)
        py1 = pcfm.ode_scan(nets["py"], torch.from_numpy(y0), 5)
        got = pg.safe_exp_log_r(nets["pr"](px1, py1))
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_safe_exp_log_r_caps():
    r = pg.safe_exp_log_r(torch.tensor([0.0, 500.0]))
    assert torch.isfinite(r).all()
    np.testing.assert_allclose(r.numpy(), np.asarray(
        jg.safe_exp_log_r(jnp.array([0.0, 500.0]))), rtol=1e-6)


@pytest.mark.parametrize("t", [0.3, 0.9])
def test_mc_feng_guidance_matches_jax(t):
    xt, yt = _np(5, 4, 4, 1, seed=5), _np(5, 4, 4, 3, seed=6)
    X1, Y1 = _np(20, 4, 4, 1, seed=7), _np(20, 4, 4, 3, seed=8)
    r = np.exp(_np(20, seed=9))
    jgx, jgy, jd = jg.mc_feng_guidance(*map(jnp.asarray, (xt, yt, X1, Y1, r)),
                                       jnp.float32(t))
    pgx, pgy, pd = pg.mc_feng_guidance(*map(torch.from_numpy,
                                            (xt, yt, X1, Y1, r)), t)
    np.testing.assert_allclose(pgx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pgy.numpy(), np.asarray(jgy), rtol=1e-4,
                               atol=1e-5)
    assert set(pd) == set(jd)
    for k in ("ess", "w_max", "w_min", "Z_bar_mean", "g_x_norm", "g_y_norm"):
        np.testing.assert_allclose(pd[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(pd["w_argmax"].numpy(),
                                  np.asarray(jd["w_argmax"]))


def _guided_pair(nets, solver, **kw):
    cfg_kw = dict(guidance_method="mc_feng", guidance_strength=0.5,
                  num_steps=6, mc_batch_size=16, x_shape=X_SHAPE,
                  y_shape=Y_SHAPE, solver=solver, **kw)
    js = jg.make_guided_sampler_p(
        lambda _, x, t: nets["jx"](x, t), lambda _, y, t: nets["jy"](y, t),
        jg.GuidedSamplerConfig(**cfg_kw), lambda _, x, y: nets["jr"](x, y))
    ps = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t),
        pg.GuidedSamplerConfig(**cfg_kw),
        lambda m, x, y: ratio_log_fn(m)(x, y))
    return js, ps


@pytest.mark.parametrize("solver,kw", [("euler", {}), ("midpoint", {}),
                                       ("euler", {"ess_floor": 2.0})])
def test_guided_sampler_matches_jax(nets, solver, kw):
    """Injected init_noise and mc_set (B=4, N_mc=16, 6 steps, float32)."""
    noise = (_np(4, *X_SHAPE, seed=10), _np(4, *Y_SHAPE, seed=11))
    mc = (_np(16, *X_SHAPE, seed=12), _np(16, *Y_SHAPE, seed=13),
          np.exp(_np(16, seed=14)))
    js, ps = _guided_pair(nets, solver, **kw)
    jx1, jy1, jd = js((None, None, None), jax.random.PRNGKey(0), 4,
                      mc_set=tuple(map(jnp.asarray, mc)),
                      init_noise=tuple(map(jnp.asarray, noise)))
    px1, py1, pd = ps((nets["mx"], nets["my"], nets["mr"]),
                      torch.Generator().manual_seed(0), 4,
                      mc_set=tuple(map(torch.from_numpy, mc)),
                      init_noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    assert pd["ess"].shape == (6, 4)
    np.testing.assert_allclose(pd["ess"].numpy(), np.asarray(jd["ess"]),
                               rtol=1e-3, atol=1e-3)
    for k in ("g_x_norm", "v_y_norm"):
        np.testing.assert_allclose(pd[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_mc_feng_gamma0_equals_none(nets):
    """γ=0 mc_feng must give the unguided trajectories bit for bit (the MC
    set is drawn after the initial noise from the same generator)."""
    models = (nets["mx"], nets["my"], nets["mr"])
    out = {}
    for method in ("none", "mc_feng"):
        cfg = pg.GuidedSamplerConfig(guidance_method=method,
                                     guidance_strength=0.0, num_steps=4,
                                     mc_batch_size=6, x_shape=X_SHAPE,
                                     y_shape=Y_SHAPE)
        s = pg.make_guided_sampler_p(
            lambda m, x, t: velocity_fn(m)(x, t),
            lambda m, y, t: velocity_fn(m)(y, t), cfg,
            lambda m, x, y: ratio_log_fn(m)(x, y))
        out[method] = s(models, torch.Generator().manual_seed(5), 3)
    assert torch.equal(out["none"][0], out["mc_feng"][0])
    assert torch.equal(out["none"][1], out["mc_feng"][1])
    assert out["none"][2] == {} and out["mc_feng"][2]["ess"].shape == (4, 3)


def test_sample_bimodal_guided_and_generate_mc_set(nets):
    g = torch.Generator().manual_seed(1)
    mc = pg.generate_mc_set(nets["px"], nets["py"], nets["pr"], g, 5,
                            X_SHAPE, Y_SHAPE, num_steps=3)
    assert mc[0].shape == (5,) + X_SHAPE and (mc[2] > 0).all()
    x1, y1, d = pg.sample_bimodal_guided(
        nets["px"], nets["py"], nets["pr"], "mc_feng", 0.5, num_samples=2,
        num_steps=3, x_shape=X_SHAPE, y_shape=Y_SHAPE, mc_set=mc,
        device="cpu", return_diagnostics=True)
    assert x1.shape == (2,) + X_SHAPE and y1.shape == (2,) + Y_SHAPE
    assert torch.isfinite(x1).all() and d["ess"].shape == (3, 2)


@pytest.mark.parametrize("kw,err", [
    ({"guidance_method": "mc_feng", "solver": "heun"}, ValueError),
    ({"guidance_method": "mc_feng", "time_grid": "log"}, ValueError),
    ({"guidance_method": "mc_feng", "mc_refresh": 0}, ValueError),
    ({"guidance_method": "mc_feng+grad", "mc_refresh": 3}, ValueError),
    ({"guidance_method": "mc_feng", "mc_refresh": 2, "mc_batch_size": 2},
     ValueError),
])
def test_sampler_rejects_what_is_not_ported(kw, err):
    """Configurations the sampler refuses, as the JAX package does: heun with
    guidance, an unknown grid, mc_refresh < 1, a refresh count that does not
    divide num_steps (100), and (at the call) a caller's MC set with
    mc_refresh > 1."""
    with pytest.raises(err):
        sampler = pg.make_guided_sampler_p(
            None, None, pg.GuidedSamplerConfig(**kw), lambda m, x, y: None)
        sampler((None, None, None), torch.Generator().manual_seed(0), 1,
                mc_set=(torch.zeros((2,) + X_SHAPE),
                        torch.zeros((2,) + X_SHAPE), torch.ones(2)))
