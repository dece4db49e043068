"""The PyTorch port's SMC sampler (sample/smc.py) against the JAX package,
on the CPU (where the GroupNorm wrapper runs its plain version).

* systematic_resample_idx index for index against JAX (random weights and
  u, uniform weights, degenerate weights), flow_score to rtol 1e-6;
* the whole sampler on JAX's own draws: the test replays JAX's key schedule
  (split(key, 3); split(k, 4) per step; split(kk, 3) per mixing iteration)
  and injects the draws through `init_noise=` and `step_noise=`. Small
  nets (FlexibleUNet, 8 channels, 16 px; FlexibleRatioEstimator with
  32 features), B = 10, 8 steps, γ = 20 so that selection fires. x1 and y1
  within rtol/atol 1e-4 (the guided sampler's bound), `resampled` equal,
  the other diagnostics within rtol 1e-3;
* port-only properties as tests/test_smc.py holds them for JAX: γ = 0 with
  churn 0 is the plain Euler ode_scan, churn (and churn_iters > 1) keeps a
  Gaussian marginal, churn_iters does nothing without churn, bad solvers
  and windows are refused, the draws come from the generator in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.models import (
    FlexibleRatioEstimator as JRatio,
    FlexibleUNet as JUNet,
)
from ratio_guided_multimodal_fm_tpu.sample import smc as js
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.flow import cfm as pcfm
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    ratio_gn_state_dict,
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleRatioEstimator as PRatio,
    FlexibleUNet as PUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import smc as ps

torch.set_num_threads(2)

H = 16
X_SHAPE, Y_SHAPE = (H, H, 1), (H, H, 3)
UNET_KW = dict(img_size=H, model_channels=8, channel_mult=(1, 2),
               num_res_blocks=1, dropout=0.0)
RATIO_KW = dict(x_channels=1, y_channels=3, feature_dim=32, hidden_dim=64)
B, STEPS, GAMMA = 10, 8, 20.0


def _unets(in_ch, seed):
    jnet = JUNet(in_channels=in_ch, **UNET_KW)
    v = jax.tree_util.tree_map(np.asarray, dict(jnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, H, in_ch)),
        jnp.zeros((1,)))))
    oc = v["params"]["out_conv"]
    oc["kernel"] = (np.random.RandomState(seed).randn(*oc["kernel"].shape)
                    * 0.1).astype(np.float32)
    pnet = PUNet(in_channels=in_ch, **UNET_KW).eval()
    pnet.load_state_dict(unet_state_dict(v, channel_mult=(1, 2),
                                         num_res_blocks=1), strict=True)
    return jnet, v, pnet


@pytest.fixture(scope="module")
def nets():
    jx, vx, px = _unets(1, 0)
    jy, vy, py = _unets(3, 1)
    jr = JRatio(**RATIO_KW)
    vr = jax.tree_util.tree_map(np.asarray, dict(jr.init(
        jax.random.PRNGKey(4), jnp.zeros((1,) + X_SHAPE),
        jnp.zeros((1,) + Y_SHAPE))))
    pr = PRatio(**RATIO_KW).eval()
    pr.load_state_dict(ratio_gn_state_dict(vr), strict=True)
    jax_fns = (lambda p, x, t: jx.apply(p, x, t),
               lambda p, y, t: jy.apply(p, y, t),
               lambda p, x, y: jr.apply(p, x, y, method=jr.log_ratio))
    return dict(jax=(jax_fns, (vx, vy, vr)), port=(px, py, pr))


# ---- resampling and the score --------------------------------------------

def test_systematic_resample_idx_matches_jax():
    rng = np.random.RandomState(0)
    for b in (7, 16, 64):
        for _ in range(5):
            w = rng.rand(b).astype(np.float32) ** 3
            w /= w.sum()
            u = np.float32(rng.rand())
            want = np.asarray(js.systematic_resample_idx(jnp.asarray(w),
                                                         jnp.float32(u)))
            got = ps.systematic_resample_idx(torch.from_numpy(w),
                                             torch.tensor(u))
            np.testing.assert_array_equal(got.numpy(), want)
    # batched rows (island mode): one u per row
    w = rng.rand(3, 8).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    u = rng.rand(3).astype(np.float32)
    want = np.asarray(jax.vmap(js.systematic_resample_idx)(jnp.asarray(w),
                                                            jnp.asarray(u)))
    got = ps.systematic_resample_idx(torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("u", [0.0, 0.5, 0.999])
def test_systematic_uniform_weights_is_identity(u):
    b = 17
    got = ps.systematic_resample_idx(torch.full((b,), 1.0 / b), u)
    np.testing.assert_array_equal(got.numpy(), np.arange(b))
    want = js.systematic_resample_idx(jnp.full((b,), 1.0 / b), jnp.float32(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_systematic_degenerate_weight_collapses():
    w = torch.zeros(8)
    w[5] = 1.0
    got = ps.systematic_resample_idx(w, torch.tensor(0.42))
    np.testing.assert_array_equal(got.numpy(), np.full(8, 5))


@pytest.mark.parametrize("t", [0.0, 0.3, 0.9])
def test_flow_score_matches_jax(t):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 5, 5, 2).astype(np.float32)
    v = rng.randn(4, 5, 5, 2).astype(np.float32)
    want = np.asarray(js.flow_score(jnp.asarray(x), jnp.asarray(v), t))
    got = ps.flow_score(torch.from_numpy(x), torch.from_numpy(v), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---- the whole sampler on JAX's draws ---------------------------------------

def _jax_draws(key, cfg, b):
    """(init_noise, step_noise) as the JAX sampler draws them from `key`."""
    kx, ky, k = jax.random.split(key, 3)
    x0 = np.array(jax.random.normal(kx, (b,) + cfg.x_shape, jnp.float32))
    y0 = np.array(jax.random.normal(ky, (b,) + cfg.y_shape, jnp.float32))
    g = cfg.resample_group
    extra = max(cfg.churn_iters - 1, 0) if cfg.churn > 0 else 0
    ts, dts = jcfm.make_time_grid(cfg.num_steps, cfg.time_grid,
                                  cfg.grid_power)
    steps = []
    for t, dt in zip(np.asarray(ts), np.asarray(dts)):
        k, ku, knx, kny = jax.random.split(k, 4)
        u = (jax.random.uniform(ku, (-(-b // g),)) if g > 0
             else jax.random.uniform(ku))
        nx = ny = None
        if cfg.churn > 0:
            nx = jax.random.normal(knx, x0.shape)
            ny = jax.random.normal(kny, y0.shape)
        mix = []
        if extra and np.float32(1.0) - (t + dt) > np.float32(1e-6):
            for _ in range(extra):
                k, kjx, kjy = jax.random.split(k, 3)
                mix.append((torch.from_numpy(np.array(
                    jax.random.normal(kjx, x0.shape))), torch.from_numpy(
                        np.array(jax.random.normal(kjy, y0.shape)))))
        steps.append((np.array(u), None if nx is None else torch.from_numpy(
            np.array(nx)), None if ny is None else torch.from_numpy(
                np.array(ny)), mix))
    return (torch.from_numpy(x0), torch.from_numpy(y0)), steps


SAMPLER_CASES = {
    "global": dict(resample_group=0),
    "island_b10_g4": dict(resample_group=4),
    "island_midpoint": dict(resample_group=4, solver="midpoint"),
    "global_midpoint_churn_iters2": dict(resample_group=0, solver="midpoint",
                                         churn_iters=2),
    "island_churn_iters2": dict(resample_group=4, churn_iters=2),
    "early_grid_t_window": dict(resample_group=0, time_grid="early",
                                resample_window="t", resample_t_min=0.05),
    "early_grid_step_window": dict(resample_group=4, time_grid="early",
                                   resample_window="step"),
    "log_ratio_clip": dict(resample_group=4, log_ratio_clip=0.01),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_smc_sampler_matches_jax(nets, case):
    kw = SAMPLER_CASES[case]
    gamma = 2000.0 if "log_ratio_clip" in kw else GAMMA
    cfg_kw = dict(guidance_strength=gamma, num_steps=STEPS, x_shape=X_SHAPE,
                  y_shape=Y_SHAPE, **kw)
    jcfg = js.SMCSamplerConfig(**cfg_kw)
    (jfx, jfy, jlr), jparams = nets["jax"]
    jsampler = jax.jit(js.make_smc_sampler_p(jfx, jfy, jcfg, jlr),
                       static_argnums=(2,))
    key = jax.random.PRNGKey(7)
    jx1, jy1, jd = jsampler(jparams, key, B)
    jd = {k: np.asarray(v) for k, v in jd.items()}
    assert jd["resampled"].sum() > 0, "no resampling event: a vacuous case"

    init, steps = _jax_draws(key, jcfg, B)
    psampler = ps.make_smc_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), ps.SMCSamplerConfig(**cfg_kw),
        lambda m, x, y: ratio_log_fn(m)(x, y))
    px1, py1, pd = psampler(nets["port"], torch.Generator().manual_seed(0),
                            B, init_noise=init, step_noise=steps)
    assert np.abs(np.asarray(jx1) - init[0].numpy()).max() > 1e-2
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    assert set(pd) == set(jd)
    np.testing.assert_array_equal(pd["resampled"].numpy(), jd["resampled"])
    for k in ("smc_ess", "log_r_mean", "logw_spread", "final_ess"):
        assert pd[k].shape == jd[k].shape, k
        np.testing.assert_allclose(pd[k].numpy(), jd[k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    if "log_ratio_clip" in kw:       # the clip binds on this case
        clip = kw["log_ratio_clip"]
        assert float(pd["log_r_mean"].abs().max()) <= clip * (1 + 1e-6)
        with torch.no_grad():
            raw = ratio_log_fn(nets["port"][2])(px1, py1)
        assert float(raw.abs().max()) > clip


# ---- port-only properties ---------------------------------------------------

def _gaussian_velocity(m, s):
    """The exact rectified-flow velocity for the target N(m, s²)."""
    def v(x, t):
        t = t.reshape((-1,) + (1,) * (x.dim() - 1))
        c_t = (1 - t) ** 2 + (t * s) ** 2
        return (m + (t * s * s / c_t) * (x - t * m)
                - ((1 - t) / c_t) * (x - t * m))
    return v


def _zero_ratio(x, y):
    return torch.zeros(x.shape[0])


def test_gamma0_churn0_equals_plain_euler():
    v = _gaussian_velocity(0.5, 1.2)
    cfg = ps.SMCSamplerConfig(guidance_strength=0.0, num_steps=24,
                              x_shape=(1,), y_shape=(1,), churn=0.0)
    g = torch.Generator().manual_seed(3)
    x0, y0 = torch.randn(32, 1, generator=g), torch.randn(32, 1, generator=g)
    x1, y1, _ = ps.make_smc_sampler(v, v, cfg, _zero_ratio)(
        torch.Generator().manual_seed(0), 32, init_noise=(x0, y0))
    assert torch.equal(x1, pcfm.ode_scan(v, x0, 24))
    assert torch.equal(y1, pcfm.ode_scan(v, y0, 24))


@pytest.mark.parametrize("churn_iters", [1, 3])
def test_churn_preserves_gaussian_marginal(churn_iters):
    """γ = 0, churn 1: the Langevin-churned flow still lands on N(m, s²)
    (the score identity and β_t = churn·(1−t)², with the port's
    generator); extra pure-Langevin iterations leave it invariant."""
    m, s = -0.8, 0.7
    v = _gaussian_velocity(m, s)
    cfg = ps.SMCSamplerConfig(guidance_strength=0.0, num_steps=64,
                              x_shape=(1,), y_shape=(1,), churn=1.0,
                              churn_iters=churn_iters)
    x1, y1, _ = ps.make_smc_sampler(v, v, cfg, _zero_ratio)(
        torch.Generator().manual_seed(churn_iters), 8192)
    for out in (x1, y1):
        assert abs(float(out.mean()) - m) < 0.05, float(out.mean())
        assert abs(float(out.std()) - s) < 0.06, float(out.std())


def test_churn_iters_noop_without_churn():
    v = _gaussian_velocity(0.5, 1.2)
    outs = []
    for iters in (1, 4):
        cfg = ps.SMCSamplerConfig(guidance_strength=0.0, num_steps=12,
                                  x_shape=(1,), y_shape=(1,), churn=0.0,
                                  churn_iters=iters)
        outs.append(ps.make_smc_sampler(v, v, cfg, _zero_ratio)(
            torch.Generator().manual_seed(5), 16))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_draws_follow_the_generator_order():
    """With churn 1 and churn_iters 2 the sampler's own draws equal the
    draws of _draws-order replayed from the same seed."""
    v = _gaussian_velocity(0.0, 1.0)
    cfg = ps.SMCSamplerConfig(guidance_strength=1.0, num_steps=4,
                              x_shape=(2,), y_shape=(3,), churn=1.0,
                              churn_iters=2, resample_group=2)
    b = 5
    run = ps.make_smc_sampler(v, v, cfg, lambda x, y: x[:, 0] * y[:, 1])
    x1, y1, d = run(torch.Generator().manual_seed(9), b)
    g = torch.Generator().manual_seed(9)
    init = (torch.randn(b, 2, generator=g), torch.randn(b, 3, generator=g))
    steps = []
    ts, dts = pcfm.make_time_grid(4)
    for t, dt in zip(ts, dts):
        u = torch.rand(3, generator=g)
        nx, ny = torch.randn(b, 2, generator=g), torch.randn(b, 3, generator=g)
        mix = ([(torch.randn(b, 2, generator=g), torch.randn(b, 3,
                                                             generator=g))]
               if np.float32(1.0) - (t + dt) > np.float32(1e-6) else [])
        steps.append((u, nx, ny, mix))
    assert [len(s[3]) for s in steps] == [1, 1, 1, 0]
    x2, y2, d2 = run(torch.Generator().manual_seed(0), b, init_noise=init,
                     step_noise=steps)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert all(torch.equal(d[k], d2[k]) for k in d)


def test_island_padding_keeps_phantoms_out():
    """B = 5 with G = 4: two islands, three phantom slots; every step at
    tau 1 resamples inside the window, and only real particles are drawn
    (the output stays a gather of finite particles)."""
    v = _gaussian_velocity(0.0, 1.0)
    cfg = ps.SMCSamplerConfig(guidance_strength=3.0, num_steps=10,
                              x_shape=(1,), y_shape=(1,), churn=0.0,
                              resample_tau=1.0, resample_group=4)
    x1, y1, d = ps.make_smc_sampler(v, v, cfg,
                                    lambda x, y: (x * y)[:, 0] * 4.0)(
        torch.Generator().manual_seed(2), 5)
    assert x1.shape == (5, 1) and torch.isfinite(x1).all()
    assert float(d["resampled"].sum()) > 0
    assert 1.0 <= float(d["final_ess"]) <= 5.0


@pytest.mark.parametrize("kw", [{"solver": "heun"}, {"solver": "rk4"},
                                {"resample_window": "epoch"},
                                {"time_grid": "log"}])
def test_smc_rejects_bad_config(kw):
    with pytest.raises(ValueError):
        ps.make_smc_sampler(lambda x, t: x, lambda y, t: y,
                            ps.SMCSamplerConfig(**kw), _zero_ratio)


def test_sample_bimodal_smc_on_cpu():
    v = _gaussian_velocity(0.0, 1.0)
    x1, y1, d = ps.sample_bimodal_smc(
        v, v, lambda x, y: -((x - y) ** 2).sum(1), num_samples=6,
        num_steps=5, x_shape=(2,), y_shape=(2,), resample_group=3,
        device="cpu", return_diagnostics=True)
    assert x1.shape == (6, 2) and d["smc_ess"].shape == (5,)
    assert d["final_ess"].shape == ()
