"""Merged-pair evaluation of the PyTorch port (models/merged.py, the
sampler's fm_pair hooks, flow/cfm.py:ode_scan_pair) against the two port
nets and against the JAX package, on the CPU: the counterpart of each case
of the JAX package's tests/test_merged_unet.py, plus ode_scan_pair against
JAX's for every solver.

Tolerances: merged against the two nets of the same framework 2e-5 (the
JAX tests' bound; the same float32 convolutions, grouped); against JAX's
merged function (the experiment-1 U-Net; the deeper topologies against
the port's two nets) 1e-4 (float32 convolutions in two frameworks, as
tests/test_torch_port_sampler.py); samplers through both phases 5e-5
(JAX's bound for its own merged sampler); ode_scan_pair rtol 1e-6 (the
same float32 operations on an analytic field). out_conv is perturbed in
every net (zero-initialised otherwise, which would compare zeros).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.flow import cfm as jcfm
from ratio_guided_multimodal_fm_tpu.models import merged as jmerged
from ratio_guided_multimodal_fm_tpu.models.unet import FlexibleUNet as JUNet
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    maybe_merged_pair_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.flow import cfm as pcfm
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleUNet as PUNet,
    FlowMatchingModel,
    FlowMatchingUNet,
    FlowMatchingUNetSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
    can_merge,
    make_merged_velocity_fn,
    merge_unet_params,
    merged_pair_apply,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

torch.set_num_threads(2)


def _pair(kw, seed=0):
    """(JAX net, [variables x, variables y], [port net x, port net y]) with
    the same perturbed weights in both frameworks."""
    jnet = JUNet(**kw)
    hw, cin = kw["img_size"], kw["in_channels"]
    vs, nets = [], []
    for s in (seed, seed + 1):
        v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jnet.init)(
            jax.random.PRNGKey(s), jnp.zeros((1, hw, hw, cin)),
            jnp.zeros((1,)))))
        rng = np.random.RandomState(s + 10)
        oc = v["params"]["out_conv"]
        oc["kernel"] = (rng.randn(*oc["kernel"].shape) * 0.1).astype(
            np.float32)
        oc["bias"] = (rng.randn(*oc["bias"].shape) * 0.1).astype(np.float32)
        net = PUNet(**kw).eval()
        net.load_state_dict(unet_state_dict(
            v, channel_mult=kw["channel_mult"],
            num_res_blocks=kw.get("num_res_blocks", 2)), strict=True)
        vs.append(v)
        nets.append(net)
    return jnet, vs, nets


def _xyt(b, hw, cin, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hw, hw, cin).astype(np.float32),
            rng.randn(b, hw, hw, cin).astype(np.float32),
            np.linspace(0.1, 0.9, b).astype(np.float32))


def _hold(port_merged, port_two, jax_merged, atol_jax=1e-4):
    for m, two, j in zip(port_merged, port_two, jax_merged):
        m, two = m.numpy(), two.numpy()
        assert np.abs(two).max() > 1e-3
        np.testing.assert_allclose(m, two, rtol=0, atol=2e-5)
        np.testing.assert_allclose(m, np.asarray(j), rtol=0, atol=atol_jax)


def _port_pair(kw, seed=0):
    """Two seeded port nets, out_conv perturbed (port-only cases: the
    parity net above holds the port's nets to JAX's)."""
    nets = []
    for s in (seed, seed + 1):
        torch.manual_seed(s)
        net = PUNet(**kw).eval()
        with torch.no_grad():
            net.out_conv.weight.normal_(0.0, 0.1)
            net.out_conv.bias.normal_(0.0, 0.1)
        nets.append(net)
    return nets


def _run(kw, b, seed=0):
    """The port's merged net (merged once, and bound) against its two
    nets."""
    nx, ny = _port_pair(kw, seed)
    xt, yt, tt = map(torch.from_numpy, _xyt(b, kw["img_size"],
                                            kw["in_channels"]))
    with torch.no_grad():
        two = (velocity_fn(nx)(xt, tt), velocity_fn(ny)(yt, tt))
        merged = make_merged_velocity_fn(nx)(
            merge_unet_params(nx.state_dict(), ny.state_dict()), xt, yt, tt)
        bound = merged_pair_apply(nx)(nx, ny)(xt, yt, tt)
    for a, c, w in zip(merged, bound, two):
        assert torch.equal(a, c)
        assert w.abs().max() > 1e-3
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("split_skip", [True, False])
def test_merged_equals_separate_parity_net(split_skip):
    """The experiment-1 U-Net (28 px, ch 32, mult (1, 2)) at B=4: the port's
    merged net against its two nets and JAX's merged function (JAX's nets
    in both skip formulations)."""
    kw = dict(in_channels=1, img_size=28, model_channels=32,
              channel_mult=(1, 2), num_res_blocks=2)
    jnet, (vx, vy), (nx, ny) = _pair(kw)
    x, y, t = _xyt(4, 28, 1)
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    with torch.no_grad():
        two = (velocity_fn(nx)(xt, tt), velocity_fn(ny)(yt, tt))
        merged = merged_pair_apply(nx)(nx, ny)(xt, yt, tt)
    jn = JUNet(split_skip=split_skip, **kw)
    jm = jax.jit(jmerged.make_merged_velocity_fn(jn))(
        jmerged.merge_unet_params(vx["params"], vy["params"]), x, y, t)
    _hold(merged, two, jm)
    apply = jax.jit(jn.apply)
    for jv, v in ((apply(vx, x, t), two[0]), (apply(vy, y, t), two[1])):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-4)


def test_merged_three_level_net():
    """Deeper topology (SVHN shape): 3 levels, channel mult (1, 2, 2)."""
    _run(dict(in_channels=3, img_size=32, model_channels=16,
              channel_mult=(1, 2, 2), num_res_blocks=2), 2)


def test_merged_four_level_64px_net():
    """The 64-px stretch topology (mult (1, 2, 2, 4)) at a narrow width."""
    _run(dict(in_channels=3, img_size=64, model_channels=8,
              channel_mult=(1, 2, 2, 4), num_res_blocks=2), 2)


def test_merge_unet_params_layout():
    """Conv weights concatenate on the out axis, dense weights and biases
    stack [2, ...], GroupNorm affines and conv biases concatenate; with a
    dtype every tensor but the GroupNorm affine is cast."""
    a, b = FlowMatchingUNet(), FlowMatchingUNet()
    m = merge_unet_params(a.state_dict(), b.state_dict(), torch.bfloat16)
    assert m["input_conv.weight"].shape == (64, 1, 3, 3)
    assert m["time_embed.0.weight"].shape == (2, 128, 32)
    assert m["encoder_blocks.0.time_mlp.1.bias"].shape == (2, 32)
    assert m["encoder_blocks.0.norm1.weight"].shape == (64,)
    assert m["encoder_blocks.0.norm1.weight"].dtype == torch.float32
    assert m["out_norm.bias"].dtype == torch.float32
    assert m["encoder_blocks.0.conv1.bias"].dtype == torch.bfloat16
    assert torch.equal(m["input_conv.weight"][32:].float(),
                       b.input_conv.weight.to(torch.bfloat16).float())


def test_can_merge_rejects_mismatched_topology():
    assert can_merge(FlowMatchingUNet(), FlowMatchingUNet())
    assert not can_merge(FlowMatchingUNet(), FlowMatchingUNetSVHN())
    assert not can_merge(FlowMatchingUNet(), object())
    assert not can_merge(FlowMatchingModel(), FlowMatchingModel())


def _small_models(seed=0):
    kw = dict(in_channels=1, img_size=8, model_channels=8,
              channel_mult=(1, 2), num_res_blocks=1)
    return _pair(kw, seed)


def _log_ratio(a, b):
    return (a * b).sum(dim=(1, 2, 3))


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_sampler_merged_path_matches_separate(solver):
    """sample_bimodal_guided with fm_pair_fn against the two-net path
    through both phases (phase A's MC set drawn inside, the same generator
    draws in the same order), mc_feng γ = 0.7, B=4, N_mc=8, 6 steps."""
    _, _, (nx, ny) = _small_models()
    fpair = merged_pair_apply(nx)(nx, ny)
    kw = dict(log_ratio_fn=_log_ratio, guidance_method="mc_feng",
              guidance_strength=0.7, num_samples=4, num_steps=6,
              mc_batch_size=8, x_shape=(8, 8, 1), y_shape=(8, 8, 1),
              solver=solver, device="cpu", return_diagnostics=True)
    with torch.no_grad():
        ref = pg.sample_bimodal_guided(velocity_fn(nx), velocity_fn(ny),
                                       **kw)
        got = pg.sample_bimodal_guided(velocity_fn(nx), velocity_fn(ny),
                                       fm_pair_fn=fpair, **kw)
    for a, b in zip(got[:2], ref[:2]):
        assert np.abs(b.numpy()).max() > 0.1
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(got[2]["ess"].numpy(), ref[2]["ess"].numpy(),
                               rtol=1e-4)


def test_merged_sampler_matches_jax_merged_sampler():
    """make_guided_sampler_p with fm_pair_apply against JAX's with
    fm_pair_apply, on injected noise and MC set (phase B): 1e-4."""
    jnet, (vx, vy), (nx, ny) = _small_models(3)
    rng = np.random.RandomState(5)
    noise = tuple(rng.randn(4, 8, 8, 1).astype(np.float32) for _ in "xy")
    mc = (rng.randn(8, 8, 8, 1).astype(np.float32),
          rng.randn(8, 8, 8, 1).astype(np.float32),
          np.exp(rng.randn(8)).astype(np.float32))
    cfg_kw = dict(guidance_method="mc_feng", guidance_strength=0.7,
                  num_steps=6, mc_batch_size=8, x_shape=(8, 8, 1),
                  y_shape=(8, 8, 1))
    js = jg.make_guided_sampler_p(
        lambda p, x, t: jnet.apply(p, x, t),
        lambda p, y, t: jnet.apply(p, y, t),
        jg.GuidedSamplerConfig(**cfg_kw),
        lambda _, a, b: jnp.sum(a * b, axis=(1, 2, 3)),
        fm_pair_apply=lambda px, py, x, y, t: jmerged.merged_pair_apply(
            jnet)(px["params"], py["params"], x, y, t))
    jx, jy, _ = js((vx, vy, None), jax.random.PRNGKey(0), 4,
                   mc_set=tuple(map(jnp.asarray, mc)),
                   init_noise=tuple(map(jnp.asarray, noise)))
    ps = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t),
        pg.GuidedSamplerConfig(**cfg_kw), lambda _, a, b: _log_ratio(a, b),
        fm_pair_apply=merged_pair_apply(nx))
    px, py, _ = ps((nx, ny, None), torch.Generator().manual_seed(0), 4,
                   mc_set=tuple(map(torch.from_numpy, mc)),
                   init_noise=tuple(map(torch.from_numpy, noise)))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)


def test_merged_sampler_refuses_unequal_shapes():
    with pytest.raises(ValueError, match="x_shape == y_shape"):
        pg.make_guided_sampler_p(
            None, None, pg.GuidedSamplerConfig(x_shape=(8, 8, 1),
                                               y_shape=(8, 8, 3)),
            fm_pair_apply=lambda a, b: None)


def test_maybe_merged_pair_fn_gating():
    """Merged evaluation is opt-in (--merged_unet), refuses mismatched
    topologies, and when enabled returns a working closure."""
    _, _, (nx, ny) = _small_models()
    assert maybe_merged_pair_fn(nx, ny, None) is None
    assert maybe_merged_pair_fn(nx, ny,
                                argparse.Namespace(merged_unet=False)) is None
    assert maybe_merged_pair_fn(nx, FlowMatchingUNetSVHN(),
                                argparse.Namespace(merged_unet=True)) is None
    f = maybe_merged_pair_fn(nx, ny, argparse.Namespace(merged_unet=True))
    x, _, t = map(torch.from_numpy, _xyt(2, 8, 1))
    with torch.no_grad():
        vx, vy = f(x, x, t)
        for v, net in ((vx, nx), (vy, ny)):
            np.testing.assert_allclose(v.numpy(),
                                       velocity_fn(net)(x, t).numpy(),
                                       rtol=0, atol=2e-5)


def test_merged_respects_norm_eps():
    """Nets built with norm_eps=1e-5 (torch-exact imports) merge with that
    eps, and nets whose epsilons differ do not merge."""
    kw = dict(in_channels=1, img_size=16, model_channels=8,
              channel_mult=(1, 2), num_res_blocks=1, norm_eps=1e-5)
    assert not can_merge(PUNet(**kw), PUNet(**dict(kw, norm_eps=1e-6)))
    _run(kw, 2)
    nx, ny = _port_pair(kw)
    x, y, t = map(torch.from_numpy, _xyt(2, 16, 1))
    with torch.no_grad():
        vx = merged_pair_apply(nx)(nx, ny)(x, y, t)[0]
        nx.norm_eps = 1e-6            # the eps the merged net reads
        vx6 = merged_pair_apply(nx)(nx, ny)(x, y, t)[0]
    assert not torch.equal(vx, vx6)


def _pair_field_j(x, y, t):
    tb = t[:, None, None, None]
    return -x + tb * jnp.sin(y), 0.5 * y - tb * x


def _pair_field_p(x, y, t):
    tb = t[:, None, None, None]
    return -x + tb * torch.sin(y), 0.5 * y - tb * x


@pytest.mark.parametrize("solver", ["euler", "midpoint", "heun"])
def test_ode_scan_pair_matches_jax(solver):
    """Both grids that differ in arithmetic ('uniform' and 'late'), 7
    steps, an analytic field that couples the two states."""
    rng = np.random.RandomState(9)
    x0, y0 = (rng.randn(3, 4, 4, 2).astype(np.float32) for _ in "xy")
    for grid in ("uniform", "late"):
        jx, jy = jcfm.ode_scan_pair(_pair_field_j, jnp.asarray(x0),
                                    jnp.asarray(y0), 7, solver=solver,
                                    grid=grid)
        px, py = pcfm.ode_scan_pair(_pair_field_p, torch.from_numpy(x0),
                                    torch.from_numpy(y0), 7, solver, grid)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)


def test_ode_scan_pair_equals_two_solo_scans():
    """An uncoupled pair field integrates as the two solo scans do, bit for
    bit, and an unknown solver is refused."""
    rng = np.random.RandomState(4)
    x0, y0 = (torch.from_numpy(rng.randn(2, 3, 3, 1).astype(np.float32))
              for _ in "xy")

    def fx(x, t):
        return torch.cos(x) * t[:, None, None, None]

    def fy(y, t):
        return -y

    for solver in ("euler", "midpoint", "heun"):
        px, py = pcfm.ode_scan_pair(lambda x, y, t: (fx(x, t), fy(y, t)),
                                    x0, y0, 5, solver)
        assert torch.equal(px, pcfm.ode_scan(fx, x0, 5, solver))
        assert torch.equal(py, pcfm.ode_scan(fy, y0, 5, solver))
    with pytest.raises(ValueError, match="solver"):
        pcfm.ode_scan_pair(lambda x, y, t: (x, y), x0, y0, 2, "rk4")
