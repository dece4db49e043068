"""Experiment 1 of the PyTorch port (MNIST-28 ↔ a transformed MNIST)
against the JAX package, on the CPU.

* FlexibleRatioEstimator / RatioEstimatorMNIST: 943,745 params, the keys of
  the JAX exporter's `export_ratio_gn`, the `ratio_mnist` bridge bit for bit,
  float32 log-ratio parity (disc and rulsif) to 1e-4 with non-trivial
  GroupNorm and LayerNorm parameters;
* the MNIST-28 FlowMatchingUNet, out_conv perturbed (an empty comparison
  otherwise), to 1e-4;
* the experiment-1 sampler (`none` and `mc_feng`) at full width, B=3,
  N_mc=6, 3 Euler steps, against JAX `make_guided_sampler_p` on injected
  noise and an injected MC set whose ratios each framework's ratio net
  computes: states to 1e-4, ESS to 1e-3 (the tolerances of
  tests/test_torch_port_sampler.py);
* the experiment-1 CLI on the CPU from the .pth files the JAX exporter
  writes, its checkpoint names, and --merged_unet against the two nets.
Random streams cannot cross frameworks: inputs are made with numpy.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu.interop.torch_export import (
    export_state_dict,
)
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu.train.checkpoint import (
    get_checkpoint_path,
)
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.cli import sample
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    checkpoint_path,
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

torch.set_num_threads(2)

SHAPE = (28, 28, 1)


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _randomise_norms(tree, rng):
    """Non-trivial GroupNorm/LayerNorm params (a fresh init has scale 1,
    bias 0, which would hide a swapped or dropped affine)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if k.startswith(("gn", "ln")):
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(
                    np.float32)
                v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(
                    np.float32)
            else:
                _randomise_norms(v, rng)


def _jax_ratio(seed=0):
    v = jax.tree_util.tree_map(np.asarray, dict(jm.RatioEstimatorMNIST().init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE),
        jnp.zeros((1,) + SHAPE))))
    _randomise_norms(v["params"], np.random.RandomState(seed + 1))
    return v


def _jax_unet(seed):
    v = jax.tree_util.tree_map(np.asarray, dict(jm.FlowMatchingUNet().init(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE), jnp.zeros((1,)))))
    rng = np.random.RandomState(seed + 1)
    oc = v["params"]["out_conv"]
    oc["kernel"] = (rng.randn(*oc["kernel"].shape) * 0.1).astype(np.float32)
    oc["bias"] = (rng.randn(*oc["bias"].shape) * 0.1).astype(np.float32)
    return v


def _port(net, variables, kind):
    net.load_state_dict(state_dict_from_jax(variables, kind), strict=True)
    return net.eval()


def test_param_counts_and_alias():
    def n(m):
        return sum(p.numel() for p in m.parameters())

    assert n(pm.RatioEstimatorMNIST()) == 943_745
    assert n(pm.FlowMatchingUNet()) == 901_121
    assert pm.RatioEstimator is pm.RatioEstimatorMNIST


def test_ratio_keys_and_bridge():
    v = _jax_ratio()
    exported = export_state_dict(v, "ratio")
    bridged = state_dict_from_jax(v, "ratio_mnist")
    assert set(pm.RatioEstimatorMNIST().state_dict()) == set(exported) \
        == set(bridged)
    for k, want in exported.items():
        np.testing.assert_array_equal(bridged[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("loss_type", ["disc", "rulsif"])
def test_ratio_log_ratio_matches_jax(loss_type):
    v = _jax_ratio(seed=2)
    jnet = jm.RatioEstimatorMNIST(loss_type=loss_type)
    x, y = _np(3, *SHAPE, seed=3), _np(3, *SHAPE, seed=4)
    want = np.asarray(jnet.apply(v, jnp.asarray(x), jnp.asarray(y),
                                 method=jnet.log_ratio))
    port = _port(pm.RatioEstimatorMNIST(loss_type=loss_type), v,
                 "ratio_mnist")
    with torch.no_grad():
        got = port.log_ratio(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(y).permute(0, 3, 1, 2))
    assert np.ptp(want) > 1e-3                # the scores differ per pair
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flow_unet_28_matches_jax():
    v = _jax_unet(seed=5)
    port = _port(pm.FlowMatchingUNet(), v, "unet_mnist")
    x, t = _np(2, *SHAPE, seed=6), np.array([0.2, 0.8], np.float32)
    want = np.asarray(jm.FlowMatchingUNet().apply(v, jnp.asarray(x),
                                                  jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t)).permute(0, 2, 3, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def exp1_pair():
    """The experiment-1 models in both frameworks, same weights."""
    vx, vy, vr = _jax_unet(7), _jax_unet(8), _jax_ratio(9)
    jnet, jratio = jm.FlowMatchingUNet(), jm.RatioEstimatorMNIST()
    jax_fns = ((lambda p, x, t: jnet.apply(p, x, t)),
               (lambda r, x, y: jratio.apply(r, x, y,
                                             method=jratio.log_ratio)),
               (vx, vy, vr))
    port_models = (_port(pm.FlowMatchingUNet(), vx, "unet_mnist"),
                   _port(pm.FlowMatchingUNet(), vy, "unet_mnist"),
                   _port(pm.RatioEstimatorMNIST(), vr, "ratio_mnist"))
    return jax_fns, port_models


@pytest.mark.parametrize("method", ["none", "mc_feng"])
def test_exp1_sampler_matches_jax(exp1_pair, method):
    (j_fm, j_ratio, j_params), p_models = exp1_pair
    cfg_kw = dict(guidance_method=method, guidance_strength=0.5, num_steps=3,
                  mc_batch_size=6, x_shape=SHAPE, y_shape=SHAPE)
    noise = (_np(3, *SHAPE, seed=10), _np(3, *SHAPE, seed=11))
    mc_x1, mc_y1 = _np(6, *SHAPE, seed=12), _np(6, *SHAPE, seed=13)
    # the MC ratios through each framework's own ratio net
    j_r = jg.safe_exp_log_r(j_ratio(j_params[2], jnp.asarray(mc_x1),
                                    jnp.asarray(mc_y1)))
    with torch.no_grad():
        p_r = pg.safe_exp_log_r(ratio_log_fn(p_models[2])(
            torch.from_numpy(mc_x1), torch.from_numpy(mc_y1)))
    np.testing.assert_allclose(p_r.numpy(), np.asarray(j_r), rtol=1e-4)
    js = jg.make_guided_sampler_p(j_fm, j_fm, jg.GuidedSamplerConfig(**cfg_kw),
                                  j_ratio)
    ps = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), pg.GuidedSamplerConfig(**cfg_kw),
        lambda m, x, y: ratio_log_fn(m)(x, y))
    jx1, jy1, jd = js(j_params, jax.random.PRNGKey(0), 3,
                      mc_set=(jnp.asarray(mc_x1), jnp.asarray(mc_y1), j_r),
                      init_noise=tuple(map(jnp.asarray, noise)))
    px1, py1, pd = ps(p_models, torch.Generator().manual_seed(0), 3,
                      mc_set=(torch.from_numpy(mc_x1),
                              torch.from_numpy(mc_y1), p_r),
                      init_noise=tuple(map(torch.from_numpy, noise)))
    assert np.abs(np.asarray(jx1) - noise[0]).max() > 1e-2
    np.testing.assert_allclose(px1.numpy(), np.asarray(jx1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(py1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-4)
    if method == "mc_feng":
        assert pd["ess"].shape == (3, 3)
        np.testing.assert_allclose(pd["ess"].numpy(), np.asarray(jd["ess"]),
                                   rtol=1e-3, atol=1e-3)
    else:
        assert pd == {}


def test_checkpoint_names_match_jax(tmp_path):
    for parts in [("flow", "x", None, None, None, "best"),
                  ("flow", "y", "rotate90", "reflow", "ema", "best"),
                  ("ratio", "rulsif", "flip", "ema", "best")]:
        assert checkpoint_path(*parts, base_dir=str(tmp_path)) == \
            get_checkpoint_path(*parts, base_dir=str(tmp_path)) + ".pth"


def _write_exported_checkpoints(root, transform="rotate90"):
    """Random-init JAX models exported to reference-layout .pth files, as
    `rgmf-export-torch --out` writes them."""
    (root / "checkpoints").mkdir()
    specs = [("flow_x_best.pth", "unet_mnist", _jax_unet(0)),
             (f"flow_y_{transform}_best.pth", "unet_mnist", _jax_unet(1)),
             (f"ratio_disc_{transform}_best.pth", "ratio", _jax_ratio(2))]
    for fname, kind, variables in specs:
        sd = export_state_dict(variables, kind)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   root / "checkpoints" / fname)


def test_exp1_cli_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="checkpoint not found"):
        sample.main(["--device", "cpu", "--num_steps", "1"])
    _write_exported_checkpoints(tmp_path)
    x1, y1, diags = sample.main([
        "--device", "cpu", "--guidance_method", "mc_feng",
        "--num_samples", "2", "--num_steps", "2", "--mc_batch_size", "3"])
    assert x1.shape == y1.shape == (2,) + SHAPE
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    rows = json.loads((tmp_path / "outputs" /
                       "diagnostics_mc_feng_gamma0.5_rotate90.json")
                      .read_text())
    assert len(rows) == 2 and "ess_mean" in rows[1]
    png = tmp_path / "outputs" / "samples_mc_feng_gamma0.5_rotate90.png"
    assert os.path.exists(png) or _no_matplotlib()
    x1, _, diags = sample.main(["--device", "cpu", "--num_samples", "2",
                                "--num_steps", "2"])
    assert diags == {} and x1.shape == (2,) + SHAPE


@pytest.fixture(scope="module")
def exported_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("exported")
    _write_exported_checkpoints(root)
    return root


@pytest.mark.parametrize("method", ["none", "mc_feng"])
def test_exp1_cli_merged_unet(method, exported_dir, monkeypatch):
    """--merged_unet evaluates both exported U-Nets as one merged network:
    the same seed gives the two-net run's samples (f32, atol 5e-5, the
    bound of the JAX package's tests/test_merged_unet.py)."""
    monkeypatch.chdir(exported_dir)
    argv = ["--device", "cpu", "--num_samples", "2", "--num_steps", "2",
            "--mc_batch_size", "3", "--guidance_method", method]
    two = sample.main(argv)
    merged = sample.main(argv + ["--merged_unet"])
    for a, b in zip(two[:2], merged[:2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("argv", [
    ["--guidance_method", "grad"],
    ["--guidance_method", "mc_feng+grad", "--mc_refresh", "2"],
    ["--guidance_method", "mc_feng", "--mc_refresh", "2"]])
def test_exp1_cli_grad_and_mc_refresh(argv, exported_dir, monkeypatch):
    """The grad methods and fresh MC sets along the trajectory run from the
    exported checkpoints (the full-width GroupNorm ratio net, so the
    GroupNorm+SiLU backward's plain version)."""
    monkeypatch.chdir(exported_dir)
    x1, y1, diags = sample.main(["--device", "cpu", "--num_samples", "2",
                                 "--num_steps", "2", "--mc_batch_size", "3"]
                                + argv)
    assert x1.shape == y1.shape == (2,) + SHAPE
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    assert (diags == {}) == (argv[1] == "grad")


@pytest.mark.parametrize("argv", [
    [],
    ["--smc_group", "0", "--solver", "midpoint"],
    ["--smc_churn_iters", "2", "--smc_resample_tau", "1.0",
     "--ratio_clip", "3.0"]])
def test_exp1_cli_smc(argv, exported_dir, monkeypatch):
    """smc from the exported checkpoints (the full-width GroupNorm ratio net
    on the endpoint predictions), its per-step diagnostics in the trace."""
    monkeypatch.chdir(exported_dir)
    x1, y1, diags = sample.main(["--device", "cpu", "--guidance_method",
                                 "smc", "--num_samples", "3", "--num_steps",
                                 "3"] + argv)
    assert x1.shape == y1.shape == (3,) + SHAPE
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    assert diags["smc_ess"].shape == (3,) and diags["final_ess"].shape == ()
    assert 1.0 <= float(diags["final_ess"]) <= 3.0 + 1e-4
    rows = json.loads((exported_dir / "outputs" /
                       "diagnostics_smc_gamma0.5_rotate90.json").read_text())
    assert len(rows) == 3 and {"smc_ess", "resampled", "log_r_mean",
                               "logw_spread"} <= set(rows[1])


def _no_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return True
    return False
