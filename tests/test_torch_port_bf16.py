"""bf16 whole-net parity of the PyTorch port against the JAX package, on
the CPU: activations bf16, params float32, the same bridged weights and
numpy inputs.

The JAX nets run bf16 activations with float32 params, the U-Nets with
their default split_skip=True (the decoder's conv1 and skip conv as two
bf16 convolutions summed, _SplitConv); the port runs one convolution over
the materialised concat. Each case holds the port's max |error| against the
JAX float32 net to at most 1.5x the JAX bf16 net's max |error| against the
same float32 net: the port may round elsewhere, but no worse than bf16
itself does. The printed line (pytest -s) gives both errors, their ratio
and the direct port-vs-JAX bf16 difference. Cases: both U-Net families at
small width (model_channels 16, 16 px), both ratio-net families at full
width, one mc_feng Euler step of both bf16 U-Nets on injected noise and an
injected MC set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu import models as jm
from ratio_guided_multimodal_fm_tpu_torch import models as pm
from ratio_guided_multimodal_fm_tpu_torch.interop import state_dict_from_jax
from ratio_guided_multimodal_fm_tpu_torch.interop.from_jax import (
    unet_state_dict,
)

torch.set_num_threads(2)

BF16_BOUND = 1.5
H16 = 16


def _small_unet_kw(in_ch, mult):
    return dict(in_channels=in_ch, img_size=H16, model_channels=16,
                channel_mult=mult, num_res_blocks=2, dropout=0.0)


def _small_unets(in_ch, mult, seed):
    """(JAX float32 net, JAX bf16 net, variables, port bf16 net)."""
    kw = _small_unet_kw(in_ch, mult)
    j32 = jm.FlexibleUNet(**kw)
    v = jax.tree_util.tree_map(np.asarray, dict(j32.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H16, H16, in_ch)),
        jnp.zeros((1,)))))
    oc = v["params"]["out_conv"]
    oc["kernel"] = (np.random.RandomState(seed).randn(*oc["kernel"].shape)
                    * 0.1).astype(np.float32)
    port = pm.FlexibleUNet(dtype=torch.bfloat16, **kw).eval()
    port.load_state_dict(unet_state_dict(v, channel_mult=mult,
                                         num_res_blocks=2), strict=True)
    return j32, jm.FlexibleUNet(dtype=jnp.bfloat16, **kw), v, port


def _hold_bf16(name, f32, jax_bf16, port_bf16):
    f32, jb, pb = (np.asarray(a, np.float32) for a in (f32, jax_bf16,
                                                       port_bf16))
    err_j, err_p = np.abs(jb - f32).max(), np.abs(pb - f32).max()
    print(f"bf16 parity {name}: port {err_p:.4g}, JAX bf16 {err_j:.4g} "
          f"(ratio {err_p / err_j:.3f}), port-vs-JAX bf16 "
          f"{np.abs(pb - jb).max():.4g}, max |f32| {np.abs(f32).max():.3g}")
    assert err_j > 0 and np.isfinite(pb).all()
    assert err_p <= BF16_BOUND * err_j, (name, err_p, err_j)


@pytest.mark.parametrize("in_ch,mult", [(1, (1, 2)), (3, (1, 2, 2))],
                         ids=["unet_mnist_family", "unet_svhn_family"])
def test_bf16_unet_parity_against_jax(in_ch, mult):
    j32, j16, v, port = _small_unets(in_ch, mult, seed=in_ch)
    rng = np.random.RandomState(11)
    x = rng.randn(4, H16, H16, in_ch).astype(np.float32)
    t = rng.rand(4).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t)).float().permute(0, 2, 3, 1)
    _hold_bf16(f"U-Net in={in_ch} mult={mult}", j32.apply(v, x, t),
               j16.apply(v, x, t).astype(jnp.float32), got.numpy())


def _randomise_batch_stats(tree, rng):
    """Non-trivial BatchNorm running statistics (a fresh init has mean 0,
    var 1)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomise_batch_stats(v, rng)
        elif k == "mean":
            tree[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
        else:
            tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["ratio_mnist_svhn", "ratio_mnist"])
def test_bf16_ratio_parity_against_jax(kind):
    if kind == "ratio_mnist_svhn":
        shapes = [(32, 32, 1), (32, 32, 3)]
        j32, j16 = jm.RatioEstimatorMNISTSVHN(), jm.RatioEstimatorMNISTSVHN(
            dtype=jnp.bfloat16)
        v = jax.tree_util.tree_map(np.asarray, dict(j32.init(
            jax.random.PRNGKey(6), *[jnp.zeros((1,) + s) for s in shapes])))
        _randomise_batch_stats(v["batch_stats"], np.random.RandomState(7))
        port = pm.RatioEstimatorMNISTSVHN(dtype=torch.bfloat16).eval()
    else:
        shapes = [(28, 28, 1), (28, 28, 1)]
        j32, j16 = jm.RatioEstimatorMNIST(), jm.RatioEstimatorMNIST(
            dtype=jnp.bfloat16)
        v = jax.tree_util.tree_map(np.asarray, dict(j32.init(
            jax.random.PRNGKey(6), *[jnp.zeros((1,) + s) for s in shapes])))
        port = pm.RatioEstimatorMNIST(dtype=torch.bfloat16).eval()
    port.load_state_dict(state_dict_from_jax(v, kind), strict=True)
    rng = np.random.RandomState(12)
    xs = [rng.randn(4, *s).astype(np.float32) for s in shapes]
    with torch.no_grad():
        got = port.log_ratio(*[torch.from_numpy(a).permute(0, 3, 1, 2)
                               for a in xs]).float()
    _hold_bf16(kind, j32.apply(v, *xs, method=j32.log_ratio),
               j16.apply(v, *xs, method=j16.log_ratio).astype(jnp.float32),
               got.numpy())


def test_bf16_guided_step_parity_against_jax():
    """One mc_feng Euler step (γ=0.5) of both bf16 U-Nets on injected
    initial noise and an injected MC set."""
    from ratio_guided_multimodal_fm_tpu.sample import guided as jg
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import velocity_fn
    from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

    jx32, jx16, vx, px = _small_unets(1, (1, 2), seed=21)
    jy32, jy16, vy, py = _small_unets(3, (1, 2, 2), seed=22)
    rng = np.random.RandomState(13)
    sx, sy = (H16, H16, 1), (H16, H16, 3)
    noise = (rng.randn(4, *sx).astype(np.float32),
             rng.randn(4, *sy).astype(np.float32))
    mc = (rng.randn(8, *sx).astype(np.float32),
          rng.randn(8, *sy).astype(np.float32),
          np.exp(rng.randn(8)).astype(np.float32))
    kw = dict(guidance_method="mc_feng", guidance_strength=0.5, num_steps=1,
              mc_batch_size=8, x_shape=sx, y_shape=sy)

    def run_jax(jx, jy):
        s = jg.make_guided_sampler_p(
            lambda _, x, t: jx.apply(vx, x, t).astype(jnp.float32),
            lambda _, y, t: jy.apply(vy, y, t).astype(jnp.float32),
            jg.GuidedSamplerConfig(**kw))
        x1, y1, _ = s((None, None, None), jax.random.PRNGKey(0), 4,
                      mc_set=tuple(map(jnp.asarray, mc)),
                      init_noise=tuple(map(jnp.asarray, noise)))
        return np.concatenate([np.asarray(x1).ravel(),
                               np.asarray(y1).ravel()])

    ps = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), pg.GuidedSamplerConfig(**kw))
    with torch.no_grad():
        x1, y1, _ = ps((px, py, None), torch.Generator().manual_seed(0), 4,
                       mc_set=tuple(map(torch.from_numpy, mc)),
                       init_noise=tuple(map(torch.from_numpy, noise)))
    got = np.concatenate([x1.numpy().ravel(), y1.numpy().ravel()])
    _hold_bf16("mc_feng step", run_jax(jx32, jy32), run_jax(jx16, jy16), got)
