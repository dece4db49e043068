"""The PyTorch port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against the JAX function the kernel replaces, run as the JAX package's own
tests run it (Pallas in interpret mode) and against the JAX XLA path:

* ops/guidance.py:flash_guidance  vs  ops/guidance_pallas.py:flash_guidance
  and sample/guided.py:mc_feng_guidance — rtol 1e-3, atol 1e-4 (the Pallas
  kernel's own bound, tests/test_pallas_guidance.py).
* ops/groupnorm.py:group_norm_silu  vs  ops/groupnorm_pallas.py and
  models/layers.py:FusedGroupNorm — 1e-4 in float32; in bfloat16 one
  bfloat16 step (rtol 2**-7, atol 1e-3) against the XLA path, which rounds
  the affine output before SiLU as the port does, and 0.05 against the
  Pallas kernel, which rounds once (tests/test_fused_groupnorm.py).

The kernels themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.models.layers import FusedGroupNorm
from ratio_guided_multimodal_fm_tpu.ops.groupnorm_pallas import (
    group_norm_silu as jax_group_norm_silu,
)
from ratio_guided_multimodal_fm_tpu.ops.guidance_pallas import (
    flash_guidance as jax_flash_guidance,
)
from ratio_guided_multimodal_fm_tpu.sample.guided import (
    mc_feng_guidance as jax_mc_feng_guidance,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import group_norm_silu
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import flash_guidance

torch.set_num_threads(2)

TOL_G = dict(rtol=1e-3, atol=1e-4)


def _guidance_inputs(B, N, H=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, H, 1).astype(np.float32),
            rng.randn(B, H, H, 2).astype(np.float32),
            rng.randn(N, H, H, 1).astype(np.float32),
            rng.randn(N, H, H, 2).astype(np.float32),
            rng.randn(N).astype(np.float32))


def _check_guidance_against_jax(arrays, t, **jax_kw):
    j = [jnp.asarray(a) for a in arrays]
    gx_k, gy_k, ess_k, l_k = jax_flash_guidance(*j, jnp.float32(t),
                                                interpret=True, **jax_kw)
    gx_r, gy_r, diag = jax_mc_feng_guidance(j[0], j[1], j[2], j[3],
                                            jnp.exp(j[4]), jnp.float32(t))
    before = flash_guidance.launches
    gx, gy, ess, l = flash_guidance(*[torch.from_numpy(a) for a in arrays],
                                    t)
    assert flash_guidance.launches == before    # CPU: plain version
    assert gx.shape == arrays[0].shape and gy.shape == arrays[1].shape
    for got, want in ((gx, gx_k), (gy, gy_k), (gx, gx_r), (gy, gy_r),
                      (ess, ess_k), (ess, diag["ess"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_G)
    # l and the largest weight 1/l: loose, as in the JAX package's own test
    # (XLA may recompute the scores with another FMA fusion between the max
    # and the subtraction — a ~1 ulp |s| artifact at large |s|)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_k), rtol=5e-3)
    np.testing.assert_allclose(float((1.0 / l).max()), float(diag["w_max"]),
                               rtol=5e-3)


@pytest.mark.parametrize("t", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("B,N", [(4, 16), (64, 128), (5, 100)])
def test_flash_guidance_matches_jax(B, N, t):
    _check_guidance_against_jax(_guidance_inputs(B, N), t)


def test_flash_guidance_multi_tile_matches_jax():
    """N over several JAX tiles with a wide log-ratio spread, so the online
    softmax rescales across tiles on the JAX side."""
    x_t, y_t, mc_x1, mc_y1, log_r = _guidance_inputs(8, 300, seed=3)
    _check_guidance_against_jax((x_t, y_t, mc_x1, mc_y1, log_r * 5.0), 0.7,
                                tile_n=128)


def _gn_inputs(C, B=5, H=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, H, C).astype(np.float32),
            rng.uniform(0.5, 1.5, C).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32))


def _port_gn(x_nhwc, scale, bias, g, dtype=torch.float32):
    x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    before = group_norm_silu.launches
    y = group_norm_silu(x, torch.from_numpy(scale), torch.from_numpy(bias), g)
    assert group_norm_silu.launches == before    # CPU: plain version
    assert y.dtype == dtype
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("C,g", [(64, 8), (32, 8), (128, 8), (8, 8)])
def test_group_norm_silu_matches_jax(C, g):
    x, scale, bias = _gn_inputs(C)
    got = _port_gn(x, scale, bias, g)
    pallas = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), g, interpret=True)
    xla = FusedGroupNorm(num_groups=g, fuse_silu=True).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-4, atol=1e-4)


def test_group_norm_silu_bf16_matches_jax():
    x, scale, bias = _gn_inputs(64)
    got = _port_gn(x, scale, bias, 8, dtype=torch.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = jax_group_norm_silu(xb, jnp.asarray(scale), jnp.asarray(bias), 8,
                                 interpret=True)
    xla = FusedGroupNorm(num_groups=8, fuse_silu=True,
                         dtype=jnp.bfloat16).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        xb)
    np.testing.assert_allclose(got, np.asarray(xla).astype(np.float32),
                               rtol=2**-7, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(pallas).astype(np.float32),
                               rtol=0.05, atol=0.05)


def test_group_norm_silu_bf16_statistics_do_not_depend_on_the_order():
    """The plain version takes exact (float64) group sums, so permuting the
    pixels of every sample permutes its bfloat16 output bit for bit: the
    order-free statistics the kernel shares with it (csrc/gn_common.cuh)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 64, 16, 16).astype(np.float32) * 2.0
                         + 0.5).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    bias = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(256))
    y = group_norm_silu(x, scale, bias, 8).reshape(4, 64, 256)[..., perm]
    xp = x.reshape(4, 64, 256)[..., perm].reshape(4, 64, 16, 16)
    yp = group_norm_silu(xp, scale, bias, 8).reshape(4, 64, 256)
    assert torch.equal(y, yp)


@pytest.mark.parametrize("C,H", [(32, 28), (64, 14), (128, 7)])
def test_gn_statistics_divide_in_ieee_arithmetic(C, H):
    """The kernel rounds the IEEE float64 quotient s / n to float32 (csrc/
    gn_common.cuh:gn_finalize). The plain version must divide the same way
    on every device: a product with the reciprocal 1/n, which is how
    PyTorch divides a CUDA tensor by a Python scalar, moves the float32
    rounding of the means whose quotient is a float32 tie where n is not a
    power of 2 (~1 in 10^4 groups of these bf16 inputs)."""
    from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
        gn_stats_reference,
    )

    rng = np.random.RandomState(C + H)
    x = torch.from_numpy(rng.randn(512, C, H, H).astype(np.float32) * 2.0
                         + 0.5).to(torch.bfloat16)
    n = C // 8 * H * H
    s = x.double().reshape(512, 8, n).sum(-1).numpy()
    mean, _ = gn_stats_reference(x, 8)
    np.testing.assert_array_equal(mean.numpy(), (s / n).astype(np.float32))
    # where s / n is a float32 tie (25 significant bits), the quotient rounds
    # to even and the product with the reciprocal, an ulp off, to either side
    m = (2 * rng.randint(2**23, 2**24, 256).astype(np.float64) + 1) \
        * 2.0**-25
    ties = n * m
    assert np.array_equal(ties / n, m)
    assert ((ties / n).astype(np.float32)
            != (ties * (1.0 / n)).astype(np.float32)).any()


def test_group_norm_silu_channels_last_input():
    """The U-Nets hand the kernel channels_last tensors; the plain version
    must not depend on the memory layout either."""
    x, scale, bias = _gn_inputs(32, seed=1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)      # channels_last view
    assert xt.is_contiguous(memory_format=torch.channels_last)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), 8)
    torch.testing.assert_close(group_norm_silu(xt, *args),
                               group_norm_silu(xt.contiguous(), *args))


def test_wrappers_raise_on_other_devices():
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises — it never falls back."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_silu(torch.empty(2, 16, 4, 4, **meta),
                        torch.empty(16, **meta), torch.empty(16, **meta), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_guidance(torch.empty(2, 4, 4, 1, **meta),
                       torch.empty(2, 4, 4, 3, **meta),
                       torch.empty(5, 4, 4, 1, **meta),
                       torch.empty(5, 4, 4, 3, **meta),
                       torch.empty(5, **meta), 0.5)


def test_wrappers_check_their_inputs():
    x = torch.randn(2, 4, 4, 1)
    y = torch.randn(2, 4, 4, 3)
    with pytest.raises(TypeError):
        flash_guidance(x.double(), y, x, y, torch.zeros(2), 0.5)
    with pytest.raises(ValueError, match="shapes"):
        flash_guidance(x, y, x, y, torch.zeros(3), 0.5)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm_silu(torch.randn(1, 12, 2, 2), torch.ones(12),
                        torch.zeros(12), 8)

