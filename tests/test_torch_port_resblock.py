"""Kernel C of the PyTorch port (ops/resblock.py:fused_gn_silu_conv)
against the JAX package, on the CPU, where the wrapper runs its plain
version. The JAX side runs as tests/test_resblock_pallas.py runs it: the
Pallas kernel in interpret mode, and the XLA reference.

Tolerances are that file's: 2e-4 in float32; bfloat16 against the float32
reference at rtol 0.1 / atol 0.15. The bfloat16 port and the bfloat16
Pallas kernel round at the same points, so they are also held to one
bfloat16 step of the output (|out| < 8: atol 0.05). The kernel itself is
held against the plain version on the card by tests/test_torch_port_cuda.py
and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu.ops.resblock_pallas import (
    fused_gn_silu_conv as jax_fused_gn_silu_conv,
)
from ratio_guided_multimodal_fm_tpu.ops.resblock_pallas import (
    reference_gn_silu_conv,
)
from ratio_guided_multimodal_fm_tpu_torch.cli import resblock_kernel_bench
from ratio_guided_multimodal_fm_tpu_torch.models.layers import ResBlock
from ratio_guided_multimodal_fm_tpu_torch.ops import (
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)

torch.set_num_threads(2)


def _inputs(B, H, W, C, O, seed=0):
    """x [B,H,W,C], GN scale/bias [C], HWIO weights, conv bias (numpy)."""
    r = np.random.RandomState(seed)
    return [r.randn(B, H, W, C).astype(np.float32),
            (1.0 + 0.1 * r.randn(C)).astype(np.float32),
            (0.1 * r.randn(C)).astype(np.float32),
            (0.2 * r.randn(3, 3, C, O)).astype(np.float32),
            (0.1 * r.randn(O)).astype(np.float32)]


def _port(arrays, groups, dtype=torch.float32):
    x, *params = [torch.from_numpy(a) for a in arrays]
    before = fused_gn_silu_conv.launches
    out = fused_gn_silu_conv(x.to(dtype), *params, groups)
    assert fused_gn_silu_conv.launches == before      # CPU: plain version
    assert out.dtype == dtype
    return out.float().numpy()


def _jax(arrays, groups, dtype=jnp.float32):
    x, *params = [jnp.asarray(a) for a in arrays]
    pallas = jax_fused_gn_silu_conv(x.astype(dtype), *params, groups=groups,
                                    tile_b=2, interpret=True)
    return (np.asarray(pallas, np.float32),
            np.asarray(reference_gn_silu_conv(x, *params, groups=groups)))


@pytest.mark.parametrize("shape,groups", [((4, 8, 8, 16, 16), 4),
                                          ((3, 8, 4, 8, 24), 4),
                                          ((5, 4, 4, 8, 8), 2)])
def test_matches_jax_f32(shape, groups):
    """The JAX test's shapes: square and H != W, O != C, and B=5, which
    the Pallas kernel pads to its batch tile."""
    arrays = _inputs(*shape)
    got = _port(arrays, groups)
    B, H, W, _, O = shape
    assert got.shape == (B, H, W, O)
    for want in _jax(arrays, groups):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_matches_jax():
    arrays = _inputs(2, 8, 8, 16, 16, seed=1)
    got = _port(arrays, 4, torch.bfloat16)
    pallas_bf16, xla_f32 = _jax(arrays, 4, jnp.bfloat16)
    np.testing.assert_allclose(got, xla_f32, rtol=0.1, atol=0.15)
    assert np.abs(xla_f32).max() < 8.0
    np.testing.assert_allclose(got, pallas_bf16, rtol=0, atol=0.05)


def test_rejects_bad_shapes():
    x, *params = [torch.from_numpy(a) for a in _inputs(2, 4, 4, 8, 8)]
    with pytest.raises(ValueError, match="not divisible"):
        fused_gn_silu_conv(x, *params, 3)
    with pytest.raises(ValueError, match=r"conv_w must be \[3,3,8,O\]"):
        fused_gn_silu_conv(x, params[0], params[1], torch.zeros(5, 5, 8, 8),
                           params[3], 2)
    with pytest.raises(TypeError):
        fused_gn_silu_conv(x.double(), *params, 2)
    with pytest.raises(ValueError, match="conv_b"):
        fused_gn_silu_conv(x, *params[:3], torch.zeros(7), 2)


def test_raises_on_other_devices():
    """CPU tensors take the plain version; any other device launches the
    kernel or raises, never falls back."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gn_silu_conv(torch.empty(2, 4, 4, 8, **meta),
                           torch.empty(8, **meta), torch.empty(8, **meta),
                           torch.empty(3, 3, 8, 8, **meta),
                           torch.empty(8, **meta), 2)


def test_equals_the_port_resblock_first_half():
    """fused_gn_silu_conv with a port ResBlock's norm1/conv1 params (the
    OIHW weight permuted to HWIO) equals rb.conv1(rb.norm1(x)); the NHWC
    view of a channels_last activation needs no copy."""
    torch.manual_seed(0)
    rb = ResBlock(32, 48, time_dim=16).eval()
    with torch.no_grad():
        rb.norm1.weight.uniform_(0.5, 1.5)
        rb.norm1.bias.normal_(0.0, 0.1)
    x = torch.randn(3, 32, 8, 8).contiguous(memory_format=torch.channels_last)
    x_nhwc = x.permute(0, 2, 3, 1)
    assert x_nhwc.is_contiguous()
    with torch.no_grad():
        want = rb.conv1(rb.norm1(x))
        got = fused_gn_silu_conv(
            x_nhwc, rb.norm1.weight, rb.norm1.bias,
            rb.conv1.weight.permute(2, 3, 1, 0).contiguous(), rb.conv1.bias,
            rb.norm1.num_groups)
    assert want.abs().max() > 0.5
    # the same float32 arithmetic; only SiLU's formula differs, by ulps
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=1e-5,
                               atol=1e-5)


def test_same_padding_pads_the_activation():
    """An out-of-image tap contributes 0, not silu(affine(-mean·rstd)):
    with the weights of only the top-left tap, the first row and column of
    the output are exactly the bias."""
    x, sc, bi, w, cb = [torch.from_numpy(a) for a in _inputs(2, 5, 6, 8, 4)]
    w = torch.zeros_like(w)
    w[0, 0] = 1.0                     # tap (dh, dw) = (-1, -1)
    out = fused_gn_silu_conv_reference(x, sc, bi, w, cb, 2)
    torch.testing.assert_close(out[:, 0], cb.expand(2, 6, 4))
    torch.testing.assert_close(out[:, :, 0], cb.expand(2, 5, 4))
    assert (out[:, 1:, 1:] - cb).abs().min() > 0


def test_bench_cli_on_cpu(tmp_path, monkeypatch):
    """The tier-C bench entry point end to end on the CPU at B=1 (host
    clock, plain versions): three rows with every key and a bound."""
    for name, value in (("BATCH", 1), ("ITERS", 1), ("WARMUP", 0)):
        monkeypatch.setattr(resblock_kernel_bench, name, value)
    out = resblock_kernel_bench.main([
        "--device", "cpu", "--out", str(tmp_path / "bench.json")])
    assert (tmp_path / "bench.json").exists() and out["device"] == "cpu"
    assert [r["shape"] for r in out["rows"]] == [
        "1x32x32x64->64", "1x16x16x128->128", "1x32x32x32->64"]
    for r in out["rows"]:
        assert r["kernel_max_abs_err_vs_plain"] == 0.0   # CPU: plain version
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        for k in ("kernel_ms", "port_ms", "library_ms", "plain_ms"):
            assert r[k] > 0
