"""The PyTorch port's hand-written kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device (plus nvcc and
triton) and skips without one. This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: flash_guidance rtol 1e-3 / atol 1e-4 (the Pallas kernel's own
bound); group_norm_silu 1e-4 in float32 and 0.05 in bfloat16;
fused_gn_silu_conv 2e-4 in float32 and rtol 0.1 / atol 0.15 in bfloat16
against the float32 plain version (tests/test_resblock_pallas.py), and
rtol 2**-7 / atol 0.05 against the bfloat16 plain version, which rounds at
the same points.
"""
import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    flash_guidance,
    flash_guidance_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    TOL_BF16,
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc/triton) to run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,H,t", [(512, 256, 32, 0.05), (512, 256, 32, 0.5),
                                     (512, 256, 32, 0.95), (5, 300, 5, 0.7),
                                     (3, 7, 2, 0.95)])
def test_flash_guidance_kernel(card, B, N, H, t):
    """At the main-path width (D=4096) the images are quarter-integers in
    [-2, 2]: every product and partial sum is then exact in float32, so the
    two versions' different summation orders cannot move the scores (with
    N(0,1) images the scores are ~2000 in magnitude and float32 rounding
    alone shifts near-tied weights by more than atol). Small D: N(0,1)."""
    g = torch.Generator(card).manual_seed(B + N)

    def rnd(*shape):
        if H < 32:
            return torch.randn(shape, generator=g, device=card)
        return torch.randint(-8, 9, shape, generator=g, device=card) / 4.0

    args = (rnd(B, H, H, 1), rnd(B, H, H, 3), rnd(N, H, H, 1),
            rnd(N, H, H, 3),
            torch.randn(N, generator=g, device=card) * 5.0)
    before = flash_guidance.launches
    got = flash_guidance(*args, t)
    torch.cuda.synchronize()
    assert flash_guidance.launches == before + 1
    want = flash_guidance_reference(*args, t)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("B,C,H,channels_last", [(7, 96, 16, True),
                                                 (512, 64, 32, True),
                                                 (3, 32, 8, False)])
def test_group_norm_silu_kernel(card, dtype, tol, B, C, H, channels_last):
    g = torch.Generator(card).manual_seed(C)
    x = torch.randn(B, C, H, H, generator=g, device=card).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.rand(C, generator=g, device=card) + 0.5
    b = torch.randn(C, generator=g, device=card) * 0.1
    before = group_norm_silu.launches
    got = group_norm_silu(x, w, b, 8)
    torch.cuda.synchronize()
    assert group_norm_silu.launches == before + 1
    assert got.dtype == dtype and got.stride() == x.stride()
    want = group_norm_silu_reference(x, w, b, 8)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,W,C,O", [(512, 32, 32, 64, 64),
                                       (256, 14, 14, 96, 32),
                                       (5, 7, 9, 40, 70), (3, 8, 4, 8, 24)])
def test_fused_gn_silu_conv_kernel(card, B, H, W, C, O):
    """Kernel C against its plain version: float32 to 2e-4, bfloat16 to
    rtol 0.1 / atol 0.15 against the float32 plain version (the bounds of
    tests/test_resblock_pallas.py) and to TOL_BF16 against the bfloat16
    one. The shapes cover a group spanning two K tiles (C=40), O > 64 and
    not a multiple of 16, odd B and H != W."""
    groups = 8 if C % 8 == 0 else 4
    g = torch.Generator(card).manual_seed(C + O)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=card) * scale

    x = rnd(B, H, W, C)
    params = (1.0 + rnd(C, scale=0.1), rnd(C, scale=0.1),
              rnd(3, 3, C, O, scale=0.2), rnd(O, scale=0.1))
    before = fused_gn_silu_conv.launches
    got = fused_gn_silu_conv(x, *params, groups)
    torch.cuda.synchronize()
    assert fused_gn_silu_conv.launches == before + 1
    torch.testing.assert_close(
        got, fused_gn_silu_conv_reference(x, *params, groups),
        rtol=2e-4, atol=2e-4)
    xb = x.to(torch.bfloat16)
    got = fused_gn_silu_conv(xb, *params, groups)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, O)
    torch.testing.assert_close(
        got.float(), fused_gn_silu_conv_reference(xb.float(), *params, groups),
        rtol=0.1, atol=0.15)
    torch.testing.assert_close(
        got.float(), fused_gn_silu_conv_reference(xb, *params, groups).float(),
        **TOL_BF16)


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_guided_sampler_card_matches_cpu(card, solver):
    """Small nets (float32): the sampler on the card, through both kernels,
    against the sampler on the CPU (plain versions), same injected noise
    and MC set."""
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlexibleUNet,
        RatioEstimatorMNISTSVHN,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
        make_guided_sampler_p,
    )

    xs, ys = (16, 16, 1), (16, 16, 3)
    torch.manual_seed(0)
    nets = [FlexibleUNet(in_channels=1, img_size=16, model_channels=16),
            FlexibleUNet(in_channels=3, img_size=16, model_channels=16),
            RatioEstimatorMNISTSVHN()]
    for net in nets[:2]:
        torch.nn.init.normal_(net.out_conv.weight, std=0.05)
    g = torch.Generator().manual_seed(1)
    noise = (torch.randn((4,) + xs, generator=g),
             torch.randn((4,) + ys, generator=g))
    mc = (torch.randn((32,) + xs, generator=g),
          torch.randn((32,) + ys, generator=g),
          torch.exp(torch.randn(32, generator=g)))
    cfg = GuidedSamplerConfig(guidance_method="mc_feng", guidance_strength=0.5,
                              num_steps=6, mc_batch_size=32, x_shape=xs,
                              y_shape=ys, solver=solver)
    sampler = make_guided_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                                    lambda m, y, t: velocity_fn(m)(y, t), cfg,
                                    lambda m, x, y: ratio_log_fn(m)(x, y))
    out = {}
    for dev in (card, torch.device("cpu")):
        models = tuple(place_model(n, dev) for n in nets)
        out[dev.type] = sampler(models, torch.Generator(dev).manual_seed(0), 4,
                                mc_set=tuple(a.to(dev) for a in mc),
                                init_noise=tuple(a.to(dev) for a in noise))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out["cuda"][2]["ess"].cpu(),
                               out["cpu"][2]["ess"], rtol=1e-3, atol=1e-3)
