"""The PyTorch port's hand-written kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA device (and nvcc) and
skips without one. This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: flash_guidance rtol 1e-3 / atol 1e-4 (the Pallas kernel's own
bound) against the plain version run in float64 on inputs that float32
sums exactly, and on N(0,1) images its
scores within their a-priori bound, its g, ESS and l within what
kernel 2's float32 rounding allows from those scores, and at D = 4096,
1568 and Dx = 12,288 / Dy = 4,096 g at most twice the float32 plain
version's error against float64;
group_norm_silu 1e-4 in float32 and one bfloat16 step in bfloat16
(rtol 2**-7, atol 1e-3: kernel and plain version take the same statistics
and round at the same points, see ops/groupnorm.py); its backward, against
the plain backward run in float64 on the same inputs, at most twice the
float32 plain backward's max |err| in dx, dγ and dβ, in bfloat16 one
bfloat16 step from the bfloat16 plain backward, and bit-identical reruns;
the forward's saved statistics equal to the plain version's bit for bit
(both divide the float64 sums by the group's size in IEEE arithmetic);
fused_gn_silu_conv 2e-4 in float32 and rtol 0.1 / atol 0.15 in bfloat16
against the float32 plain version (tests/test_resblock_pallas.py), and
rtol 2**-7 / atol 0.05 against the bfloat16 plain version, which rounds at
the same points; merged-pair sampling against the two nets on the card
5e-5 (the JAX package's tests/test_merged_unet.py bound); batch_norm_silu's
statistics and running statistics bit for bit with the plain version and
BatchNorm2d (the same PyTorch means), y within ops/batchnorm.py:TOL_F32,
its backward within twice the float32 plain backward's max |err| against
the plain backward in float64; linear_tf32x3 (3×TF32) in each role within
3× cuBLAS's float32 product's max |err| against float64 and under a tenth
of the TF32 product's, and two launches bit for bit.
"""
import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    TOL_BF16 as TOL_GN_BF16,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    gn_stats_reference,
    group_norm_silu,
    group_norm_silu_backward,
    group_norm_silu_backward_reference,
    group_norm_silu_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    flash_guidance,
    flash_guidance_reference,
    bound_ratios,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    TOL_BF16,
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)

pytestmark = pytest.mark.cuda
F4_DRAWS = 5      # fresh N(0,1) draws a case of kernel A's float64 checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,H,t", [(512, 256, 32, 0.05), (512, 256, 32, 0.5),
                                     (512, 256, 32, 0.95), (5, 300, 5, 0.7),
                                     (3, 7, 2, 0.95), (512, 256, 28, 0.5),
                                     (70, 1100, 8, 0.3), (1, 1, 1, 0.5)])
def test_flash_guidance_kernel(card, B, N, H, t):
    """At the main-path width (D=4096) the images are quarter-integers in
    [-2, 2]: every product and partial sum is then exact in float32, so no
    summation order can move the scores (with N(0,1) images the scores are
    ~2000 in magnitude and float32 rounding alone shifts near-tied weights
    by more than atol). Small D: N(0,1). The kernel's scores are float64,
    so the plain version runs in float64 too: the float32 one rounds
    scores of ~4e3 (t = 0.5) by ~2e-4, which moves g by up to 8e-4."""
    g = torch.Generator(card).manual_seed(B + N)

    def rnd(*shape):
        if H < 28:
            return torch.randn(shape, generator=g, device=card)
        return torch.randint(-8, 9, shape, generator=g, device=card) / 4.0

    args = (rnd(B, H, H, 1), rnd(B, H, H, 3), rnd(N, H, H, 1),
            rnd(N, H, H, 3),
            torch.randn(N, generator=g, device=card) * 5.0)
    before = flash_guidance.launches
    got = flash_guidance(*args, t)
    torch.cuda.synchronize()
    assert flash_guidance.launches == before + 1
    want = flash_guidance_reference(*args, t, torch.float64)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=1e-3, atol=1e-4)


def _normal_guidance_inputs(card, H, y_ch, seed):
    g = torch.Generator(card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card)

    return (rnd(512, H, H, 1), rnd(512, H, H, y_ch), rnd(256, H, H, 1),
            rnd(256, H, H, y_ch), rnd(256))


def _assert_within_bounds(args, t, cluster=0):
    """The scores kernel 1 wrote within their a-priori bound and
    kernel 2's g, ESS and l within their float32 tolerance from those
    scores (ops/guidance.py:bound_ratios); returns the outputs."""
    held = bound_ratios(args, t, cluster)
    for nm, r in held["ratios"].items():
        assert r <= 1.0, (nm, r)
    return held["out"]


@pytest.mark.parametrize("t", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("H,y_ch", [(32, 3), (28, 1)])
def test_flash_guidance_kernel_float64_yardstick(card, H, y_ch, t):
    """N(0,1) images at both main widths (D = 4096 and 1568), on
    F4_DRAWS draws: near-tied weights amplify any rounding of the scores,
    so no fixed tolerance holds. The yardstick is the plain version in
    float64: the kernel's max |err| in g may be at most twice the float32
    plain version's (the kernel's scores are float64, so its g error is
    kernel 2's own float32 rounding). Each draw is also held to the bounds
    of the scores and of kernel 2."""
    for draw in range(F4_DRAWS):
        args = _normal_guidance_inputs(card, H, y_ch, 100 * H + draw)
        got = _assert_within_bounds(args, t)
        plain = flash_guidance_reference(*args, t)
        exact = flash_guidance_reference(*args, t, torch.float64)
        for i in range(2):
            err_k = float((got[i].double() - exact[i]).abs().max())
            err_p = float((plain[i].double() - exact[i]).abs().max())
            assert err_k <= 2.0 * err_p + 1e-6, (draw, err_k, err_p)
        for i in (2, 3):      # ess, l: the same rounding moves them by ~1e-3
            torch.testing.assert_close(got[i].double(), exact[i], rtol=2e-2,
                                       atol=1e-4)


@pytest.mark.parametrize("t", [0.05, 0.5, 0.95])
@pytest.mark.parametrize("y_ch", [3, 1])
def test_flash_guidance_kernel_bounds_at_64px(card, y_ch, t):
    """The 64-px widths (B=64, N=128; D = 24,576 and the stretch demo's
    Dx = 12,288 / Dy = 4,096), F4_DRAWS N(0,1) draws: at D = 24,576 no
    float32 order holds g within twice another's error on every draw, so
    the scores and kernel 2 are held to their own bounds; at Dx = 12,288 /
    Dy = 4,096 g is also held within twice the float32 plain version's
    error against float64, as at D = 4096; ess and l within rtol 2e-2 of
    float64."""
    g = torch.Generator(card).manual_seed(24 + y_ch)
    for draw in range(F4_DRAWS):
        args = tuple(torch.randn(s, generator=g, device=card) for s in (
            (64, 64, 64, 3), (64, 64, 64, y_ch), (128, 64, 64, 3),
            (128, 64, 64, y_ch), (128,)))
        got = _assert_within_bounds(args, t)
        exact = flash_guidance_reference(*args, t, torch.float64)
        if y_ch == 1:
            plain = flash_guidance_reference(*args, t)
            for i in range(2):
                err_k = float((got[i].double() - exact[i]).abs().max())
                err_p = float((plain[i].double() - exact[i]).abs().max())
                assert err_k <= 2.0 * err_p + 1e-6, (draw, err_k, err_p)
        for i in (2, 3):
            torch.testing.assert_close(got[i].double(), exact[i], rtol=2e-2,
                                       atol=1e-4)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_flash_guidance_kernel_at_every_cluster_size(card, cluster):
    """The score kernel forced to each cluster size 1-8 (another card may
    pick any of them) at B=512, N=256, D=4096, t=0.05: on quarter-integer
    images, which float32 sums exactly, equal to the plain version run in
    float64 within 1e-3 / 1e-4 (a fault in the cluster's exchange would move whole
    scores); on N(0,1) images no NaN, the scores and kernel 2 within their
    bounds at this size, ess and l within rtol 2e-2 of the
    float64 plain version. (g against twice the plain version's error is
    held at the plan's own size by
    test_flash_guidance_kernel_float64_yardstick.)"""
    from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import _launch

    g = torch.Generator(card).manual_seed(cluster)
    quarter = tuple(torch.randint(-8, 9, s, generator=g, device=card) / 4.0
                    for s in ((512, 32, 32, 1), (512, 32, 32, 3),
                              (256, 32, 32, 1), (256, 32, 32, 3)))
    for args in (quarter + (torch.randn(256, generator=g, device=card),),
                 _normal_guidance_inputs(card, 32, 3, 32)):
        if args[0] is quarter[0]:
            flat = [a.reshape(a.shape[0], -1) for a in args[:4]] + [args[4]]
            got = _launch(*flat, 0.05, cluster=cluster)[:4]
        else:
            got = _assert_within_bounds(args, 0.05, cluster)
        torch.cuda.synchronize()
        assert not any(bool(torch.isnan(v).any()) for v in got)
        if args[0] is quarter[0]:
            want = flash_guidance_reference(*args, 0.05, torch.float64)
            for a, b in zip(got, want):
                torch.testing.assert_close(a.double(), b.reshape(a.shape),
                                           rtol=1e-3, atol=1e-4)
            continue
        exact = flash_guidance_reference(*args, 0.05, torch.float64)
        for i in (2, 3):
            torch.testing.assert_close(got[i].double(), exact[i], rtol=2e-2,
                                       atol=1e-4)


@pytest.mark.parametrize("B,N,H,y_ch", [(512, 256, 32, 3), (512, 256, 28, 1),
                                        (5, 300, 5, 3)])
def test_flash_guidance_kernel_is_deterministic(card, B, N, H, y_ch):
    """Two launches on the same inputs give the same bits: the cluster's
    ranks add their partial sums in rank order, no atomics."""
    g = torch.Generator(card).manual_seed(7)
    args = tuple(torch.randn(s, generator=g, device=card) for s in (
        (B, H, H, 1), (B, H, H, y_ch), (N, H, H, 1), (N, H, H, y_ch), (N,)))
    first = flash_guidance(*args, 0.5)
    torch.cuda.synchronize()
    filler = torch.empty(64 << 20, dtype=torch.uint8, device=card).zero_()
    second = flash_guidance(*args, 0.5)
    torch.cuda.synchronize()
    del filler
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(rtol=1e-4,
                                                              atol=1e-4)),
                                       (torch.bfloat16, TOL_GN_BF16)])
@pytest.mark.parametrize("B,C,H,channels_last", [
    (7, 96, 16, True), (512, 64, 32, True), (3, 32, 8, False),
    (512, 128, 32, True), (64, 192, 32, False), (512, 128, 8, True),
    (256, 128, 3, False), (5, 40, 7, True), (512, 128, 3, True),
    (513, 128, 3, False)])
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
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("B,H,W,C,O", [(512, 32, 32, 64, 64),
                                       (256, 14, 14, 96, 32),
                                       (5, 7, 9, 40, 70), (3, 8, 4, 8, 24),
                                       (512, 16, 16, 128, 128),
                                       (2, 4, 200, 16, 24),
                                       (4, 6, 5, 12, 20)])
def test_fused_gn_silu_conv_kernel(card, B, H, W, C, O):
    """Kernel C against its plain version: float32 to 2e-4, bfloat16 to
    rtol 0.1 / atol 0.15 against the float32 plain version (the bounds of
    tests/test_resblock_pallas.py) and to TOL_BF16 against the bfloat16
    one. The shapes cover a group spanning two K tiles (C=40), O > 64 and
    not a multiple of 16, odd B, H != W, W > 128 (column tiles), and
    C = 12, whose bf16 pixel rows are not 16-byte multiples (no bulk copy:
    the CTA stages its rows with plain loads)."""
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


def _gn_backward_inputs(card, B, C, H, dtype, channels_last, seed):
    g = torch.Generator(card).manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn(B, C, H, H, generator=g, device=card) * 2.0 + 0.5).to(
        dtype).contiguous(memory_format=fmt)
    w = torch.rand(C, generator=g, device=card) + 0.5
    b = torch.randn(C, generator=g, device=card) * 0.1
    dy = torch.randn(B, C, H, H, generator=g, device=card).to(dtype)
    return x, w, b, dy


def gn_backward_errors(x, w, b, dy, mean, rstd, got):
    """Max |err| of the kernel's (dx, dγ, dβ) and of the float32 plain
    backward's against the plain backward in float64 at the same
    statistics: {name: (kernel, plain)}."""
    plain = group_norm_silu_backward_reference(dy, x, w, b, mean, rstd)
    exact = group_norm_silu_backward_reference(
        dy.double(), x.double(), w.double(), b.double(), mean.double(),
        rstd.double())
    return {nm: (float((k.double() - e).abs().max()),
                 float((p.double() - e).abs().max()))
            for nm, k, p, e in zip(("dx", "dgamma", "dbeta"), got, plain,
                                   exact)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,channels_last", [
    (512, 32, 28, True), (512, 64, 14, True), (512, 128, 7, True),
    (512, 128, 3, True), (5, 96, 16, True), (3, 32, 8, False),
    (64, 192, 32, False), (7, 40, 7, False), (256, 64, 32, True),
    (512, 128, 3, False), (513, 128, 3, True)])
def test_group_norm_silu_backward_kernel(card, dtype, B, C, H,
                                         channels_last):
    """The forward's saved statistics equal to the plain version's bit for
    bit, autograd's dx the kernel's at them; the backward kernel's dx
    (alone, and with dγ, dβ) against the plain backward; two launches give
    the same bits."""
    x, w, b, dy = _gn_backward_inputs(card, B, C, H, dtype, channels_last, C)
    xs = x.clone().requires_grad_(True)
    before = (group_norm_silu.launches, group_norm_silu_backward.launches)
    y = group_norm_silu(xs, w, b, 8)
    saved = y.grad_fn.saved_tensors
    (dx_auto,) = torch.autograd.grad(y, xs, dy)
    torch.cuda.synchronize()
    assert (group_norm_silu.launches, group_norm_silu_backward.launches) == (
        before[0] + 1, before[1] + 1)
    mean, rstd = gn_stats_reference(x, 8)
    assert torch.equal(saved[3], mean) and torch.equal(saved[4], rstd)
    assert torch.equal(dx_auto, group_norm_silu_backward(
        dy, x, w, b, saved[3], saved[4], False)[0])
    dx_only, dw0, db0 = group_norm_silu_backward(dy, x, w, b, mean, rstd,
                                                 weight_grads=False)
    got = group_norm_silu_backward(dy, x, w, b, mean, rstd)
    again = group_norm_silu_backward(dy, x, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert dw0 is None and db0 is None
    assert dx_only.stride() == x.stride() and dx_only.dtype == dtype
    assert torch.equal(dx_only, got[0])
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if dtype == torch.bfloat16:
        want = group_norm_silu_backward_reference(dy, x, w, b, mean, rstd)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   **TOL_GN_BF16)
        for a, c in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, c, rtol=1e-3, atol=1e-3)
        return
    for nm, (err_k, err_p) in gn_backward_errors(x, w, b, dy, mean, rstd,
                                                 got).items():
        assert err_k <= 2.0 * err_p + 1e-6, (nm, err_k, err_p)


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("B,C,H", [(128, 192, 32), (64, 96, 64),
                                   (64, 288, 64)])
def test_group_norm_silu_backward_wide_plans(card, monkeypatch, B, C, H,
                                             max_cluster):
    """float32 channels_last at the large training sites, with clusters of
    at most 8 CTAs and of 16 where the card holds them: the SVHN U-Net's
    largest site (staged: one CTA an SM at 8 CTAs, two at 16), the
    64-px U-Net's 96-channel site (unstaged at 8 CTAs, staged at 16) and
    its 288-channel one (never staged). dx, dγ and dβ against the float64
    plain backward (at most twice the float32 plain backward's max |err|),
    dx alone equal to dx with dγ/dβ, two launches bit for bit."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import groupnorm

    monkeypatch.setattr(groupnorm, "BACKWARD_MAX_CLUSTER", max_cluster)
    x, w, b, dy = _gn_backward_inputs(card, B, C, H, torch.float32, True, C)
    mean, rstd = gn_stats_reference(x, 8)
    dx_only, _, _ = group_norm_silu_backward(dy, x, w, b, mean, rstd, False)
    got = group_norm_silu_backward(dy, x, w, b, mean, rstd)
    again = group_norm_silu_backward(dy, x, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert torch.equal(dx_only, got[0])
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for nm, (err_k, err_p) in gn_backward_errors(x, w, b, dy, mean, rstd,
                                                 got).items():
        assert err_k <= 2.0 * err_p + 1e-6, (nm, err_k, err_p)


# (C, H) of the trained U-Nets' GN sites (tests/test_torch_port_plans.py:
# TRAIN_GN_CASES): float32, channels_last, B = 128 and a ragged 127
TRAIN_GN = [(32, 16), (32, 32), (64, 16), (64, 32), (96, 16), (96, 32),
            (128, 8), (128, 16), (128, 32), (192, 16), (192, 32), (256, 8),
            (256, 16), (32, 14), (32, 28), (64, 14), (64, 28), (96, 14),
            (96, 28), (128, 14)]
# the experiment-1 ratio net's sites not among them (its 28 and 14 px sites
# are); at B = 128 / 127 their plans hold one sample a CTA
RATIO_TRAIN_GN = [(128, 7), (128, 3)]


@pytest.mark.parametrize("B", [128, 127])
@pytest.mark.parametrize("C,H", TRAIN_GN + RATIO_TRAIN_GN)
def test_group_norm_silu_at_the_training_shapes(card, B, C, H):
    """What a train step runs at every GN site: the forward with its saved
    statistics (equal to the plain version's), then the backward with dγ and
    dβ through autograd (two launches counted, the dγ/dβ one among them),
    each of dx, dγ, dβ within twice the float32 plain backward's max |err|
    against the float64 plain backward."""
    x, _, _, dy = _gn_backward_inputs(card, B, C, H, torch.float32, True, H)
    w = (torch.rand(C, device=card) + 0.5).requires_grad_(True)
    b = (torch.randn(C, device=card) * 0.1).requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    before = group_norm_silu_backward.weight_grad_launches
    y = group_norm_silu(xs, w, b, 8)
    torch.testing.assert_close(y, group_norm_silu_reference(x, w, b, 8),
                               rtol=1e-4, atol=1e-4)
    saved = y.grad_fn.saved_tensors
    mean, rstd = gn_stats_reference(x, 8)
    assert torch.equal(saved[3], mean) and torch.equal(saved[4], rstd)
    got = torch.autograd.grad(y, (xs, w, b), dy)
    torch.cuda.synchronize()
    assert group_norm_silu_backward.weight_grad_launches == before + 1
    assert got[0].stride() == x.stride()
    errs = gn_backward_errors(x, w.detach(), b.detach(), dy, mean, rstd, got)
    for nm, (err_k, err_p) in errs.items():
        assert err_k <= 2.0 * err_p + 1e-6, (nm, err_k, err_p)


def test_group_norm_silu_backward_takes_dy_in_either_layout(card):
    x, w, b, dy = _gn_backward_inputs(card, 8, 64, 16, torch.float32, True, 3)
    mean, rstd = gn_stats_reference(x, 8)
    a = group_norm_silu_backward(dy.contiguous(), x, w, b, mean, rstd)
    c = group_norm_silu_backward(
        dy.contiguous(memory_format=torch.channels_last), x, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.parametrize("method,solver", [("grad", "euler"),
                                           ("mc_feng+grad", "midpoint")])
@pytest.mark.parametrize("exp", ["exp1", "exp2"])
def test_grad_sampler_card_matches_cpu(card, exp, method, solver):
    """Gradient guidance on the card (through kernel B's forward and
    backward with the experiment-1 GroupNorm ratio net, with no GN kernel
    in the experiment-2 BatchNorm one) against the CPU, float32, small nets,
    injected noise and MC set."""
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlexibleRatioEstimator,
        FlexibleUNet,
        RatioEstimatorMNISTSVHN,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
        make_guided_sampler_p,
    )

    y_ch = 1 if exp == "exp1" else 3
    xs, ys = (16, 16, 1), (16, 16, y_ch)
    torch.manual_seed(0)
    ratio = (FlexibleRatioEstimator(feature_dim=32, hidden_dim=64)
             if exp == "exp1" else RatioEstimatorMNISTSVHN())
    nets = [FlexibleUNet(in_channels=1, img_size=16, model_channels=16),
            FlexibleUNet(in_channels=y_ch, img_size=16, model_channels=16),
            ratio]
    for net in nets[:2]:
        torch.nn.init.normal_(net.out_conv.weight, std=0.05)
    g = torch.Generator().manual_seed(1)
    noise = (torch.randn((4,) + xs, generator=g),
             torch.randn((4,) + ys, generator=g))
    mc = (torch.randn((32,) + xs, generator=g),
          torch.randn((32,) + ys, generator=g),
          torch.exp(torch.randn(32, generator=g)))
    cfg = GuidedSamplerConfig(guidance_method=method, guidance_strength=0.5,
                              grad_strength=2.0, num_steps=4,
                              mc_batch_size=32, x_shape=xs, y_shape=ys,
                              solver=solver)
    sampler = make_guided_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                                    lambda m, y, t: velocity_fn(m)(y, t), cfg,
                                    lambda m, x, y: ratio_log_fn(m)(x, y))
    out = {}
    before = group_norm_silu_backward.launches
    for dev in (card, torch.device("cpu")):
        models = tuple(place_model(n, dev) for n in nets)
        out[dev.type] = sampler(models, torch.Generator(dev).manual_seed(0), 4,
                                mc_set=tuple(a.to(dev) for a in mc),
                                init_noise=tuple(a.to(dev) for a in noise))
    evals = 4 * (2 if solver == "midpoint" else 1)
    assert group_norm_silu_backward.launches - before == (
        8 * evals if exp == "exp1" else 0)
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


# slice 9's new GroupNorm shapes (C, H, groups): FlowMatchingUNet64's
# largest and deepest sites, the 64-px ratio net's first, the
# encoder-decoder's 7 px and 28 px sites, and merged-pair sites (2C
# channels, 2G groups) of the experiment-1 and 64-px U-Nets
SLICE9_GN = [(288, 64, 8), (96, 64, 8), (768, 8, 8), (576, 16, 8),
             (32, 64, 8), (256, 7, 8), (32, 28, 8), (64, 28, 16),
             (128, 7, 16), (576, 64, 16), (1536, 8, 16)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(rtol=1e-4,
                                                              atol=1e-4)),
                                       (torch.bfloat16, TOL_GN_BF16)])
@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("C,H,G", SLICE9_GN)
def test_group_norm_silu_at_the_slice9_shapes(card, dtype, tol, B, C, H, G):
    """The forward at the 64-px, encoder-decoder and merged-pair sites,
    channels_last (the samplers' layout), B = 64 (the 64-px chunk) and 128
    (its N_mc)."""
    g = torch.Generator(card).manual_seed(C + H)
    x = (torch.randn(B, C, H, H, generator=g, device=card) * 2.0 + 0.5).to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = torch.rand(C, generator=g, device=card) + 0.5
    b = torch.randn(C, generator=g, device=card) * 0.1
    got = group_norm_silu(x, w, b, G)
    again = group_norm_silu(x, w, b, G)
    torch.cuda.synchronize()
    assert got.stride() == x.stride() and torch.equal(got, again)
    torch.testing.assert_close(got.float(), group_norm_silu_reference(
        x, w, b, G).float(), **tol)


@pytest.mark.parametrize("C,H", [(96, 64), (288, 64), (192, 32), (768, 8),
                                 (32, 28), (256, 7)])
def test_group_norm_silu_backward_at_the_slice9_training_shapes(card, C, H):
    """What a 64-px (B = 64) or encoder-decoder train step runs at its GN
    sites: the saved statistics bit for bit, dx, dγ and dβ through autograd
    within twice the float32 plain backward's max |err| against float64."""
    x, _, _, dy = _gn_backward_inputs(card, 64, C, H, torch.float32, True, H)
    w = (torch.rand(C, device=card) + 0.5).requires_grad_(True)
    b = (torch.randn(C, device=card) * 0.1).requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    y = group_norm_silu(xs, w, b, 8)
    mean, rstd = gn_stats_reference(x, 8)
    saved = y.grad_fn.saved_tensors
    assert torch.equal(saved[3], mean) and torch.equal(saved[4], rstd)
    got = torch.autograd.grad(y, (xs, w, b), dy)
    torch.cuda.synchronize()
    errs = gn_backward_errors(x, w.detach(), b.detach(), dy, mean, rstd, got)
    for nm, (err_k, err_p) in errs.items():
        assert err_k <= 2.0 * err_p + 1e-6, (nm, err_k, err_p)


@pytest.mark.parametrize("img,cin,mult", [(16, 1, (1, 2)),
                                          (32, 3, (1, 2, 2, 4))])
def test_merged_sampler_matches_two_nets_on_the_card(card, img, cin, mult):
    """Merged-pair evaluation on the card against the two nets on the card,
    float32, through both phases (phase A drawn inside from the same
    generator): samples within 5e-5, the bound of the JAX package's
    tests/test_merged_unet.py."""
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import velocity_fn
    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import FlexibleUNet
    from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
        merged_pair_apply,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        sample_bimodal_guided,
    )

    nets = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        net = FlexibleUNet(in_channels=cin, img_size=img, model_channels=16,
                           channel_mult=mult)
        torch.nn.init.normal_(net.out_conv.weight, std=0.05)
        nets.append(place_model(net, card))
    shape = (img, img, cin)
    kw = dict(log_ratio_fn=lambda a, b: (a * b).mean(dim=(1, 2, 3)) * 4.0,
              guidance_method="mc_feng", guidance_strength=0.7,
              num_samples=8, num_steps=6, mc_batch_size=16, x_shape=shape,
              y_shape=shape, device=card, return_diagnostics=True)
    fx, fy = velocity_fn(nets[0]), velocity_fn(nets[1])
    with torch.no_grad():
        two = sample_bimodal_guided(fx, fy, **kw)
        merged = sample_bimodal_guided(
            fx, fy, fm_pair_fn=merged_pair_apply(nets[0])(*nets), **kw)
    for a, c in zip(merged[:2], two[:2]):
        assert float(c.abs().max()) > 0.1
        torch.testing.assert_close(a, c, rtol=0, atol=5e-5)
    torch.testing.assert_close(merged[2]["ess"], two[2]["ess"], rtol=1e-4,
                               atol=1e-4)


# ---- slice 10: the fused K-step trainer's CUDA graph ----------------------

def _fm_states(card, n=2):
    from ratio_guided_multimodal_fm_tpu_torch.models.unet import FlexibleUNet
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    out = []
    for _ in range(n):
        torch.manual_seed(0)
        out.append(S.create_fm_state(FlexibleUNet(
            in_channels=1, img_size=32, model_channels=32,
            channel_mult=(1, 2), num_res_blocks=2, dropout=0.1), card,
            lr=1e-4, ema_decay=0.999))
    return out


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: its default weight-gradient
    kernels add with atomics, so two eager runs of a step differ in the
    last bits; with them the graph equals the eager loop bit for bit."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def _assert_same_state(a, b):
    for k, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[k]), k
    for k in (a.ema or {}):
        assert torch.equal(a.ema[k], b.ema[k]), k


def test_fused_fm_graph_equals_eager_loop(card, deterministic_cudnn):
    """Two macro steps of K=4 at B=16 (dropout on): the graph replay's
    losses, parameters and EMA equal the eager K-step loop's bit for bit.
    The wrappers count the eager warm-up's GN launches and not the
    capture's or the replay's; the profiler's trace of the replay shows
    its 4 × 25."""
    from torch.profiler import ProfilerActivity, profile

    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    graphed, eager = _fm_states(card)
    data = torch.randn(256, 32, 32, 1, device=card)
    fg = S.make_fm_train_multistep(0.999)
    fe = S.make_fm_train_multistep(0.999, graph=False)
    counted = []
    for m in range(2):
        idx = torch.randint(0, 256, (4, 16), dtype=torch.int32).numpy()
        before = launch_counts()["group_norm_silu.launches"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lg = fg(graphed, data, idx, torch.Generator(card).manual_seed(m))
            torch.cuda.synchronize()
        counted.append(launch_counts()["group_norm_silu.launches"] - before)
        le = fe(eager, data, idx, torch.Generator(card).manual_seed(m))
        assert torch.equal(lg, le)
    traced = sum(e.count for e in prof.key_averages()
                 if "gn_silu_kernel" in e.key)
    assert counted == [4 * 25, 0] and traced == 4 * 25
    (g,) = fg.graphs.values()
    assert g.replays == 1
    _assert_same_state(graphed, eager)


def test_fused_ratio_graph_equals_eager_loop(card, deterministic_cudnn):
    """The experiment-1 ratio net (8 GN sites, clip, EMA), K=3, B=16: the
    metrics and the state equal the eager loop's bit for bit."""
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNIST,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    states = []
    for _ in range(2):
        torch.manual_seed(1)
        states.append(S.create_ratio_state(RatioEstimatorMNIST(), card,
                                           ema_decay=0.999))
    xa = torch.randn(128, 28, 28, 1, device=card)
    ya = torch.randn(128, 28, 28, 1, device=card)
    fg = S.make_ratio_train_multistep("disc", 0.999)
    fe = S.make_ratio_train_multistep("disc", 0.999, graph=False)
    for m in range(2):
        xi, yi = (torch.randint(0, 128, (3, 16), dtype=torch.int32).numpy()
                  for _ in range(2))
        real = (torch.rand(3, 16) < 0.5).float().numpy()
        mg = fg(states[0], xa, ya, xi, yi, real,
                torch.Generator(card).manual_seed(m))
        me = fe(states[1], xa, ya, xi, yi, real,
                torch.Generator(card).manual_seed(m))
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
    _assert_same_state(*states)


def test_capturable_adam_matches_the_current_update(card):
    """Adam with capturable=True (its step count on the card, bias
    correction in float32) against the default update on the same
    gradients, three steps: within 1e-6 relative."""
    from ratio_guided_multimodal_fm_tpu_torch.train.graphs import (
        make_capturable,
    )

    torch.manual_seed(2)
    p0 = [torch.randn(64, 32, device=card), torch.randn(7, device=card)]
    pa, pb, pc = ([p.clone().requires_grad_(True) for p in p0]
                  for _ in range(3))
    oa, ob, oc = (torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999),
                                   eps=1e-8) for ps in (pa, pb, pc))
    make_capturable(ob)
    for i in range(3):
        for a, b, c in zip(pa, pb, pc):
            g = torch.randn_like(a) * (0.1 + i)
            a.grad, b.grad, c.grad = g.clone(), g.clone(), g.clone()
        for o in (oa, ob, oc):
            o.step()
        if i == 0:    # a count taken before the switch moves to the card
            make_capturable(oc)
            assert oc.state[pc[0]]["step"].device.type == "cuda"
    assert ob.state[pb[0]]["step"].device.type == "cuda"
    for a, b, c in zip(pa, pb, pc):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(c, a, rtol=1e-6, atol=1e-7)


# ---- the program's spans on the card --------------------------------------

def test_span_holds_its_kernels_device_interval(card):
    """A span around one kernel and a synchronize holds that kernel's
    device interval from a profiler session: the spans (time.time_ns) and
    the profiler's device events are on one clock. The host waits 50 ms
    in the span before the launch and after the synchronize: the device
    timeline lands up to ~4 ms early against time_ns in some sessions
    (PERF.md), and another clock (perf_counter, monotonic) would lie ~1e18
    ns away. The session opens with tiny
    kernels (the profiler can lose a session's first device events); the
    span's kernel is the session's only spin kernel."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from ratio_guided_multimodal_fm_tpu_torch.core import observability as obs

    z = torch.zeros(1, device=card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(1000):
            z.add_(1)
        torch.cuda.synchronize()
        with obs.span("test.kernel"):
            time.sleep(0.05)
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            time.sleep(0.05)
    s = [r for r in obs.spans() if r.name == "test.kernel"][-1]
    events = list(prof.profiler.kineto_results.events())
    kernels = [(e.start_ns(), e.end_ns()) for e in events
               if str(e.device_type()).endswith("CUDA")
               and "spin_kernel" in e.name()]
    assert len(kernels) == 1
    k0, k1 = kernels[0]
    print(f"kernel starts {(k0 - s.start_ns) / 1e6:.3f} ms after the span "
          f"opens, ends {(s.end_ns - k1) / 1e6:.3f} ms before it closes")
    assert s.start_ns <= k0 < k1 <= s.end_ns
    assert s.end_ns - s.start_ns < 10**9
    assert "test.kernel" not in {e.name() for e in events}


def test_train_graph_records_one_warmup_and_one_capture(card):
    """Three calls of the fused FM trainer: one warm-up and one capture
    (inside the first call's span), then a replay in each later call."""
    from ratio_guided_multimodal_fm_tpu_torch.core import observability as obs
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    (state,) = _fm_states(card, 1)
    data = torch.randn(64, 32, 32, 1, device=card)
    step = S.make_fm_train_multistep(0.999)
    obs.reset()
    for m in range(3):
        idx = torch.randint(0, 64, (2, 8), dtype=torch.int32).numpy()
        step(state, data, idx, torch.Generator(card).manual_seed(m))
    torch.cuda.synchronize()
    counts = {n: t["count"] for n, t in obs.span_totals().items()
              if n.startswith("train.")}
    assert counts == {"train.fm.call": 3, "train.graph.warmup": 1,
                      "train.graph.capture": 1, "train.graph.replay": 2}
    recs = obs.spans()
    calls = [r.call_id for r in recs if r.name == "train.fm.call"]
    assert len(set(calls)) == 3
    for r in recs:
        if r.name.startswith("train.graph."):
            assert r.parent == "train.fm.call" and r.call_id in calls
    first = [r.name for r in recs if r.call_id == calls[0]
             and r.name.startswith("train.graph.")]
    assert first == ["train.graph.warmup", "train.graph.capture"]


# ---- the fused train-mode BatchNorm+SiLU (csrc/batch_norm_silu.cu) --------

# (C, H) of the experiment-2 ratio net's 12 BatchNorm sites (MNIST encoder
# 1-4, SVHN encoder 1a-4b)
BN_SITES = [(32, 32), (64, 16), (128, 8), (128, 4), (64, 32), (64, 32),
            (128, 16), (128, 16), (256, 8), (256, 8), (256, 4), (256, 4)]


def _bn_inputs(card, B, C, H, seed):
    g = torch.Generator(card).manual_seed(seed)
    x = (torch.randn(B, C, H, H, generator=g, device=card) * 2.0 + 0.5
         ).contiguous(memory_format=torch.channels_last)
    w = torch.rand(C, generator=g, device=card) + 0.5
    b = torch.randn(C, generator=g, device=card) * 0.1
    run = (torch.randn(C, generator=g, device=card) * 0.1,
           torch.rand(C, generator=g, device=card) + 0.5,
           torch.zeros((), dtype=torch.long, device=card))
    dy = torch.randn(B, C, H, H, generator=g, device=card
                     ).contiguous(memory_format=torch.channels_last)
    return x, w, b, run, dy


def _bn_fused(x, w, b, run, dy):
    """(y, (dx, dγ, dβ), saved (mean, rstd)) of the fused op through
    autograd, on copies of x, w, b and the running statistics given."""
    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        batch_norm_silu,
    )

    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = batch_norm_silu(xs, ws, bs, *run)
    saved = y.grad_fn.saved_tensors[3:]
    return y, torch.autograd.grad(y, (xs, ws, bs), dy), saved


def _hold_bn_kernels(card, x, w, b, run, dy):
    """The kernels against the plain versions at one input: the saved
    statistics, the running statistics and num_batches_tracked bit for bit
    (and equal to BatchNorm2d's); y within TOL_F32; dx, dγ, dβ each within
    twice the float32 plain backward's max |err| against the float64 plain
    backward at the same statistics; a second run bit for bit."""
    from ratio_guided_multimodal_fm_tpu_torch.models.ratio import BatchNorm2d
    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        TOL_F32,
        batch_norm_silu_backward_reference,
        batch_norm_silu_reference,
    )

    k_run = tuple(t.clone() for t in run)
    p_run = tuple(t.clone() for t in run)
    y, got, (mean, rstd) = _bn_fused(x, w, b, k_run, dy)
    y_p, mean_p, rstd_p = batch_norm_silu_reference(x, w, b, *p_run)
    bn = BatchNorm2d(x.shape[1]).to(card).train()
    with torch.no_grad():
        bn.running_mean.copy_(run[0])
        bn.running_var.copy_(run[1])
    bn(x)
    torch.cuda.synchronize()
    assert torch.equal(mean, mean_p) and torch.equal(rstd, rstd_p)
    assert all(torch.equal(u, v) for u, v in zip(k_run, p_run))
    assert torch.equal(k_run[0], bn.running_mean)
    assert torch.equal(k_run[1], bn.running_var)
    assert y.stride() == x.stride() and got[0].stride() == x.stride()
    torch.testing.assert_close(y, y_p, **TOL_F32)
    plain = batch_norm_silu_backward_reference(dy, x, w, b, mean, rstd)
    exact = batch_norm_silu_backward_reference(
        dy.double(), x.double(), w.double(), b.double(), mean.double(),
        rstd.double())
    for nm, k, p, e in zip(("dx", "dgamma", "dbeta"), got, plain, exact):
        err_k = float((k.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= 2.0 * err_p + 1e-6, (nm, err_k, err_p)
    again = _bn_fused(x, w, b, tuple(t.clone() for t in run), dy)
    torch.cuda.synchronize()
    assert torch.equal(y, again[0])
    assert all(torch.equal(u, v) for u, v in zip(got, again[1]))
    return rstd


@pytest.mark.parametrize("B", [128, 127, 1])
@pytest.mark.parametrize("site", range(12))
def test_batch_norm_silu_kernels_at_the_ratio_sites(card, site, B):
    """Each of the 12 sites at the cell's B = 128 and at ragged row counts
    (B = 127, B = 1), as _hold_bn_kernels holds them."""
    C, H = BN_SITES[site]
    _hold_bn_kernels(card, *_bn_inputs(card, B, C, H, 100 * site + B))


def test_batch_norm_silu_kernels_at_a_clamped_variance(card):
    """Channel 1 of two rows whose float32 E[x²] − E[x]² is negative: rstd
    saved negated, the variance term dropped, as _hold_bn_kernels holds
    them."""
    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        bn_stats_reference,
    )

    c = 1.0
    while True:
        c = c * 1.0009765625 + 0.123
        pair = torch.tensor([c, c * (1 + 3e-7)], device=card)
        if bn_stats_reference(pair.view(2, 1, 1, 1))[1][0] < 0:
            break
    x, w, b, run, dy = _bn_inputs(card, 2, 8, 1, 7)
    x[:, 1, 0, 0] = pair
    rstd = _hold_bn_kernels(card, x, w, b, run, dy)
    assert rstd[1] < 0 and (rstd[[0, 2, 3, 4, 5, 6, 7]] > 0).all()


def test_batch_norm_silu_backward_takes_dy_in_either_layout(card):
    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        batch_norm_silu_backward,
        bn_stats_reference,
    )

    x, w, b, _, dy = _bn_inputs(card, 16, 64, 16, 3)
    mean, rstd, _ = bn_stats_reference(x)
    a = batch_norm_silu_backward(dy.contiguous(), x, w, b, mean, rstd)
    c = batch_norm_silu_backward(dy, x, w, b, mean, rstd)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_fused_bn_ratio_graph_equals_eager_loop(card, deterministic_cudnn):
    """The experiment-2 ratio net (12 BatchNorm sites), K = 8, B = 16, two
    macro steps: the graph's metrics, parameters, running statistics and
    EMA equal the eager K-step loop's bit for bit. The wrappers count 12
    forward and 12 backward calls an eager sub-step (the graph's warm-up
    and the eager loop) and none on the capture or the replay; the
    profiler's trace of the replay shows each of the three kernels 8 x 12
    times."""
    from torch.profiler import ProfilerActivity, profile

    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNISTSVHN,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    keys = ("batch_norm_silu.launches", "batch_norm_silu_backward.launches")
    K, B = 8, 16
    states = []
    for _ in range(2):
        torch.manual_seed(1)
        states.append(S.create_ratio_state(RatioEstimatorMNISTSVHN(), card,
                                           ema_decay=0.999))
    xa = torch.randn(256, 32, 32, 1, device=card)
    ya = torch.randn(256, 32, 32, 3, device=card)
    fg = S.make_ratio_train_multistep("disc", 0.999)
    fe = S.make_ratio_train_multistep("disc", 0.999, graph=False)
    counted = []
    for m in range(2):
        xi, yi = (torch.randint(0, 256, (K, B), dtype=torch.int32).numpy()
                  for _ in range(2))
        real = (torch.rand(K, B) < 0.5).float().numpy()
        before = [launch_counts()[k] for k in keys]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mg = fg(states[0], xa, ya, xi, yi, real,
                    torch.Generator(card).manual_seed(m))
            torch.cuda.synchronize()
        counted.append([launch_counts()[k] - n for k, n in zip(keys, before)])
        before = [launch_counts()[k] for k in keys]
        me = fe(states[1], xa, ya, xi, yi, real,
                torch.Generator(card).manual_seed(m))
        assert [launch_counts()[k] - n
                for k, n in zip(keys, before)] == [12 * K, 12 * K]
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
    assert counted == [[12 * K, 12 * K], [0, 0]]
    traced = {name: sum(e.count for e in prof.key_averages()
                        if name in e.key)
              for name in ("bn_silu_apply_kernel", "bn_grad_reduce_kernel",
                           "bn_silu_grad_apply_kernel")}
    assert traced == dict.fromkeys(traced, 12 * K), traced
    (g,) = fg.graphs.values()
    assert g.replays == 1
    _assert_same_state(*states)


# ---- SiT: pinned attention and the class-conditional fused trainer --------

SIT_TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=96,
                depth=2, num_heads=4, num_classes=10)


def _sit_states(card, n=2):
    from ratio_guided_multimodal_fm_tpu_torch.models import SiT
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    out = []
    for _ in range(n):
        torch.manual_seed(0)
        model = SiT(**SIT_TINY)
        with torch.no_grad():       # SiT's zero init leaves no gradient
            for p in model.parameters():   # but the last layer's
                p.add_(torch.randn_like(p) * 0.05)
        out.append(S.create_fm_state(model, card, lr=1e-4, ema_decay=0.9999))
    return out


def test_sdpa_pins_the_efficient_backend_in_float32(card):
    """At SiT-XL/2's attention shape (16 heads of 72 over 256 tokens) the
    pinned call counts one memory-efficient launch and no math one, and is
    within twice the float32 math path's max |err| against float64 (a
    float32-accurate product: the 3xTF32 tensor-core kernel), while TF32
    products miss float64 by over ten times that. A dtype the backend
    cannot take raises instead of falling back."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts, sdpa

    g = torch.Generator(card).manual_seed(0)
    q, k, v = (torch.randn(2, 16, 256, 72, generator=g, device=card)
               for _ in range(3))
    before = launch_counts()
    out = sdpa(q, k, v)
    after = launch_counts()
    assert after["sdpa.efficient_launches"] == (
        before["sdpa.efficient_launches"] + 1)
    assert after["sdpa.math_launches"] == before["sdpa.math_launches"]

    def plain(a, b, c):
        w = torch.softmax(a @ b.transpose(-2, -1) / a.shape[-1] ** 0.5, -1)
        return w @ c

    exact = plain(q.double(), k.double(), v.double())
    err = float((out.double() - exact).abs().max())
    err_f32 = float((plain(q, k, v).double() - exact).abs().max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err_tf32 = float((plain(q, k, v).double() - exact).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"sdpa max|err| vs float64: efficient {err:.3e}, float32 math "
          f"{err_f32:.3e}, TF32 math {err_tf32:.3e}")
    assert err <= 2 * err_f32 < err_tf32 / 10
    with pytest.raises(RuntimeError):
        sdpa(q.double(), k.double(), v.double())


def test_fused_sit_graph_equals_eager_loop(card, deterministic_cudnn):
    """Two macro steps of K=2 at B=8 with labels (label drop on): the
    graph replay's losses, parameters and EMA equal the eager K-step
    loop's bit for bit; the warm-up counts its 2 × depth attention calls
    on the memory-efficient backend and 4 sites × depth × 3 roles × K
    launches of the 3×TF32 linear kernel (each after one split pre-pass),
    the capture and the replay none; the spans are one warm-up, one
    capture and one replay."""
    from ratio_guided_multimodal_fm_tpu_torch.core import observability as obs
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    graphed, eager = _sit_states(card)
    data = torch.randn(64, 8, 8, 4, device=card)
    labels = torch.randint(0, 10, (64,), device=card)
    fg = S.make_fm_train_multistep(0.9999)
    fe = S.make_fm_train_multistep(0.9999, graph=False)
    obs.reset()
    counted = []
    for m in range(2):
        idx = torch.randint(0, 64, (2, 8), dtype=torch.int32).numpy()
        before = launch_counts()
        lg = fg(graphed, data, idx, torch.Generator(card).manual_seed(m),
                labels=labels)
        torch.cuda.synchronize()
        after = launch_counts()
        counted.append([after[k] - before[k] for k in (
            "sdpa.efficient_launches", "sdpa.math_launches",
            "linear_tf32x3.launches", "linear_tf32x3.split_launches")])
        le = fe(eager, data, idx, torch.Generator(card).manual_seed(m),
                labels=labels)
        assert torch.equal(lg, le)
    linears = 4 * SIT_TINY["depth"] * 3 * 2
    assert counted == [[2 * SIT_TINY["depth"], 0, linears, linears],
                       [0, 0, 0, 0]]
    counts = {n: t["count"] for n, t in obs.span_totals().items()
              if n.startswith("train.graph.")}
    assert counts == {"train.graph.warmup": 1, "train.graph.capture": 1,
                      "train.graph.replay": 1}
    (g,) = fg.graphs.values()
    assert g.replays == 1
    _assert_same_state(graphed, eager)


# SiT-XL/2's token projections (K, N) at B = 32 (M = 8,192 tokens), and the
# CPU-size SiT's (hidden 96)
LINEAR_XL = {"qkv": (1152, 3456), "proj": (1152, 1152), "fc1": (1152, 4608),
             "fc2": (4608, 1152)}
LINEAR_TINY = {"qkv": (96, 288), "proj": (96, 96), "fc1": (96, 384),
               "fc2": (384, 96)}


def _check_linear_role(card, role, M, K, N, name):
    """One role through the wrapper and its autograd Function, held to
    cli/linear_kernel_bench.py's 3×TF32 rule (3× the float32 product's max
    |err| against float64, under a tenth of the TF32 product's)."""
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        linear_kernel_bench as LB,
    )

    calls = LB.role_calls(role, *LB.operands(M, K, N, card))
    LB.check_role(f"{name} M={M}", role, LB.role_errors(calls))


@pytest.mark.parametrize("role", ["forward", "dgrad", "wgrad"])
@pytest.mark.parametrize("site", sorted(LINEAR_XL))
def test_linear_tf32x3_at_the_sit_xl_shapes(card, site, role):
    """Each role at SiT-XL/2's shapes: the kernel's max |err| against a
    float64 product within 3× cuBLAS's float32 product's, and under a tenth
    of the TF32 product's (three TF32 products, float32-accurate)."""
    K, N = LINEAR_XL[site]
    _check_linear_role(card, role, 8192, K, N, site)


@pytest.mark.parametrize("role", ["forward", "dgrad", "wgrad"])
@pytest.mark.parametrize("M,site", [(8190, "fc1"), (8190, "fc2"),
                                    (128, "qkv"), (127, "qkv"),
                                    (127, "proj"), (128, "fc1"),
                                    (127, "fc2")])
def test_linear_tf32x3_ragged_and_at_the_cpu_sit_widths(card, M, site, role):
    """A ragged M at SiT-XL/2's widths (TMA's zero fill, masked stores) and
    the CPU-size SiT's widths (96 → 288, 96, 384; 384 → 96)."""
    K, N = (LINEAR_XL if M > 1000 else LINEAR_TINY)[site]
    _check_linear_role(card, role, M, K, N, site)


@pytest.mark.parametrize("role", ["forward", "dgrad", "wgrad"])
@pytest.mark.parametrize("M", [16, 17, 127])
@pytest.mark.parametrize("K,N", [(100, 36), (36, 100)])
def test_linear_tf32x3_at_widths_off_the_tile(card, K, N, M, role):
    """Widths that are multiples of 4 but not of 32: a partial last stage
    of 32 (TMA's zero fill along K), wgrad's transposed A with a ragged
    row count, and transposed planes whose rows are padded to a multiple
    of 4 (the pad columns unwritten: M = 17, 127), wgrad splitting dy
    (K > N) and x (K <= N); M = 16 is the plan's floor."""
    _check_linear_role(card, role, M, K, N, f"K={K} N={N}")


@pytest.mark.parametrize("M", [1, 15])
def test_linear_tf32x3_raises_below_the_row_floor(card, M):
    """Fewer rows than ops/linear.py:MIN_ROWS raise on the card, as the
    plan documents, and nothing falls back."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import linear_tf32x3

    x = torch.randn(M, 96, device=card)
    w = torch.randn(288, 96, device=card)
    with pytest.raises(ValueError, match="no plan"):
        linear_tf32x3(x, w)


@pytest.mark.parametrize("role", ["forward", "dgrad", "wgrad"])
def test_linear_tf32x3_is_deterministic(card, role):
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        linear_kernel_bench as LB,
    )

    kernel, _, _ = LB.role_calls(role, *LB.operands(4096, 1152, 4608, card))
    assert torch.equal(kernel(), kernel())


def test_linear_tf32x3_through_autograd_with_bias(card):
    """The wrapper on [B, N, K] activations with a bias, forward and
    backward, against F.linear in float64, and its launch counters."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        launch_counts,
        linear_tf32x3,
    )

    g = torch.Generator(card).manual_seed(1)
    x = torch.randn(4, 64, 96, generator=g, device=card, requires_grad=True)
    w = torch.randn(288, 96, generator=g, device=card, requires_grad=True)
    b = torch.randn(288, generator=g, device=card, requires_grad=True)
    dy = torch.randn(4, 64, 288, generator=g, device=card)
    before = launch_counts()
    y = linear_tf32x3(x, w, b)
    y.backward(dy)
    after = launch_counts()
    for k in ("linear_tf32x3.launches", "linear_tf32x3.split_launches"):
        assert after[k] - before[k] == 3
    x64, w64, b64 = (t.detach().double().requires_grad_() for t in (x, w, b))
    y64 = torch.nn.functional.linear(x64, w64, b64)
    y64.backward(dy.double())
    for got, want in ((y, y64), (x.grad, x64.grad), (w.grad, w64.grad),
                      (b.grad, b64.grad)):
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_linear_tf32x3_raises_off_float32(card, dtype):
    from ratio_guided_multimodal_fm_tpu_torch.ops import linear_tf32x3

    x = torch.randn(8, 96, device=card, dtype=dtype)
    w = torch.randn(288, 96, device=card, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        linear_tf32x3(x, w)
