"""Launch plans of the port's GroupNorm kernels, on the CPU.

`ops/groupnorm.py:gn_plan` (kernel B) and `ops/resblock.py:conv_plan`
(kernel C) are pure Python: here they are held, at every GroupNorm and
ResBlock norm1 -> conv1 shape of both experiments' main paths, at B=5 and
at the float32 shapes of the experiment-1 ratio net, to what the kernels
assume — every sample, pixel row and channel covered exactly once, dynamic
shared memory within one block's 232,448 bytes, clusters of at most 8 CTAs.
The kernels' library names hash every csrc header, so an edited header
rebuilds them.
"""
import shutil

import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingUNet,
    FlowMatchingUNetMNIST,
    FlowMatchingUNetSVHN,
    RatioEstimatorMNIST,
    RatioEstimatorMNISTSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
    GroupNormSiLU,
    ResBlock,
)
from ratio_guided_multimodal_fm_tpu_torch.ops import _build
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    SMEM_MAX,
    gn_plan,
    gn_slices,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    conv_plan,
    conv_tiles,
)

torch.set_num_threads(2)

# (C, H) of every GroupNormSiLU on the main paths (bf16 U-Nets, B = 256 in
# phase A and 512 in phase B) and of the experiment-1 ratio net (float32,
# B = 256 candidates); test_shape_lists_match_the_models derives them again.
EXP2_GN = [(32, 16), (32, 32), (64, 16), (64, 32), (96, 16), (96, 32),
           (128, 8), (128, 16), (128, 32), (192, 16), (192, 32), (256, 8),
           (256, 16)]
EXP1_GN = [(32, 14), (32, 28), (64, 14), (64, 28), (96, 14), (96, 28),
           (128, 14)]
EXP1_RATIO_GN = [(32, 28), (64, 14), (128, 7), (128, 3)]
# (C, H, O) of every ResBlock norm1 -> conv1, and the tier-C bench's shapes
EXP2_RB = [(32, 16, 64), (32, 32, 32), (64, 16, 64), (64, 16, 128),
           (64, 32, 32), (64, 32, 64), (96, 16, 64), (96, 32, 32),
           (128, 8, 128), (128, 16, 64), (128, 16, 128), (128, 32, 64),
           (192, 16, 128), (192, 32, 64), (256, 8, 128), (256, 16, 128)]
EXP1_RB = [(32, 14, 64), (32, 28, 32), (64, 14, 64), (64, 28, 32),
           (96, 14, 64), (96, 28, 32), (128, 14, 64)]
BENCH_RB = [(64, 32, 64), (128, 16, 128), (32, 32, 64)]

GN_CASES = sorted(
    {(B, C, H, 2) for C, H in EXP2_GN + EXP1_GN for B in (256, 512, 5)}
    | {(B, C, H, 4) for C, H in EXP1_RATIO_GN for B in (256, 5)})
RB_CASES = sorted({(B, C, H, O, s) for C, H, O in EXP2_RB + EXP1_RB + BENCH_RB
                   for B in (512, 5) for s in (2, 4)})


def _shapes(models, xs, ys):
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    gn, rb = set(), set()
    hooks = []
    for net in models:
        for m in net.modules():
            if isinstance(m, GroupNormSiLU):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, a: gn.add(tuple(a[0].shape[1:3]))))
            elif isinstance(m, ResBlock):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, a: rb.add((a[0].shape[1], a[0].shape[2],
                                           mod.conv1.out_channels))))
    with torch.no_grad():
        t = torch.full((1,), 0.5)
        for net, shp in zip(models[:2], (xs, ys)):
            velocity_fn(net)(torch.zeros((1,) + shp), t)
        n_unet = set(gn)
        ratio_log_fn(models[2])(torch.zeros((1,) + xs),
                                torch.zeros((1,) + ys))
    for h in hooks:
        h.remove()
    return n_unet, gn - n_unet, rb


def test_shape_lists_match_the_models():
    bf16 = torch.bfloat16
    gn2, _, rb2 = _shapes((FlowMatchingUNetMNIST(img_size=32, dtype=bf16),
                           FlowMatchingUNetSVHN(dtype=bf16),
                           RatioEstimatorMNISTSVHN(dtype=bf16)),
                          (32, 32, 1), (32, 32, 3))
    gn1, ratio1, rb1 = _shapes((FlowMatchingUNet(dtype=bf16),
                                FlowMatchingUNet(dtype=bf16),
                                RatioEstimatorMNIST()), (28, 28, 1),
                               (28, 28, 1))
    assert gn2 == set(EXP2_GN) and rb2 == set(EXP2_RB)
    assert gn1 == set(EXP1_GN) and rb1 == set(EXP1_RB)
    assert ratio1 | (gn1 & set(EXP1_RATIO_GN)) == set(EXP1_RATIO_GN)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("B,C,H,itemsize", GN_CASES)
def test_gn_plan_covers_every_element_once(B, C, H, itemsize,
                                           channels_last):
    G = min(8, C)
    plan = gn_plan(B, C, H, H, G, itemsize, channels_last)
    HW = H * H
    unit = C if channels_last else HW      # a pixel row / a channel
    assert 1 <= plan.cluster <= 8 and plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster == 1 or plan.samples_per_cta == 1
    assert plan.grid % plan.cluster == 0
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.threads % 32 == 0 and plan.threads % G == 0
    assert plan.threads <= 512
    if channels_last:      # a thread's channels stay fixed while it strides
        assert (plan.threads * plan.vec) % C == 0
    assert unit % plan.vec == 0
    seen = {}
    for cta, b, lo, hi in gn_slices(plan, B, C, H, H):
        assert lo % unit == 0 and hi % unit == 0 and lo < hi
        assert hi - lo <= plan.slice_cap
        seen.setdefault(b, []).append((lo, hi))
    assert sorted(seen) == list(range(B))
    for b, ranges in seen.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == C * HW
        assert all(p[1] == q[0] for p, q in zip(ranges, ranges[1:]))


def test_gn_plan_main_shape_is_staged_in_a_cluster():
    """512x64x32x32 bf16 (128 KiB a sample): two CTAs of a cluster split
    each sample, both slices bulk-copied into shared memory; the 384 KiB
    samples after the SVHN decoder concat take clusters of 8."""
    plan = gn_plan(512, 64, 32, 32, 8, 2, True)
    assert (plan.cluster, plan.staged, plan.vec) == (2, True, 8)
    assert (plan.grid, plan.threads) == (1024, 256)
    assert 3 * (plan.smem_bytes + 1024) <= 233_472    # three CTAs an SM
    assert gn_plan(512, 192, 32, 32, 8, 2, True).cluster == 8
    # small samples share a CTA where the batch is large
    assert gn_plan(512, 128, 8, 8, 8, 2, True).samples_per_cta == 2


def test_gn_plan_unaligned_or_huge_reads_device_memory_twice():
    assert not gn_plan(256, 128, 3, 3, 8, 4, False).staged   # 9 px rows
    assert not gn_plan(4, 8, 512, 512, 8, 4, True).staged    # 8 MiB a sample
    assert gn_plan(4, 8, 512, 512, 8, 4, True).smem_bytes <= SMEM_MAX
    assert gn_plan(8, 64, 32, 32, 8, 2, True, align=8).vec == 4


@pytest.mark.parametrize("B,C,H,O,itemsize", RB_CASES)
def test_conv_plan_covers_every_output_once(B, C, H, O, itemsize):
    plan = conv_plan(H, H, C, O, itemsize)
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.rows * plan.cols <= 128 and plan.cols == H
    assert plan.n_pad % 64 == 0 and O <= plan.n_pad < O + 64
    assert plan.kpad >= C and (itemsize == 4 or plan.kpad % 16 == 0)
    covered = torch.zeros(B, H, H, dtype=torch.int32)
    for _, b, rows, cols in conv_tiles(plan, B, H, H):
        covered[b, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert bool((covered == 1).all())


def test_conv_plan_tiles_columns_past_128():
    plan = conv_plan(4, 200, 16, 24, 2)
    assert (plan.rows, plan.cols, plan.tiles_w) == (1, 128, 2)
    covered = torch.zeros(2, 4, 200, dtype=torch.int32)
    for _, b, rows, cols in conv_tiles(plan, 2, 4, 200):
        covered[b, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert bool((covered == 1).all())
    with pytest.raises(ValueError, match="shared memory"):
        conv_plan(32, 32, 2048, 64, 4)


def test_the_halo_tile_computes_each_activation_about_once():
    """Activations computed per call, (R+2)(Wt+2)/(R Wt) per input element,
    against the first version's 9 ceil(O/64): the bench's three shapes."""
    for (C, H, O), first in zip(BENCH_RB, (9, 18, 9)):
        plan = conv_plan(H, H, C, O, 2)
        per = ((plan.rows + 2) * (plan.cols + 2)) / (plan.rows * plan.cols)
        assert per < 1.7 < first


def test_an_edited_header_renames_every_library(tmp_path):
    for f in ("group_norm_silu.cu", "fused_gn_silu_conv.cu",
              "gn_common.cuh"):
        shutil.copy(_build.CSRC / f, tmp_path / f)
    srcs = [tmp_path / "group_norm_silu.cu", tmp_path / "fused_gn_silu_conv.cu"]
    before = [_build._lib_path(s).name for s in srcs]
    header = tmp_path / "gn_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_build._lib_path(s).name for s in srcs]
    assert all(a != b for a, b in zip(before, after))
    assert [n.split("-")[0] for n in after] == ["group_norm_silu",
                                                "fused_gn_silu_conv"]
    # the same sources and headers give the same names
    assert after == [_build._lib_path(s).name for s in srcs]
