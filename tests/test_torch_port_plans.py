"""Launch plans of the port's kernels, on the CPU.

`ops/guidance.py:guidance_plan` (kernel A) is pure Python: at both main-path
shapes, a ragged one, the smallest one and a short and a long MC axis it is
held to what the kernels assume — every (b, n) score, every feature and
every (b, d) output covered exactly once, slices that are whole stages,
clusters of at most 8 CTAs, dynamic shared memory within one block's
232,448 bytes, the 16-byte loader only where every row is 16-byte aligned.

`ops/groupnorm.py:gn_plan` (kernel B), `gn_backward_plan` (its backward)
and `ops/resblock.py:conv_plan` (kernel C) are pure Python too: here they
are held, at every GroupNorm and ResBlock norm1 -> conv1 shape of both
experiments' main paths, at B=5 and at the float32 shapes of the
experiment-1 ratio net, to what the kernels assume — every sample, pixel
row and channel covered exactly once, dynamic shared memory within one
block's 232,448 bytes, clusters of at most 8 CTAs (16 for the backward
where the card holds them); and, forward and backward, at the trainers'
float32 shapes (B = 128, 127) and every GN site of the trained nets.
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
from ratio_guided_multimodal_fm_tpu_torch.ops import groupnorm
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    SMEM_MAX,
    gn_backward_plan,
    gn_plan,
    gn_slices,
)
from ratio_guided_multimodal_fm_tpu_torch.ops import guidance
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    guidance_plan,
    score_slices,
    score_tiles,
    sum_tiles,
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


# (B, N, Dx, Dy): experiment 2, experiment 1, ragged, smallest, a short and
# a long MC axis, a wide ragged one, a batch of one
GUIDANCE_CASES = [(512, 256, 1024, 3072), (512, 256, 784, 784),
                  (5, 300, 25, 75), (1, 1, 1, 1), (512, 64, 1024, 3072),
                  (512, 4096, 1024, 3072), (70, 1100, 64, 192),
                  (3, 7, 4, 12), (1, 256, 1024, 3072), (1000, 33, 6, 10)]


@pytest.mark.parametrize("aligned_ptrs", [True, False])
@pytest.mark.parametrize("B,N,Dx,Dy", GUIDANCE_CASES)
def test_guidance_plan_covers_every_score_and_output_once(B, N, Dx, Dy,
                                                          aligned_ptrs):
    plan = guidance_plan(B, N, Dx, Dy, aligned_ptrs)
    D = Dx + Dy
    assert plan.aligned == (aligned_ptrs and Dx % 4 == 0 and Dy % 4 == 0)
    assert 1 <= plan.cluster <= min(8, plan.k_stages)
    tiles1 = plan.tiles_b1 * plan.tiles_n1
    waves = -(-tiles1 // guidance.CAPACITY[plan.cluster - 1])
    for k in range(1, min(8, plan.k_stages) + 1):     # no k runs fewer stages
        assert (waves * -(-plan.k_stages // plan.cluster)
                <= -(-tiles1 // guidance.CAPACITY[k - 1])
                * -(-plan.k_stages // k))
    assert plan.grid1 % plan.cluster == 0 and plan.threads == 256
    assert 3 <= plan.stages <= 4
    assert max(plan.smem1, plan.smem2) <= guidance.SMEM_MAX == SMEM_MAX
    # every feature in exactly one rank's slice; slices are whole stages
    slices = score_slices(plan, D)
    assert len(slices) == plan.cluster
    assert slices[0][0] == 0 and slices[-1][1] == D
    for (lo, hi), (lo2, _) in zip(slices, slices[1:] + [(D, D)]):
        assert lo < hi == lo2 and lo % guidance.BK == 0
        assert hi % guidance.BK == 0 or hi == D
    # every (b, n) in exactly one score tile, every tile a whole cluster
    seen = torch.zeros(B, N, dtype=torch.int32)
    first = []
    for cta, bs, ns in score_tiles(plan, B, N):
        assert len(bs) <= guidance.BM1 and len(ns) <= guidance.BN1
        seen[bs.start:bs.stop, ns.start:ns.stop] += 1
        first.append(cta)
    assert bool((seen == 1).all())
    assert first == list(range(0, plan.grid1, plan.cluster))
    # every (b, d) in exactly one weighted-sum tile
    assert (plan.tiles_b2, plan.tiles_d2) == (-(-B // guidance.BM2),
                                              -(-D // guidance.BD2))
    out = torch.zeros(B, D, dtype=torch.int32)
    ctas = []
    for cta, bs, ds in sum_tiles(plan, B, D):
        assert len(bs) <= guidance.BM2 and len(ds) <= guidance.BD2
        out[bs.start:bs.stop, ds.start:ds.stop] += 1
        ctas.append(cta)
    assert bool((out == 1).all()) and ctas == list(range(plan.grid2))


def test_guidance_plan_main_shapes_cover_the_card():
    """B=512, N=256: 16 score tiles. The H100 holds only 15 clusters of 8
    (or 7) CTAs at once but 17 of 6, so a cluster of 6 (96 CTAs, one wave)
    beats 8 (two waves); a card that holds 16 clusters of 8 gets 8. The
    weighted sum takes 64 x 128 tiles at every shape: 256 CTAs at D=4096,
    two to an SM, and 104 at D=1568."""
    main = guidance_plan(512, 256, 1024, 3072)
    assert (main.cluster, main.grid1, main.aligned) == (6, 96, True)
    assert (guidance.BM2, guidance.BD2, main.grid2) == (64, 128, 256)
    roomy = guidance_plan(512, 256, 1024, 3072,
                          capacity=(132, 66, 44, 33, 26, 22, 18, 16))
    assert (roomy.cluster, roomy.grid1) == (8, 128)
    exp1 = guidance_plan(512, 256, 784, 784)
    assert (exp1.cluster, exp1.grid1, exp1.k_stages) == (6, 96, 49)
    assert (exp1.tiles_b2, exp1.tiles_d2, exp1.grid2) == (8, 13, 104)
    assert guidance_plan(5, 300, 25, 75).grid2 == 1
    assert [hi - lo for lo, hi in score_slices(exp1, 1568)] == [
        256, 256, 256, 256, 256, 288]
    assert guidance.workspace_floats(512, 256) == 2 * 512 * 256 + 4 * 512 * 8
    # a short MC axis (8 tiles) fits clusters of 8; a long one fills the
    # card without a split of the feature axis
    assert guidance_plan(512, 64, 1024, 3072).cluster == 8
    assert guidance_plan(512, 4096, 1024, 3072).cluster == 1
    # the shared-memory formulas of csrc/flash_guidance.cu
    assert main.smem1 == 4 * (4 * (64 + 128) * 36 + 3 * 128)
    assert main.smem2 == 4 * (4 * 32 * 128 + 2 * 64 * 36 + 3 * 64)
    with pytest.raises(ValueError, match="empty"):
        guidance_plan(0, 4, 4, 4)


def test_guidance_bench_needs_a_card_and_names_kernels():
    """cli/guidance_kernel_bench.py times kernels of the card only: on the
    CPU it refuses; its kernel labels drop namespaces and arguments."""
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        guidance_kernel_bench as bench,
    )
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main([])
    assert bench.short("void (anonymous namespace)::scores_kernel<true>("
                       "(anonymous namespace)::Args)") == "scores_kernel<true>"
    assert bench.short("weighted_sum_kernel<true, 64, 128>(Args)") == (
        "weighted_sum_kernel<true, 64, 128>")


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


def _check_gn_plan(plan, B, C, H, channels_last, max_cluster=8):
    G = min(8, C)
    HW = H * H
    unit = C if channels_last else HW      # a pixel row / a channel
    assert 1 <= plan.cluster <= max_cluster
    assert plan.cluster & (plan.cluster - 1) == 0
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


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("B,C,H,itemsize", GN_CASES)
def test_gn_plan_covers_every_element_once(B, C, H, itemsize,
                                           channels_last):
    _check_gn_plan(gn_plan(B, C, H, H, min(8, C), itemsize, channels_last),
                   B, C, H, channels_last)


GN_BACKWARD_CASES = sorted(
    set(GN_CASES) | {(512, C, H, 4) for C, H in EXP1_RATIO_GN})


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("B,C,H,itemsize", GN_BACKWARD_CASES)
def test_gn_backward_plan_covers_every_element_once(B, C, H, itemsize,
                                                    channels_last,
                                                    max_cluster):
    """The backward cuts x and dy as the forward cuts x, at half the slice
    and in clusters of up to `max_cluster` CTAs: a staged CTA holds the
    slice of both, one mbarrier a sample, within one block's shared
    memory."""
    plan = gn_backward_plan(B, C, H, H, min(8, C), itemsize, channels_last,
                            16, max_cluster)
    _check_gn_plan(plan, B, C, H, channels_last, max_cluster)
    assert plan.samples_per_cta <= groupnorm.MAX_BARRIERS
    if plan.staged:
        assert plan.smem_bytes >= 2 * plan.samples_per_cta * \
            plan.slice_cap * itemsize
    assert plan.slice_cap * itemsize <= 32 * 1024 \
        or plan.cluster == max_cluster \
        or plan.slice_cap == (C if channels_last else H * H)


def test_gn_backward_plan_at_the_ratio_net():
    """The experiment-1 ratio net's GN sites (float32, channels_last, B=512):
    every one stages x and dy, three CTAs an SM at the 28x28 site."""
    plans = {(C, H): gn_backward_plan(512, C, H, H, 8, 4, True)
             for C, H in EXP1_RATIO_GN}
    assert all(p.staged for p in plans.values())
    first = plans[(32, 28)]
    assert (first.cluster, first.vec, first.threads) == (4, 4, 256)
    assert 3 * (first.smem_bytes + 1024) <= 233_472
    assert plans[(128, 3)].samples_per_cta == 2
    assert not gn_backward_plan(256, 128, 3, 3, 8, 4, False).staged


# The flow-matching trainer (float32, B = 128 and a ragged 127): the U-Nets'
# GN sites are the sampler's (C, H) again, EXP2_GN for the SVHN and MNIST-32
# nets, EXP1_GN for the 28-px net (test_training_gn_shapes_match_the_models)
TRAIN_GN_CASES = sorted({(B, C, H) for C, H in EXP2_GN + EXP1_GN
                         for B in (128, 127)})


def test_training_gn_shapes_match_the_models():
    """Every GN site of the three trained U-Nets (35 / 25 / 25 sites) has a
    (C, H) in the training cases."""
    for net, (c_in, h), sites in ((FlowMatchingUNetSVHN(), (3, 32), 35),
                                  (FlowMatchingUNetMNIST(img_size=32),
                                   (1, 32), 25),
                                  (FlowMatchingUNet(), (1, 28), 25)):
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda m, a: seen.append(tuple(a[0].shape[1:3])))
            for m in net.modules() if isinstance(m, GroupNormSiLU)]
        with torch.no_grad():
            net(torch.zeros(1, c_in, h, h), torch.zeros(1))
        for hk in hooks:
            hk.remove()
        assert len(seen) == sites
        assert set(seen) <= {(C, H) for _, C, H in TRAIN_GN_CASES}


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("B,C,H", TRAIN_GN_CASES)
def test_gn_plans_at_the_training_shapes(B, C, H, channels_last):
    """Forward and backward (dx and the dγ/dβ partials per CTA) cover every
    sample, channel and pixel once at the trainer's float32 shapes."""
    _check_gn_plan(gn_plan(B, C, H, H, 8, 4, channels_last), B, C, H,
                   channels_last)
    plan = gn_backward_plan(B, C, H, H, 8, 4, channels_last)
    _check_gn_plan(plan, B, C, H, channels_last)
    if channels_last:
        assert plan.staged


# The ratio-net trainer (experiment 1's RatioEstimatorMNIST, float32, B =
# 128 and 127): conv3x3 -> GN(8)+SiLU at 28, 14, 7 and 3 px in each encoder
RATIO_TRAIN_GN_CASES = sorted({(B, C, H) for C, H in ((32, 28), (64, 14),
                                                      (128, 7), (128, 3))
                               for B in (128, 127)})


def test_ratio_training_gn_shapes_match_the_model():
    """The experiment-1 ratio net runs 8 GN sites, 2 at each (C, H) of the
    ratio training cases."""
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNIST,
    )

    seen = []
    net = RatioEstimatorMNIST()
    for m in net.modules():
        if isinstance(m, GroupNormSiLU):
            m.register_forward_pre_hook(
                lambda m, a: seen.append(tuple(a[0].shape[1:3])))
    with torch.no_grad():
        net(torch.zeros(1, 1, 28, 28), torch.zeros(1, 1, 28, 28))
    assert sorted(seen) == sorted(2 * [(C, H) for B, C, H
                                       in RATIO_TRAIN_GN_CASES if B == 128])


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("B,C,H", RATIO_TRAIN_GN_CASES)
def test_gn_plans_at_the_ratio_training_shapes(B, C, H, channels_last):
    """Forward and backward plans (dx and the per-CTA dγ/dβ partials) cover
    every sample, channel and pixel once at the ratio trainer's shapes. At
    B = 128 / 127 every CTA holds one sample (at B = 512 the 3x3 site takes
    two, test_gn_backward_plan_at_the_ratio_net), so each CTA's dγ/dβ
    partial covers one sample or a slice of one."""
    _check_gn_plan(gn_plan(B, C, H, H, 8, 4, channels_last), B, C, H,
                   channels_last)
    plan = gn_backward_plan(B, C, H, H, 8, 4, channels_last)
    _check_gn_plan(plan, B, C, H, channels_last)
    if channels_last:
        assert plan.samples_per_cta == 1


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


def _gn_sites(net, *inputs):
    """{(C, H)} of the GroupNormSiLU sites a forward of `net` runs."""
    seen = set()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.add(tuple(a[0].shape[1:3])))
        for m in net.modules() if isinstance(m, GroupNormSiLU)]
    with torch.no_grad():
        net(*inputs)
    for hk in hooks:
        hk.remove()
    return seen


def _training_sites():
    """(B, C, H) of every GN site of the trained nets: the SVHN, MNIST-32,
    28-px, --model original and 64-px U-Nets at B = 128 and 64, and both
    ratio nets at B = 128 and 512 (the experiment-2 net normalises with
    BatchNorm and has none)."""
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingModel,
        FlowMatchingUNet64,
    )

    t = torch.zeros(1)
    unets = [(FlowMatchingUNetSVHN(), (torch.zeros(1, 3, 32, 32), t)),
             (FlowMatchingUNetMNIST(img_size=32),
              (torch.zeros(1, 1, 32, 32), t)),
             (FlowMatchingUNet(), (torch.zeros(1, 1, 28, 28), t)),
             (FlowMatchingModel(), (torch.zeros(1, 1, 28, 28), t)),
             (FlowMatchingUNet64(), (torch.zeros(1, 3, 64, 64), t))]
    ratios = [(RatioEstimatorMNIST(), (torch.zeros(1, 1, 28, 28),) * 2),
              (RatioEstimatorMNISTSVHN(), (torch.zeros(1, 1, 32, 32),
                                           torch.zeros(1, 3, 32, 32)))]
    sites = set()
    for nets, batches in ((unets, (128, 64)), (ratios, (128, 512))):
        for net, inputs in nets:
            sites |= {(B, C, H) for C, H in _gn_sites(net, *inputs)
                      for B in batches}
    return sorted(sites)


TRAINING_SITES = _training_sites()


def test_training_sites_cover_the_named_nets():
    """The 64-px U-Net's sites at 64 px are among them, and the ratio
    nets' at B = 512."""
    assert {(64, 96, 64), (64, 288, 64), (128, 192, 32),
            (512, 32, 28), (512, 128, 3)} <= set(TRAINING_SITES)


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_gn_backward_plan_at_every_training_site(channels_last, max_cluster):
    """float32, every GN site of the trained nets: shared memory within one
    block's, the cluster within what the card is asked to hold (8, or 16
    where it holds clusters of 16), every element covered once."""
    for B, C, H in TRAINING_SITES:
        plan = gn_backward_plan(B, C, H, H, 8, 4, channels_last, 16,
                                max_cluster)
        assert plan.smem_bytes <= SMEM_MAX
        _check_gn_plan(plan, B, C, H, channels_last, max_cluster)
        assert plan.samples_per_cta <= groupnorm.MAX_BARRIERS


def test_gn_backward_plan_fills_the_sm_at_the_large_sites():
    """The SVHN U-Net's largest site takes clusters of 16 where the card
    holds them, two CTAs an SM; with clusters of 8 a slice fills an SM
    alone. The 64-px U-Net's 96-channel site stages at
    16; the 288-channel one reads device memory twice, at most two CTAs an
    SM. Small slices keep several CTAs an SM."""
    sm = 233_472                           # shared memory of one SM
    wide = gn_backward_plan(128, 192, 32, 32, 8, 4, True, 16, 16)
    assert (wide.cluster, wide.staged, wide.threads) == (16, True, 288)
    assert 2 * (wide.smem_bytes + 1024) <= sm
    assert wide.smem_bytes == groupnorm._bwd_header_bytes(192, 8, 1) + \
        2 * 64 * 192 * 4
    portable = gn_backward_plan(128, 192, 32, 32, 8, 4, True)
    assert (portable.cluster, portable.staged) == (8, True)
    assert 2 * (portable.smem_bytes + 1024) > sm
    assert gn_backward_plan(64, 96, 64, 64, 8, 4, True, 16, 16).staged
    assert not gn_backward_plan(64, 96, 64, 64, 8, 4, True).staged
    big = gn_backward_plan(64, 288, 64, 64, 8, 4, True, 16, 16)
    assert not big.staged and big.smem_bytes == groupnorm.UNSTAGED_SMEM
    assert 2 * (big.smem_bytes + 1024) <= sm < 3 * (big.smem_bytes + 1024)
    # the widest block of whole multiples of lcm(32, G, C / 4) = 288
    assert big.threads == 288
    assert gn_backward_plan(64, 192, 64, 64, 8, 4, True, 16, 16).threads == 480
    small = gn_backward_plan(512, 32, 28, 28, 8, 4, True, 16, 16)
    assert 4 * (small.smem_bytes + 1024) <= sm


def test_gn_backward_header_matches_the_kernel_source():
    """ops/groupnorm.py:_bwd_header_bytes, MAX_BARRIERS and WIDE_CLUSTER
    equal csrc/group_norm_silu_backward.cu's bwd_header_bytes, kMaxBars and
    kMaxCluster."""
    import re

    src = (_build.CSRC / "group_norm_silu_backward.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kMax\w+) = (\d+);", src)}
    assert consts["kMaxBars"] == groupnorm.MAX_BARRIERS
    assert consts["kMaxCluster"] == groupnorm.WIDE_CLUSTER
    body = re.search(r"bwd_header_bytes\(int C, int G, int spc\) \{\s*"
                     r"return rgmf::round_up\(\s*(.*?),\s*128\);", src,
                     re.S).group(1)
    for C, G, spc in ((192, 8, 1), (32, 8, 4), (768, 8, 1), (96, 16, 2)):
        n = eval(body, {}, dict(C=C, G=G, spc=spc, **consts))
        assert groupnorm._bwd_header_bytes(C, G, spc) == -(-n // 128) * 128
