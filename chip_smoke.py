#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--steps N] [--train_steps N]

Run from the repository root. Imports nothing of JAX. Phases, each of
which fails the script (non-zero exit) on error:

1. versions, the card and its power limit (nvidia-smi);
2. builds the CUDA C++ kernels from csrc/ (all nvcc runs in parallel);
3. holds every hand-written kernel against its plain PyTorch version on
   the card: flash_guidance at both main-path shapes (D = 4096 and the
   experiment-1 D = 1568) for t in {0.05, 0.5, 0.95} plus a ragged shape
   (rtol 1e-3, atol 1e-4 against the plain version run in float64, on
   images that float32 sums exactly), on N(0,1)
   images (fixed draws, and F4_DRAWS fresh draws a width from a generator
   of their own) its scores within their a-priori bound and its g,
   ESS and l within kernel 2's float32 tolerance from those scores
   (ops/guidance.py:bound_ratios), ess and l within rtol 2e-2 of
   the plain version run in float64, at D = 4096 and 1568 (and at
   Dx = 12,288 / Dy = 4,096 below) the kernel's max |err| in g against
   float64 at most twice the float32 plain version's, and two launches on
   the same inputs bit for bit;
   group_norm_silu at every (B, C, H) shape the
   U-Nets and the experiment-1 ratio net run, in channels_last and NCHW
   memory, in bfloat16 (one bf16 step: rtol 2**-7, atol 1e-3) and float32
   (1e-4), plus two odd batches (one leaves a plan of two samples a CTA a
   partial last CTA); fused_gn_silu_conv at every
   (B, C, H, O) shape a ResBlock's norm1 -> conv1 sees in those U-Nets plus
   an odd batch, in float32 (2e-4) and bfloat16 (rtol 0.1, atol 0.15
   against the float32 plain version, and rtol 2**-7, atol 0.05 against
   the bfloat16 plain version); group_norm_silu's backward
   (csrc/group_norm_silu_backward.cu) at every GN shape of the U-Nets and
   the experiment-1 ratio net (at B=N_mc and at B=512, where the 7x7 and
   3x3 sites take two samples a CTA) plus the odd batches, float32 and
   bfloat16,
   NCHW and channels_last, dx alone and with dγ and dβ: in float32 its
   max |err| against the plain backward run in float64 at most twice the
   float32 plain backward's, in bfloat16 one bf16 step from the bfloat16
   plain backward, the forward's saved statistics equal to the plain
   version's bit for bit, and two launches bit for bit; and both GroupNorm
   kernels as a train step runs them at every GN site of the three trained
   U-Nets (SVHN, MNIST-32, 28-px) and the experiment-1 ratio net (its 8
   sites at 28, 14, 7 and 3 px; float32, channels_last, B=128 and 127):
   the forward (1e-4) with its statistics (bit for bit), dx, dγ and dβ
   through autograd (each at most twice the float32 plain backward's
   max |err| against float64) and two launches bit for bit; and, for
   slice 9, flash_guidance at the 64-px path's B=64, N=128, D=24,576
   (quarter-integer and N(0,1) images; the bounds, reruns bit for
   bit), group_norm_silu at every sampler shape of the
   encoder-decoder (FlowMatchingModel), the 64-px U-Nets and ratio net and
   every merged-pair site (2C channels in 16 groups), and both GN kernels
   as a train step runs them at the encoder-decoder's 7 sites and
   FlowMatchingUNet64's 45;
4. checks each experiment's full-width sampler on the card against the
   same sampler on the CPU (plain versions) on a small input, with mc_feng,
   grad and mc_feng+grad guidance, and experiment 1 with --model original;
4m. merged-pair evaluation against the two nets on the card (experiment-1
   U-Nets, float32, both phases): within 5e-5;
4x. the 64-px sampler (narrow U-Nets, float32, D=24,576) on the card and
   the CPU against the CPU run with float64 guidance: the card's max |err|
   at most twice the float32 CPU run's, plus 1e-3;
4s. the same for SMC (sample/smc.py), both experiments: float32 nets, B=8,
   islands of 4, γ=1, 10 steps, the same injected draws; x1, y1 within 1e-3
   and every resampling decision equal;
5. drives the main path once with the launch counters set to 0: random-init
   FlowMatchingUNetMNIST(32) + FlowMatchingUNetSVHN + RatioEstimatorMNISTSVHN,
   bf16 activations, B=512 pairs, N_mc=256, --steps Euler steps (default
   100), mc_feng at γ=0.5; asserts finite outputs, 1 <= ESS <= N_mc and the
   launch counts derived from the code; then profiles a 5-step call;
5e. the same for experiment 1 (MNIST-28 ↔ transformed MNIST): random-init
   FlowMatchingUNet (28 px) x2 in bf16 + RatioEstimatorMNIST (disc,
   float32), B=512, N_mc=256, --steps steps, mc_feng at γ=0.5;
5o. the same with --model original (two FlowMatchingModel in bf16);
5m. 5e's path with --merged_unet (one GN launch per site pair), counted
   and profiled, then two-net and merged calls in turns;
5g. gradient guidance at full width, counted and profiled the same way:
   experiment 1 with mc_feng+grad (γ=0.5, grad_strength 0.5; the ratio
   net's forward and the backward kernel at each of its 8 GN sites every
   step) and experiment 2 with grad (its BatchNorm ratio net runs no GN
   kernel);
5s. SMC at full width on both experiments (phase 5's and 5e's nets, the
   ratio net's last layer redrawn from a seed so that log r̂ varies: see
   SMC_SCORE_STD), B=512, --steps Euler steps, γ=1, each experiment's CLI
   defaults (islands of 8, tau 0.7 / 16, 0.5): launch counts as derived (no
   flash_guidance; one GN launch per site of both U-Nets and the ratio net
   a step), finite samples, 1 <= final ESS <= B, at least one resampling
   event; one 10-step call under torch.cuda.set_sync_debug_mode("warn")
   that fails on a synchronisation from sample/smc.py; a 5-step profile;
5t. flow-matching training at full width (FlowMatchingUNetSVHN and
   FlowMatchingUNetMNIST(32), float32, B=128, Adam lr 1e-4, EMA 0.999):
   one step on the card against the same step on the CPU (B=4, dropout
   off, injected x_0 and t; loss rtol 1e-4, gradients, post-Adam params
   and EMA within 1e-4·max|ref| + 1e-6, the Adam/EMA update from the
   card's own gradients), then --train_steps steps (default 50) through
   the epoch driver with the launch counters set to 0 and held to the
   counts derived from the code (GN forward, backward and its dγ/dβ
   launch once per GN site per step), finite loss, steps/s, images/s,
   peak memory, and a 5-step profile;
5r. ratio-net training at full width (RatioEstimatorMNIST and
   RatioEstimatorMNISTSVHN, disc, float32, B=128, clip 1.0, Adam lr 1e-4,
   EMA 0.999): one step on the card against the same step on the CPU (B=4,
   dropout off, the same batch, the CPU's max-pools routed through the
   card's argmax and the windows whose own argmax differs counted, at most
   1 in 10,000; loss rtol 1e-4, post-clip gradients and BatchNorm running
   statistics within 1e-4·max|ref| + 1e-6, the clip/Adam/EMA update from
   the card's own gradients), then --train_steps
   steps through the epoch driver with metrics-dict steps, the launch
   counters set to 0 and held to 8 GN forward, 8 backward and 8 dγ/dβ
   launches per experiment-1 step and 0 per experiment-2 step (which
   launches the BatchNorm+SiLU forward and backward 12 times each); finite
   metrics, steps/s, pairs/s, peak memory and a 5-step profile;
5f. reflow at full width: flow/reflow.py:generate_couplings with the SVHN
   and MNIST-32 teachers (float32, batches of 512, 100 steps, 2 batches),
   launches held to 100 × GN sites a batch, pairs/s; one reflow step on the
   card against the CPU as in 5t, its launches one per GN site;
5x. the 64-px config at full width: FlowMatchingUNet64 x2 (ch 96) and
   FlexibleRatioEstimator(3, 3) in bf16, one mc_feng chunk at the demo's
   sizes (B=64, N_mc=128, --steps steps, γ=0.5), two-net and merged,
   counted (kernel B 18,008 / 9,008, kernel A 100) and profiled; then one
   FlowMatchingUNet64 trained as in 5t at B=64 (20 counted steps, 45/45/45
   GN launches a step, one step card against CPU). Every full-width
   sampler path prints its convolution and dense FLOP rate
   (core/flops.py) and its share of the bf16 dense peak;
5k. the fused K-step trainer (--fused_steps) at full width: the MNIST-32
   and SVHN U-Nets and both ratio nets (float32, B=128, Adam lr 1e-4, EMA
   0.999, dropout on), all with cuDNN's deterministic algorithms; two
   macro steps of K=8 of the CUDA graph against the eager K-step loop on
   the same draws (bit for bit, else within 1e-4·max|ref|, printed); then
   the single step, the graph at K=1 and at K=8 in turns, twice, 48 steps
   each: steps/s, replays, peak memory, the wrappers' (eager) launches per
   macro step held to K·sites for the single step and 0 for a replay (the
   attention's and the 3×TF32 linear's counters to 0: these nets call
   neither);
   the timed K=8 graph's state against the eager loop on all its draws
   (same bounds); a profiled run of each: the busy share and the GN
   kernels' launches in the trace held to K·sites a macro step;
5d. data-parallel training, two worker processes of this script on the
   card (gloo, ranks sharing it) against one process on the same global
   batches: the MNIST-32 U-Net and the experiment-2 ratio net (BatchNorm,
   disc), dropout off, 10 steps at B=128, SGD (see dp_training_phase):
   at lr 1e-3 the largest difference within 1e-2 of the largest update,
   parameters within 1e-5·max|p|, running statistics within
   1e-4·max|ref| + 1e-6; at lr 1e-2 the share printed beside a one-ulp
   yardstick; steps/s of both;
5p. the MC-sharded guided sampler (parallel/sharded_guidance.py), two
   worker processes, meshes (data 2, mc 1) and (data 1, mc 2): a float32
   check on a small input against this process's single-process sampler
   (1e-3), then experiment 2 at full width (bf16, B=512, N_mc=256, --steps
   steps): finite samples on both ranks, 1 <= ESS <= N_mc, launches as
   derived (flash_guidance once a step on (2, 1), never on (1, 2)), the
   call time and the host time in collectives;
6. times each kernel, its plain version and the library call where one
   exists (scaled_dot_product_attention for flash_guidance's weighted sum),
   beside the kernel's bound at the card's published peak rates;
   flash_guidance at both widths four ways (CUDA events, device time by
   the profiler with L2 warm and cold, host time per call:
   core/card.py:call_times), and
   group_norm_silu at every main-path GN shape (CUDA events, and device
   time by the profiler) beside its bytes bound, summed over one sampler
   call; group_norm_silu_backward at 512x32x28x28 float32 the same four
   ways as flash_guidance, beside its bytes bound, the plain backward and
   the library call (autograd's backward of F.silu(F.group_norm(...))), and
   summed over one experiment-1 grad call's shapes; and (6t) dx with the
   dγ/dβ launch at every GN site of the SVHN U-Net at B=128, the same four
   ways beside its bytes bound, the plain backward and the library call,
   summed over one train step's 35 sites, and the same at the experiment-1
   ratio net's 8 sites (the row 128x32x28x28, and the sum over one ratio
   train step); flash_guidance at D=24,576 (B=64, N=128) the same four
   ways, and group_norm_silu at the 64-px U-Net's largest site
   (64x288x64x64 bf16) beside its bytes bound;
6l. SiT-XL/2 in float32 at the SiT cell's B = 32, one eager forward and
   backward from launch counters at 0: the 3×TF32 linear's launches and
   split pre-passes held to 4 token projections × 28 blocks × 3 roles
   each, and three more such steps timed by CUDA events; then the linear
   bench (cli/linear_kernel_bench.py): SiT-XL/2's four token projections
   at M = 8,192 in each role (forward, dgrad, wgrad) through the wrapper
   and its autograd Function, the kernel with its split pre-pass beside
   its bound (FLOPs over the bf16 peak / 6) and torch.matmul in float32
   (`library_ms`, the products the port no longer calls, which are also
   the plain versions); the bench fails where the kernel breaks the
   3×TF32 rule (3× the float32 product's max |err| against float64, under
   a tenth of the TF32 product's);
6c. runs the tier-C bench (cli/resblock_kernel_bench.py), the path of
   fused_gn_silu_conv, with its launch counter set to 0; the bench holds
   the kernel against the bfloat16 plain version at each of its shapes
   (rtol 2**-7, atol 0.05) and its rows carry the bounds of the kernels
   line (peaks from core/card.py);
7. runs both sampler CLIs on random-init reference-layout .pth files (with
   mc_feng, and with mc_feng+grad and --mc_refresh 2), and both evaluation
   CLIs (methods none, mc_feng, grad and mc_feng+grad, --fid, synthetic
   digits) on random-init flows, ratio nets and classifiers; then the seven
   train CLIs (flows, ratio nets, classifiers) for one epoch on 2560
   synthetic digits (--ema_decay 0.999 where the CLI has it), both sample
   CLIs with and without --ema --ratio_ema on the checkpoints they wrote,
   and both evaluate CLIs (none, mc_feng, mc_feng+grad, --fid, the EMA
   weights) on those checkpoints alone; then cli/reflow.py on those flows
   (x, y, mnist32, svhn: 1024 pairs, 20-step teacher, 1 epoch), both sample
   CLIs with --reflow --num_steps 8 and with --guidance_method smc, and both
   evaluate CLIs with smc;
7v. cli/serve.py's SamplerService and handler in-process on a thread
   (experiment 2 on phase 7's checkpoints, batch 64, 100 steps): /healthz
   and 8 concurrent POSTs mixing none, mc_feng and smc (shapes, finite
   values, fewer dispatches than requests, a repeated seed's samples equal),
   p50 / p90 latency and samples/s;
7 (slice 9). the sample CLI and the service with --merged_unet on the
   trained experiment-1 U-Nets; train_flow --model original (x and y, one
   epoch, --metrics_dir, --profile_dir), then sample and evaluate with
   --model original on what it wrote; cli/config5_demo.py at --n 512
   --epochs 1 --ratio_epochs 1 --num_samples 64 --eval_chunks 2
   --num_steps 20, two-net and --merged_unet.
7 (slice 10). train_flow_mnist32 and train_ratio with --fused_steps 8 for
   one epoch, each graph replay profiled and its GN launches in the trace
   held to 8 × sites, both sample CLIs on what they wrote; train_flow_mnist32 as
   two processes through its multi-process flags (equal losses, the gloo
   backend); cli/stretch64_demo.py at --n 256 --epochs 1 --ratio_epochs 1
   --num_steps 20 (flash_guidance at Dx = 12,288, Dy = 4,096 in its
   mc_feng steps: 40 launches). Phase 3 also holds flash_guidance at that
   shape as at D = 4096 (the bounds, g within twice the float32 plain
   version's error against float64), group_norm_silu at the sharded
   sampler's batches and both GN kernels at the data-parallel ranks' B/2
   training sites; phase 6 times flash_guidance there.
3, 6 (slice 11). Phase 3 forces flash_guidance's score kernel to every
   cluster size 1-8 (B=512, N=256, D=4096, t=0.05; inputs from a generator
   of their own), printing card_capacity beside the built-in CAPACITY:
   quarter-integer images equal to the plain version (1e-3 / 1e-4), no NaN
   (else the plan, the capacity, cudaGetLastError and the NaN counts are
   printed first), ess and l within 2e-2 of float64, g against float64
   printed. Phase 6t also times the backward at the 64-px U-Net's 96- and
   288-channel training sites. Every device time comes from
   core/card.py:device_ms, which counts each kernel launch after a marker,
   and a time below its kernel's bound fails the phase (a bytes bound
   holds the L2-cold reading, and the warm ones past the 50 MB L2).

8q (slice 12). Experiment 1 at full width, trained through the CLIs on
   Q8's budget of synthetic digits (train_classifier, train_flow x and y
   with --fused_steps 8, train_ratio), then `cli.evaluate
   --guidance_methods none mc_feng --guidance_strengths 0 0.3 0.5 1` at
   B=512, N_mc=256, 100 steps, bf16: the classifier's held-out accuracy
   at least 0.9, then mc_feng at γ=0.5 above none by more than 0.1 (the
   JAX capstone's margin), kernel A launched 100 times a mc_feng chunk.
   Q8 is the JAX round-1 budget, and γ = 0.3 and 1.0 are recorded beside
   its figures.

Every phase prints its wall time (`phase ...: N s wall`).

The line before the last is the `kernels` JSON; the card's name and power
limit are printed before it, and before that a `details` JSON line (shapes
and per-shape times, the profiles, the main-path records, the bench rows);
the last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

B_MAIN, N_MC, GAMMA = 512, 256, 0.5
B_TRAIN, TRAIN_STEPS, LR, EMA_DECAY = 128, 50, 1e-4, 0.999
CLI_TRAIN_IMAGES = 2560         # phase 7's synthetic digits: 20 steps an epoch
GRAD_STRENGTH = 0.5
X_SHAPE, Y_SHAPE = (32, 32, 1), (32, 32, 3)
E1_SHAPE = (28, 28, 1)          # experiment 1: both modalities
S64 = (64, 64, 3)               # the 64-px config: both modalities
B64, N64, B64_TRAIN = 64, 128, 64   # its demo's chunk, N_mc and batch
TRAIN64_STEPS = 20
# phase 7's run of cli/config5_demo.py: short, but every step of it
CONFIG5_ARGV = ["--n", "512", "--epochs", "1", "--ratio_epochs", "1",
                "--num_samples", "64", "--eval_chunks", "2", "--num_steps",
                "20"]
TOL_GUIDANCE = dict(rtol=1e-3, atol=1e-4)
F4_DRAWS = 5                      # phase 3: fresh draws of kernel A a width
F4_TWICE = ("D4096", "D1568", "D16384")   # g held to 2x the plain there
TOL_GN_F32 = dict(rtol=1e-4, atol=1e-4)   # bf16: ops/groupnorm.py:TOL_BF16
# tests/test_resblock_pallas.py: float32 2e-4; bf16 against float32 0.1/0.15
# (against the bf16 plain version: ops/resblock.py:TOL_BF16)
TOL_CONV = {"f32": dict(rtol=2e-4, atol=2e-4),
            "bf16_vs_f32": dict(rtol=0.1, atol=0.15)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def ms_str(ms, digits: int = 4) -> str:
    """A time for a printed line; None reads `not measured`."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def check_close(name, got, want, rtol, atol) -> float:
    import torch

    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with its plain version\n{e}")
    return max_abs(got, want)


L2_BYTES = 50e6     # the H100's L2 cache


def check_bound(name, bound_ms, bound_by, bytes_moved, **readings):
    """Fails where a kernel's time reads below its own bound: every reading
    for an operations bound; for a bytes bound the L2-cold reading
    (`device_cold_ms`), and the warm ones only where the bytes moved exceed
    the L2 (a small map may beat the memory bound from the L2). Readings
    that are None (not measured) are skipped."""
    for key, ms in readings.items():
        if ms is None:
            continue
        held = (bound_by != "bytes" or key == "device_cold_ms"
                or bytes_moved > L2_BYTES)
        if held and ms < bound_ms:
            fail(f"{name}: {key} {ms:.4f} ms reads below the kernel's "
                 f"{bound_by} bound {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f}"
                 f" MB moved): the timer under-reads")


def plan_str(plan: dict) -> str:
    """A backward plan (vars of ops/groupnorm.py:GNPlan) in words."""
    return (f"clusters of {plan['cluster']}, {plan['threads']} threads, "
            f"{'staged' if plan['staged'] else 'unstaged'}, "
            f"{plan['smem_bytes']} B shared")


def build_models(dtype, device):
    """Random-init full-width nets, seeded; out_conv perturbed so the
    velocity nets are not identically zero."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNetMNIST,
        FlowMatchingUNetSVHN,
        RatioEstimatorMNISTSVHN,
    )

    torch.manual_seed(0)
    fm_m = FlowMatchingUNetMNIST(img_size=32, dtype=dtype)
    fm_s = FlowMatchingUNetSVHN(dtype=dtype)
    ratio = RatioEstimatorMNISTSVHN(dtype=dtype)
    _perturb_out_convs((fm_m, fm_s), 1)
    return tuple(place_model(m, device) for m in (fm_m, fm_s, ratio))


def build_exp1_models(unet_dtype, device):
    """Experiment 1: two random-init MNIST-28 FlowMatchingUNets in
    `unet_dtype` (out_conv perturbed) and RatioEstimatorMNIST (disc) in
    float32, as the experiment-1 CLI builds it whatever --dtype is."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNet,
        RatioEstimatorMNIST,
    )

    torch.manual_seed(10)
    fm_x = FlowMatchingUNet(dtype=unet_dtype)
    fm_y = FlowMatchingUNet(dtype=unet_dtype)
    ratio = RatioEstimatorMNIST()
    _perturb_out_convs((fm_x, fm_y), 11)
    return tuple(place_model(m, device) for m in (fm_x, fm_y, ratio))


def _perturb_out_convs(nets, seed: int):
    """Perturb the zero-initialised out_conv of U-Nets (the velocity nets
    are identically zero otherwise)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in nets:
            net.out_conv.weight.copy_(
                torch.randn(net.out_conv.weight.shape, generator=g) * 0.02)


def build_original_models(unet_dtype, device):
    """Experiment 1 with `--model original`: two random-init encoder-decoder
    FlowMatchingModels in `unet_dtype` and RatioEstimatorMNIST (disc) in
    float32, as the experiment-1 CLI builds them."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingModel,
        RatioEstimatorMNIST,
    )

    torch.manual_seed(12)
    nets = (FlowMatchingModel(dtype=unet_dtype),
            FlowMatchingModel(dtype=unet_dtype), RatioEstimatorMNIST())
    return tuple(place_model(m, device) for m in nets)


def build_64_models(dtype, device, model_channels: int = 96):
    """The 64-px config: two random-init 64-px U-Nets (FlowMatchingUNet64 at
    model_channels 96, out_conv perturbed) and FlexibleRatioEstimator(3, 3),
    all in `dtype`, as cli/config5_demo.py builds them."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlexibleRatioEstimator,
        FlexibleUNet,
    )

    torch.manual_seed(14)
    kw = dict(in_channels=3, img_size=64, model_channels=model_channels,
              channel_mult=(1, 2, 2, 4), num_res_blocks=2, dtype=dtype)
    nets = (FlexibleUNet(**kw), FlexibleUNet(**kw))
    _perturb_out_convs(nets, 15)
    ratio = FlexibleRatioEstimator(x_channels=3, y_channels=3, dtype=dtype)
    return tuple(place_model(m, device) for m in nets + (ratio,))


def layer_shapes(models, device, x_shape, y_shape, batches=None):
    """Shapes on the main path (B=N_MC in phase A, B=B_MAIN in phase B, or
    the given `batches`: N_mc first), by forward hooks: {(B, C, H): calls}
    of every GroupNormSiLU and {(B, C, H, O): calls} of every ResBlock's
    norm1 -> conv1, per forward pair at that B, plus the ratio net's
    GroupNormSiLU calls on the MC set."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
        ResBlock,
    )

    gn, rb = {}, {}
    hooks = []
    batches = batches or (N_MC, B_MAIN)

    def gn_hook(mod, args):
        B, C, H, _ = args[0].shape
        gn[(B, C, H)] = gn.get((B, C, H), 0) + 1

    def rb_hook(mod, args):
        B, C, H, _ = args[0].shape
        key = (B, C, H, mod.conv1.out_channels)
        rb[key] = rb.get(key, 0) + 1

    for net in models:
        for m in net.modules():
            if isinstance(m, GroupNormSiLU):
                hooks.append(m.register_forward_pre_hook(gn_hook))
            elif isinstance(m, ResBlock):
                hooks.append(m.register_forward_pre_hook(rb_hook))
    with torch.no_grad():
        for B in batches:
            t = torch.full((B,), 0.5, device=device)
            for net, shp in zip(models, (x_shape, y_shape)):
                velocity_fn(net)(torch.zeros((B,) + shp, device=device), t)
        n = batches[0]
        ratio_log_fn(models[2])(torch.zeros((n,) + x_shape, device=device),
                                torch.zeros((n,) + y_shape, device=device))
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    return gn, rb


def ratio_gn_shapes(ratio, device, shape):
    """{(B, C, H): calls} of the GN sites of a ratio net's forward at
    B=B_MAIN, by forward hooks (what gradient guidance runs every step)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import ratio_log_fn
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
    )

    found = {}

    def hook(mod, args):
        key = tuple(args[0].shape[:3])
        found[key] = found.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in ratio.modules()
             if isinstance(m, GroupNormSiLU)]
    with torch.no_grad():
        z = torch.zeros((B_MAIN,) + shape, device=device)
        ratio_log_fn(ratio)(z, z)
    for h in hooks:
        h.remove()
    return found


def gn_sites(net) -> int:
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
    )

    return sum(isinstance(m, GroupNormSiLU) for m in net.modules())


def bn_sites(net) -> int:
    """The fused BatchNorm+SiLU sites of a net (its _BNEncoder blocks):
    12 in the experiment-2 ratio net, 0 elsewhere."""
    from ratio_guided_multimodal_fm_tpu_torch.models.ratio import _BNEncoder

    return sum(len(m.spec) for m in net.modules()
               if isinstance(m, _BNEncoder))


def model_gn_sites(net, *inputs):
    """{(C, H): sites} of a net's GroupNormSiLU inputs, by forward hooks
    on one CPU forward of `inputs` (B=1)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
    )

    found = {}

    def hook(mod, args):
        key = tuple(args[0].shape[1:3])
        found[key] = found.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, GroupNormSiLU)]
    with torch.no_grad():
        net(*inputs)
    for hk in hooks:
        hk.remove()
    return found


def unet_gn_sites(net, c_in: int, h: int):
    """{(C, H): sites} of a U-Net's GroupNormSiLU inputs."""
    import torch

    return model_gn_sites(net, torch.zeros(1, c_in, h, h), torch.zeros(1))


def ratio_train_sites():
    """{(C, H): sites} of the experiment-1 ratio net's GroupNormSiLU
    inputs (its 8 sites: 2 each at 28, 14, 7 and 3 px)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNIST,
    )

    z = torch.zeros(1, 1, 28, 28)
    return model_gn_sites(RatioEstimatorMNIST(), z, z)


def ratio_bn_sites():
    """{(C, H): sites} of the experiment-2 ratio net's BatchNorm+SiLU
    inputs (its 12 sites: 4 in the MNIST encoder, 8 in the SVHN one)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNISTSVHN,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models.ratio import BatchNorm2d

    net = RatioEstimatorMNISTSVHN().eval()
    sites = {}

    def hook(mod, inp, out):
        key = (inp[0].shape[1], inp[0].shape[2])
        sites[key] = sites.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(1, 1, 32, 32), torch.zeros(1, 3, 32, 32))
    for h in hooks:
        h.remove()
    return sites


def bn_sites_layout(dev) -> int:
    """The experiment-2 ratio net's 12 conv outputs in a train-mode forward
    on the card, each the input of a fused BatchNorm+SiLU: fails unless
    every one is channels_last (else the wrapper would copy it); returns
    the fused calls counted."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        place_for_training,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        RatioEstimatorMNISTSVHN,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models.ratio import _BNEncoder
    from ratio_guided_multimodal_fm_tpu_torch.ops import batch_norm_silu

    net = place_for_training(RatioEstimatorMNISTSVHN(), dev)
    formats = []
    hooks = [getattr(enc, f"conv{name}").register_forward_hook(
        lambda m, i, o: formats.append(
            o.is_contiguous(memory_format=torch.channels_last)))
        for enc in net.modules() if isinstance(enc, _BNEncoder)
        for name, _ in enc.spec]
    x = torch.rand(8, 32, 32, 1, device=dev).permute(0, 3, 1, 2)
    y = torch.rand(8, 32, 32, 3, device=dev).permute(0, 3, 1, 2)
    before = batch_norm_silu.launches
    net(x, y).sum().backward()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    calls = batch_norm_silu.launches - before
    if len(formats) != 12 or not all(formats) or calls != 12:
        fail(f"experiment-2 ratio net: conv outputs channels_last {formats}"
             f", {calls} fused BatchNorm+SiLU calls in one forward")
    return calls


def bn_kernels_check(dev, seed: int = 16) -> dict:
    """The BatchNorm+SiLU kernels against their plain versions at each of
    the experiment-2 ratio net's sites, at B_TRAIN, B_TRAIN - 1 and 1, float32
    channels_last (inputs from a generator of their own): the saved
    statistics, running statistics and num_batches_tracked bit for bit, y
    within ops/batchnorm.py:TOL_F32, dx, dγ, dβ through autograd each within
    twice the float32 plain backward's max |err| against the float64 plain
    backward, and a second run bit for bit. Returns the worst errors."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        TOL_F32 as TOL_BN_F32,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
        batch_norm_silu,
        batch_norm_silu_backward_reference,
        batch_norm_silu_reference,
    )

    gen = torch.Generator(dev).manual_seed(seed)
    worst = {"y": 0.0, "dx": [0.0, 0.0], "dgamma": [0.0, 0.0],
             "dbeta": [0.0, 0.0]}

    def fused(x, w, b, run, dy):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = batch_norm_silu(xs, ws, bs, *run)
        saved = y.grad_fn.saved_tensors[3:]
        return y, torch.autograd.grad(y, (xs, ws, bs), dy), saved

    sites = ratio_bn_sites()
    for B in (B_TRAIN, B_TRAIN - 1, 1):
        for (C, H) in sorted(sites):
            name = f"batch_norm_silu B={B} C={C} {H}x{H} f32 channels_last"
            x = (torch.randn(B, C, H, H, generator=gen, device=dev) * 2.0
                 + 0.5).contiguous(memory_format=torch.channels_last)
            w = torch.rand(C, generator=gen, device=dev) + 0.5
            b = torch.randn(C, generator=gen, device=dev) * 0.1
            run = (torch.randn(C, generator=gen, device=dev) * 0.1,
                   torch.rand(C, generator=gen, device=dev) + 0.5,
                   torch.zeros((), dtype=torch.long, device=dev))
            dy = torch.randn(B, C, H, H, generator=gen, device=dev
                             ).contiguous(memory_format=torch.channels_last)
            k_run = tuple(t.clone() for t in run)
            p_run = tuple(t.clone() for t in run)
            y, got, (mean, rstd) = fused(x, w, b, k_run, dy)
            y_p, mean_p, rstd_p = batch_norm_silu_reference(x, w, b, *p_run)
            torch.cuda.synchronize()
            if not (torch.equal(mean, mean_p) and torch.equal(rstd, rstd_p)
                    and all(torch.equal(u, v)
                            for u, v in zip(k_run, p_run))):
                fail(f"{name}: the statistics differ from the plain "
                     f"version's")
            worst["y"] = max(worst["y"], check_close(
                f"{name} y", y.detach(), y_p, **TOL_BN_F32))
            plain = batch_norm_silu_backward_reference(dy, x, w, b, mean,
                                                       rstd)
            exact = batch_norm_silu_backward_reference(
                dy.double(), x.double(), w.double(), b.double(),
                mean.double(), rstd.double())
            for nm, k_, p_, e_ in zip(("dx", "dgamma", "dbeta"), got, plain,
                                      exact):
                err_k = float((k_.double() - e_).abs().max())
                err_p = float((p_.double() - e_).abs().max())
                worst[nm][0] = max(worst[nm][0], err_k)
                worst[nm][1] = max(worst[nm][1], err_p)
                if err_k > 2.0 * err_p + 1e-6:
                    fail(f"{name} {nm}: max |err| against float64 "
                         f"{err_k:.3g} exceeds twice the float32 plain "
                         f"backward's {err_p:.3g}")
            again = fused(x, w, b, tuple(t.clone() for t in run), dy)
            torch.cuda.synchronize()
            if not (torch.equal(y, again[0]) and all(
                    torch.equal(u, v) for u, v in zip(got, again[1]))):
                fail(f"{name}: two runs on the same inputs differ")
    print(f"batch_norm_silu at the experiment-2 ratio net's "
          f"{sum(sites.values())} sites {sorted(sites)}, B={B_TRAIN}, "
          f"{B_TRAIN - 1} and 1, f32 channels_last: statistics and running "
          f"statistics bit for bit, y max |err| {worst['y']:.3g}; dx, dγ, dβ "
          f"max |err| against float64 (kernel / float32 plain): "
          + ", ".join(f"{k} {worst[k][0]:.3g} / {worst[k][1]:.3g}"
                      for k in ("dx", "dgamma", "dbeta"))
          + "; reruns bit-identical")
    return worst


def bn_kernel_times(dev, smi, peak_bw, B=None) -> dict:
    """The BatchNorm+SiLU op at each of the experiment-2 ratio net's sites
    at B (default B_TRAIN), float32 channels_last: the forward (PyTorch's
    x·x and two means, then the kernel) and the backward (reduce and apply
    kernels) timed four ways (core/card.py:call_times), beside the bytes
    bound (read x, write y; read x and dy, write dx: 5 passes), the
    design's 11 passes (forward 6: x·x read and written, two means, the
    kernel's read and write; backward 5 + the reduce's second read of x
    and dy), the plain versions (forward plus backward) and the library
    call (F.silu(F.batch_norm(...)) forward plus autograd's backward to x,
    γ and β); summed over one ratio train step's sites."""
    import torch
    import torch.nn.functional as F

    from ratio_guided_multimodal_fm_tpu_torch.core.card import (
        call_times,
        time_ms,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import batchnorm as bn

    B = B or B_TRAIN
    gen = torch.Generator(dev).manual_seed(17)
    rows, step = {}, {"forward_ms": 0.0, "backward_ms": 0.0, "ms": 0.0,
                      "bound_ms": 0.0, "design_bound_ms": 0.0,
                      "plain_ms": 0.0, "library_ms": 0.0}
    for (C, H), n in sorted(ratio_bn_sites().items()):
        x = (torch.randn(B, C, H, H, generator=gen, device=dev) * 2.0
             + 0.5).contiguous(memory_format=torch.channels_last)
        w = torch.rand(C, generator=gen, device=dev) + 0.5
        b = torch.randn(C, generator=gen, device=dev) * 0.1
        run = (torch.zeros(C, device=dev), torch.ones(C, device=dev),
               torch.zeros((), dtype=torch.long, device=dev))
        dy = torch.randn(B, C, H, H, generator=gen, device=dev
                         ).contiguous(memory_format=torch.channels_last)
        mean, rstd, _ = bn.bn_stats_reference(x)
        fwd = call_times(lambda: bn._launch(x, w, b, *run, bn.EPS), dev,
                         ("bn_silu_apply_kernel", "reduce_kernel",
                          "MulFunctor"), 4, strict=False)
        bwd = call_times(lambda: bn._launch_backward(dy, x, w, b, mean,
                                                     rstd), dev,
                         ("bn_grad_reduce_kernel",
                          "bn_silu_grad_apply_kernel"), 2, strict=False)

        def plain():
            bn.batch_norm_silu_reference(x, w, b, *run)
            bn.batch_norm_silu_backward_reference(dy, x, w, b, mean, rstd)

        xl, wl, bl = (t.clone().requires_grad_(True) for t in (x, w, b))
        rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)

        def library():
            y = F.silu(F.batch_norm(xl, rm, rv, wl, bl, True, 0.1, bn.EPS))
            torch.autograd.grad(y, (xl, wl, bl), dy)

        nbytes = x.numel() * 4
        row = dict(sites_per_step=n, forward=fwd, backward=bwd,
                   bound_ms=5 * nbytes / peak_bw * 1e3,
                   design_bound_ms=11 * nbytes / peak_bw * 1e3,
                   plain_ms=time_ms(plain, dev),
                   library_ms=time_ms(library, dev),
                   plan=vars(bn.bn_plan(x.numel() // C, C)))
        pick = [(r["device_ms"] if r["device_ms"] is not None
                 else r["event_ms"]) for r in (fwd, bwd)]
        row.update(forward_ms=pick[0], backward_ms=pick[1],
                   ms=pick[0] + pick[1])
        rows[f"B{B}_C{C}_H{H}"] = row
        cold = (None if fwd["device_cold_ms"] is None
                or bwd["device_cold_ms"] is None
                else fwd["device_cold_ms"] + bwd["device_cold_ms"])
        check_bound(f"batch_norm_silu B={B} C={C} {H}x{H} forward+backward",
                    row["bound_ms"], "bytes", 5 * nbytes,
                    device_ms=(None if fwd["device_ms"] is None
                               or bwd["device_ms"] is None else row["ms"]),
                    device_cold_ms=cold,
                    event_ms=fwd["event_ms"] + bwd["event_ms"])
        for k in step:
            step[k] += n * row[k]
        print(f"  batch_norm_silu B={B} C={C} {H}x{H} f32: forward "
              f"{ms_str(fwd['device_ms'])} ms (L2 cold "
              f"{ms_str(fwd['device_cold_ms'])}, events "
              f"{fwd['event_ms']:.4f}, host {fwd['host_ms']:.4f}), backward "
              f"{ms_str(bwd['device_ms'])} (L2 cold "
              f"{ms_str(bwd['device_cold_ms'])}, events "
              f"{bwd['event_ms']:.4f}, host {bwd['host_ms']:.4f}); bound "
              f"{row['bound_ms']:.4f} by bytes ({100 * row['bound_ms'] / row['ms']:.1f}"
              f"%), design's 11 passes {row['design_bound_ms']:.4f} "
              f"({100 * row['design_bound_ms'] / row['ms']:.1f}%); plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f} "
              f"(forward + backward); {n} per step  [{smi}]")
    print(f"  batch_norm_silu summed over one experiment-2 ratio train "
          f"step's 12 sites (B={B}): forward {step['forward_ms']:.4f} ms + "
          f"backward {step['backward_ms']:.4f} = {step['ms']:.4f} ms on the "
          f"device, bound {step['bound_ms']:.4f} ms "
          f"({100 * step['bound_ms'] / step['ms']:.1f}%), design's 11 passes "
          f"{step['design_bound_ms']:.4f} "
          f"({100 * step['design_bound_ms'] / step['ms']:.1f}%), plain "
          f"{step['plain_ms']:.4f}, library {step['library_ms']:.4f}  "
          f"[{smi}]")
    return {"sites": rows, "step": step}


def traced(run):
    """(run()'s result, wall seconds, [(kernel, device ms, launches)] by
    device time) of one call of `run` under torch.profiler, counting only
    the device events after the session's marker (core/card.py:
    marked_profile: late in a long process the profiler loses the first
    ~10-70 device events of a session)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.card import (
        after_marker,
        device_events,
        marked_profile,
    )

    with marked_profile(cpu=True) as prof:
        h0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
    events = after_marker(device_events(prof))
    if events is None:
        fail("the profiler's trace lost its marker kernel")
    by = {}
    for name, start, end in events:
        ms, n = by.get(name, (0.0, 0))
        by[name] = (ms + (end - start) / 1e3, n + 1)
    return res, wall, sorted(((k, ms, n) for k, (ms, n) in by.items()),
                             key=lambda r: -r[1])


GN_TRACE_NAMES = {"group_norm_silu": "gn_silu_kernel",
                  "group_norm_silu_backward": "gn_silu_bwd_kernel",
                  "group_norm_silu_backward (dγ/dβ)": "gn_wb_reduce_kernel"}


def gn_traced_launches(by_kernel) -> dict:
    """The GN kernels' launches in a trace, under short_counts' names."""
    return {k: sum(r[2] for r in by_kernel if v in r[0])
            for k, v in GN_TRACE_NAMES.items()}


def profile_call(run, steps: int):
    """Device time by kernel over one profiled call of `run` (a sampler
    call of `steps` steps, outside any counted run)."""
    _, wall, by_kernel = traced(run)
    busy_ms = sum(r[1] for r in by_kernel)
    gn = [r for r in by_kernel if "gn_silu_kernel" in r[0]]
    gn_ms, gn_n = sum(r[1] for r in gn), sum(r[2] for r in gn)
    bwd = [r for r in by_kernel if "gn_silu_bwd_kernel" in r[0]]
    bwd_ms, bwd_n = sum(r[1] for r in bwd), sum(r[2] for r in bwd)
    wb = [r for r in by_kernel if "gn_wb_reduce_kernel" in r[0]]
    wb_ms, wb_n = sum(r[1] for r in wb), sum(r[2] for r in wb)
    print(f"profile ({steps} steps, profiler on): wall {wall * 1e3:.1f} ms, "
          f"kernels {busy_ms:.1f} ms "
          f"({100 * busy_ms / max(wall * 1e3, 1e-9):.0f}% busy); "
          f"group_norm_silu {gn_ms:.1f} ms over {gn_n} launches; its "
          f"backward {bwd_ms:.1f} ms over {bwd_n}, the dγ/dβ reduction "
          f"{wb_ms:.1f} ms over {wb_n} ({100 * gn_ms / max(busy_ms, 1e-9):.1f}"
          f"% / {100 * (bwd_ms + wb_ms) / max(busy_ms, 1e-9):.1f}% of the "
          f"kernel time)")
    for k, ms_k, n in by_kernel[:8]:
        print(f"  {ms_k:9.2f} ms {n:6d}x  {k[:90]}")
    return dict(steps=steps, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                group_norm_silu_ms=gn_ms, group_norm_silu_launches=gn_n,
                group_norm_silu_backward_ms=bwd_ms,
                group_norm_silu_backward_launches=bwd_n,
                gn_weight_grad_reduce_ms=wb_ms,
                gn_weight_grad_reduce_launches=wb_n,
                top=[dict(kernel=k[:120], ms=ms, calls=n)
                     for k, ms, n in by_kernel[:25]])


def run_main_path(name, sampler, models, expected, gen_seed, x_shape,
                  y_shape, steps, smi, method="mc_feng", gamma=GAMMA,
                  batch=None, n_mc=None, flops=None, peak=None):
    """One counted sampler call of `batch` pairs: every launch counter set
    to 0 just before, read just after and held to `expected`; finite
    samples of the right shape and, where the method mixes in mc_feng,
    1 <= ESS <= n_mc; with smc, 1 <= final ESS <= B and at least one
    resampling event. With `flops` (the call's convolution and dense
    FLOPs, core/flops.py) and `peak` ((name, FLOP/s)), the FLOP rate by
    the call's CUDA-event time and its share of that peak. Returns the
    record."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        batch_norm_silu,
        batch_norm_silu_backward,
        flash_guidance,
        fused_gn_silu_conv,
        group_norm_silu,
        group_norm_silu_backward,
        linear_tf32x3,
    )

    batch, n_mc = batch or B_MAIN, n_mc or N_MC
    wrappers = {"flash_guidance": flash_guidance,
                "group_norm_silu": group_norm_silu,
                "group_norm_silu_backward": group_norm_silu_backward,
                "fused_gn_silu_conv": fused_gn_silu_conv,
                "batch_norm_silu": batch_norm_silu,
                "batch_norm_silu_backward": batch_norm_silu_backward,
                "linear_tf32x3": linear_tf32x3}
    dev = next(models[0].parameters()).device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    ev0.record()
    x1, y1, diags = sampler(models, torch.Generator(dev).manual_seed(gen_seed),
                            batch)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - h0
    counts = {k: w.launches for k, w in wrappers.items()}
    dev_s = ev0.elapsed_time(ev1) / 1e3
    if counts != expected:
        fail(f"{name}: launch counts {counts} != derived {expected}")
    if (tuple(x1.shape) != (batch,) + x_shape
            or tuple(y1.shape) != (batch,) + y_shape
            or not bool(torch.isfinite(x1).all())
            or not bool(torch.isfinite(y1).all())):
        fail(f"{name}: non-finite or mis-shaped samples")
    ess_txt = "no ESS (no MC set)"
    if "mc_feng" in method:
        ess = diags["ess"]
        if not (float(ess.min()) >= 1.0 - 1e-4
                and float(ess.max()) <= n_mc * (1 + 1e-4)):
            fail(f"{name}: ESS outside [1, {n_mc}]: [{float(ess.min())}, "
                 f"{float(ess.max())}]")
        ess_txt = f"ESS [{float(ess.min()):.3f}, {float(ess.max()):.3f}]"
    elif method == "smc":
        final_ess, events = float(diags["final_ess"]), float(
            diags["resampled"].sum())
        if not 1.0 - 1e-4 <= final_ess <= batch * (1 + 1e-4):
            fail(f"{name}: final ESS {final_ess} outside [1, {batch}]")
        if not events > 0.0:
            fail(f"{name}: no resampling event in {steps} steps")
        ess_txt = (f"final ESS {final_ess:.1f}, {events:.3f} resampling "
                   "events (sum over steps of the islands' share)")
    elif diags:
        fail(f"{name}: {method} returned diagnostics {sorted(diags)}")
    sps = batch / dev_s
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rate_txt = ""
    if flops is not None:
        rate = flops / dev_s
        rate_txt = (f"; convolutions and dense layers {flops / 1e12:.2f} "
                    f"TFLOP -> {rate / 1e12:.1f} TFLOP/s, "
                    f"{100 * rate / peak[1]:.2f}% of the {peak[0]} peak "
                    f"({peak[1] / 1e12:.0f} TFLOP/s)")
    print(f"{name}: B={batch} "
          + (f"N_mc={n_mc} " if "mc_feng" in method else "")
          + f"steps={steps} bf16 "
          f"{method} γ={gamma}: {dev_s:.3f} s on the card (CUDA events), "
          f"{wall_s:.3f} s wall -> {sps:.1f} samples/s; peak mem "
          f"{peak_gib:.2f} GiB; launches {counts}; {ess_txt}{rate_txt}  "
          f"[{smi}]")
    rec = dict(batch=batch, n_mc=n_mc, steps=steps, method=method,
               seconds_device=dev_s, seconds_wall=wall_s, samples_per_s=sps,
               peak_mem_gib=peak_gib, launches=counts)
    if flops is not None:
        rec.update(flops=flops, flop_per_s=flops / dev_s,
                   peak_share=flops / dev_s / peak[1], peak_used=peak[0])
    if method == "smc":
        rec.update(final_ess=final_ess, resampling_events=events,
                   resampled_per_step=diags["resampled"].tolist())
    return rec


def _train_net(make_net, seed: int, dropout: bool = True):
    """A seeded full-width U-Net, out_conv perturbed (zero-init otherwise,
    which leaves every inner gradient zero); dropout off where asked."""
    import torch

    torch.manual_seed(seed)
    net = make_net()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        net.out_conv.weight.copy_(
            torch.randn(net.out_conv.weight.shape, generator=g) * 0.02)
    if not dropout:
        for m in net.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return net


def _within(a, b, name):
    """max |a - b| <= 1e-4·max|b| + 1e-6, or fail."""
    err, bound = max_abs(a, b), 1e-4 * float(b.abs().max()) + 1e-6
    if not err <= bound:
        fail(f"{name}: max |Δ| {err:.3g} > {bound:.3g}")
    return err / bound


def train_step_card_vs_cpu(name, make_net, shape, dev, reflow=False):
    """One train step (B=4, dropout off, Adam lr 1e-4, EMA 0.999) from the
    same weights and the same injected x_0 and t, on the card and on the
    CPU (plain GN versions): the loss within rtol 1e-4 and each gradient
    within 1e-4·max|ref| + 1e-6. The Adam and EMA update on the card is
    held, within the same bound, to the CPU's update from the card's own
    gradients: the first Adam step divides each gradient element by its
    own size, so an element near eps = 1e-8 whose float32 rounding differs
    between the two runs moves its update by up to lr (PERF.md). With
    `reflow` it is the reflow step (flow/reflow.py: the coupling (x_0, x_1)
    as data, no EMA), and the card step's launches are held to one GN
    forward, backward and dγ/dβ per GN site."""
    import copy

    import torch

    from ratio_guided_multimodal_fm_tpu_torch.flow.reflow import (
        make_reflow_train_step,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        group_norm_silu,
        group_norm_silu_backward,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        create_fm_state,
        make_fm_train_step,
        update_ema,
    )

    what = "reflow" if reflow else "training"
    ema_decay = None if reflow else EMA_DECAY
    net0 = _train_net(make_net, 30, dropout=False)
    g = torch.Generator().manual_seed(31)
    x1, x0 = (torch.randn((4,) + shape, generator=g) for _ in range(2))
    t = torch.rand(4, generator=g)
    cpu = torch.device("cpu")
    out = []
    launches = None
    for d in (dev, cpu):
        st = create_fm_state(copy.deepcopy(net0), d, lr=LR,
                             ema_decay=ema_decay)
        if reflow:
            torch.cuda.synchronize()
            group_norm_silu.launches = group_norm_silu_backward.launches = 0
            group_norm_silu_backward.weight_grad_launches = 0
            loss = make_reflow_train_step()(st, x0.to(d), x1.to(d), t=t.to(d))
            if d == dev:
                launches = {
                    "group_norm_silu": group_norm_silu.launches,
                    "group_norm_silu_backward":
                        group_norm_silu_backward.launches,
                    "group_norm_silu_backward (dγ/dβ)":
                        group_norm_silu_backward.weight_grad_launches}
        else:
            loss = make_fm_train_step(EMA_DECAY)(st, x1.to(d), t=t.to(d),
                                                 x0=x0.to(d))
        out.append((float(loss), st))
    (lc, card), (lp, ref) = out
    if not abs(lc - lp) <= 1e-4 * abs(lp):
        fail(f"{what} {name}: loss on the card {lc} != CPU {lp} (rtol "
             "1e-4)")
    if reflow:
        sites = gn_sites(net0)
        if set(launches.values()) != {sites}:
            fail(f"reflow {name}: the card step's launches {launches} != "
                 f"one per GN site ({sites})")
    rep = copy.deepcopy(net0)
    again = create_fm_state(rep, cpu, lr=LR, ema_decay=ema_decay)
    card_p = dict(card.model.named_parameters())
    worst = {"grad": 0.0, "adam": 0.0, "ema": 0.0}
    for n, p in ref.model.named_parameters():
        worst["grad"] = max(worst["grad"], _within(
            card_p[n].grad.cpu(), p.grad, f"{what} {name}: gradient {n}"))
        dict(rep.named_parameters())[n].grad = card_p[n].grad.cpu()
    again.optimizer.step()
    if not reflow:
        update_ema(again, EMA_DECAY)
    end_to_end = 0.0
    for n, p in again.model.named_parameters():
        worst["adam"] = max(worst["adam"], _within(
            card_p[n].detach().cpu(), p.detach(),
            f"{what} {name}: post-Adam {n}"))
        if not reflow:
            worst["ema"] = max(worst["ema"], _within(
                card.ema[n].cpu(), again.ema[n], f"training {name}: EMA {n}"))
        q = dict(ref.model.named_parameters())[n].detach()
        end_to_end = max(end_to_end, max_abs(card_p[n].detach().cpu(), q)
                         / (1e-4 * float(q.abs().max()) + 1e-6))
    print(f"{what} {name}: one step card == CPU (B=4, dropout off): loss "
          f"{lc:.6f} / {lp:.6f}; worst gradient, post-Adam and EMA |Δ| as "
          f"a share of 1e-4·max|ref| + 1e-6: {worst['grad']:.3g}, "
          f"{worst['adam']:.3g}, {worst['ema']:.3g} (post-Adam against the "
          f"CPU's own step, not held: {end_to_end:.3g})"
          + (f"; card launches {launches}" if reflow else ""))
    rec = dict(card_vs_cpu=dict(loss_card=lc, loss_cpu=lp, **worst,
                                post_adam_vs_cpu_step=end_to_end))
    if reflow:
        rec["launches"] = launches
    return rec


def counted_training(name, state, step, loader, extract, batches, steps,
                     dev, smi, sites, loss_key=None, unit="images",
                     batch=None, bn=0):
    """`steps` train steps at B=`batch` through the epoch driver
    (train/loop.py:train_epochs over `loader`'s epoch 0, `extract` mapped
    over its batches), two warm-up steps before it, with every launch
    counter set to 0 just before the run and held after it to the counts
    derived from the code (GN forward, backward and its dγ/dβ launch once
    per GN site per step, the BatchNorm+SiLU forward and backward once per
    of the `bn` sites); every epoch metric finite; then a profiled
    5-step run on `batches`. Returns the record."""
    import numpy as np
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        batch_norm_silu,
        batch_norm_silu_backward,
        flash_guidance,
        fused_gn_silu_conv,
        group_norm_silu,
        group_norm_silu_backward,
        linear_tf32x3,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
        epoch_data_iter,
        train_epochs,
    )

    batch = batch or B_TRAIN
    for i, b in enumerate(batches[:2]):     # warm-up, outside the count
        step(state, b, RNG(0, dev).generator(9, i))
    wrappers = (flash_guidance, group_norm_silu, group_norm_silu_backward,
                fused_gn_silu_conv, batch_norm_silu,
                batch_norm_silu_backward, linear_tf32x3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    group_norm_silu_backward.weight_grad_launches = 0
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    ev0.record()
    _, _, hist = train_epochs(state, step, epoch_data_iter(loader, extract),
                              1, RNG(42, dev), loss_key=loss_key,
                              log_fn=lambda m: None)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    counts = {w.__name__: w.launches for w in wrappers}
    counts["group_norm_silu_backward (dγ/dβ)"] = \
        group_norm_silu_backward.weight_grad_launches
    expected = {"flash_guidance": 0, "group_norm_silu": steps * sites,
                "group_norm_silu_backward": steps * sites,
                "fused_gn_silu_conv": 0,
                "group_norm_silu_backward (dγ/dβ)": steps * sites,
                "batch_norm_silu": steps * bn,
                "batch_norm_silu_backward": steps * bn,
                "linear_tf32x3": 0}
    if counts != expected:
        fail(f"training {name}: launch counts {counts} != derived "
             f"{expected}")
    metrics = {k: v for k, v in hist[-1].items()
               if k not in ("epoch", "steps_per_sec")}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"training {name}: non-finite epoch metrics {metrics}")
    dev_s = ev0.elapsed_time(ev1) / 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"training {name}: {steps} steps at B={batch} f32, Adam lr {LR}, "
          f"EMA {EMA_DECAY}: {wall:.3f} s wall ({dev_s:.3f} s by CUDA "
          f"events) -> {steps / wall:.2f} steps/s, {steps * batch / wall:.0f}"
          f" {unit}/s; " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     metrics.items())
          + f"; peak mem {peak_gib:.2f} GiB; {sites} GN sites, launches "
          f"{counts}  [{smi}]")
    prof = profile_call(lambda: [step(state, b, RNG(1, dev).generator(0, i))
                                 for i, b in enumerate(batches)], 5)
    return dict(batch=batch, steps=steps, seconds_wall=wall,
                seconds_events=dev_s, steps_per_s=steps / wall,
                **{f"{unit}_per_s": steps * batch / wall},
                loss=metrics["loss"], metrics=metrics,
                peak_mem_gib=peak_gib, gn_sites=sites, launches=counts,
                profile=prof)


def run_training(name, make_net, shape, steps, dev, smi, batch=None):
    """The flow-matching counted run: the full-width U-Net on a dataset
    held on the card (batches gathered there) at B=`batch`, Adam lr 1e-4,
    EMA 0.999."""
    import numpy as np
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
        flow_batches,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        create_fm_state,
        make_fm_train_step,
    )

    batch = batch or B_TRAIN
    net = _train_net(make_net, 40)
    sites = gn_sites(net)
    state = create_fm_state(net, dev, lr=LR, ema_decay=EMA_DECAY)
    step = make_fm_train_step(EMA_DECAY)
    g = torch.Generator(dev).manual_seed(41)
    data = torch.rand(((steps + 7) * batch,) + shape, generator=g,
                      device=dev) * 2.0 - 1.0
    labels = np.zeros(len(data), np.int64)

    class Loader:
        def epoch(self, e):
            batches = flow_batches(data, labels, batch,
                                   np.random.RandomState(e))
            return (b for i, b in enumerate(batches) if i < steps)

    batches = [data[i * batch:(i + 1) * batch] for i in range(5)]
    return counted_training(name, state, step, Loader(), lambda b: b["x"],
                            batches, steps, dev, smi, sites, batch=batch)


def _ratio_net(make_net, seed: int, dropout: bool = True):
    import torch

    torch.manual_seed(seed)
    net = make_net()
    if not dropout:
        for m in net.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return net


class PoolArgmax:
    """A stand-in for F.max_pool2d(x, k) that records each call's argmax
    (`replay` None) or routes the pool through recorded ones (`replay`: the
    indices of another run, in call order). The value is the window's
    maximum either way; only which of two near-tied elements gets the
    gradient can differ."""

    def __init__(self, replay=None):
        self.idx, self.replay = [], replay

    def __call__(self, x, kernel_size, *args, **kwargs):
        import torch
        import torch.nn.functional as F

        y, idx = F.max_pool2d_with_indices(x, kernel_size, *args, **kwargs)
        if self.replay is not None:
            idx = self.replay[len(self.idx)].to(x.device)
            y = x.flatten(2).gather(2, idx.flatten(2)).view_as(y)
            if x.is_contiguous(memory_format=torch.channels_last):
                y = y.contiguous(memory_format=torch.channels_last)
        self.idx.append(idx.detach().cpu())
        return y


def ratio_step_card_vs_cpu(name, make_net, x_shape, y_shape, dev):
    """One ratio train step (disc, B=4, dropout off, clip 1.0, Adam lr 1e-4,
    EMA 0.999) from the same weights on the same batch, on the card and on
    the CPU (plain GN versions): the loss within rtol 1e-4, each post-clip
    gradient and each BatchNorm running statistic within 1e-4·max|ref| +
    1e-6; the card's Adam and EMA update held, within the same bound, to
    the CPU's update from the card's own gradients (phase 5t says why).

    Max-pooling routes the gradient to one element of each 2x2 window; where
    two elements of a window are equal to float32 rounding, the card and the
    CPU may pick different ones (for this batch one of the exp-2 net's
    176,128 windows, in the SVHN encoder's second pool, which moves its
    conv gradients by 231 times the bound; PERF.md, PR 7). So the CPU step routes every pool through
    the card's argmax (PoolArgmax), the windows whose own argmax differs
    are counted (held to at most 1 in 10,000), and the gradients of the
    CPU's own routing are printed beside, not held."""
    import copy

    import torch
    import torch.nn.functional as F

    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        create_ratio_state,
        make_ratio_train_step,
        update_ema,
    )

    net0 = _ratio_net(make_net, 50, dropout=False)
    g = torch.Generator().manual_seed(51)
    x = torch.rand((4,) + x_shape, generator=g) * 2.0 - 1.0
    y = torch.rand((4,) + y_shape, generator=g) * 2.0 - 1.0
    is_real = torch.tensor([1.0, 0.0, 1.0, 0.0])
    cpu = torch.device("cpu")
    pools = {"card": PoolArgmax(), "cpu_own": PoolArgmax()}
    pools["cpu"] = PoolArgmax(replay=pools["card"].idx)
    out = {}
    max_pool2d = F.max_pool2d
    for tag, d in (("card", dev), ("cpu", cpu), ("cpu_own", cpu)):
        st = create_ratio_state(copy.deepcopy(net0), d, lr=LR, clip_norm=1.0,
                                ema_decay=EMA_DECAY)
        F.max_pool2d = pools[tag]
        try:
            met = make_ratio_train_step("disc", EMA_DECAY)(
                st, x.to(d), y.to(d), is_real.to(d))
        finally:
            F.max_pool2d = max_pool2d
        out[tag] = ({k: float(v) for k, v in met.items()}, st)
    (mc, card), (mp, ref) = out["card"], out["cpu"]
    windows = sum(t.numel() for t in pools["card"].idx)
    flips = sum(int((a != b).sum()) for a, b in zip(pools["card"].idx,
                                                   pools["cpu_own"].idx))
    if flips * 10_000 > windows:
        fail(f"ratio training {name}: {flips} of {windows} max-pool windows "
             "pick another argmax on the card than on the CPU")
    own = out["cpu_own"][1].model
    unpinned = max(max_abs(dict(card.model.named_parameters())[n].grad.cpu(),
                           p.grad) / (1e-4 * float(p.grad.abs().max()) + 1e-6)
                   for n, p in own.named_parameters())
    if not abs(mc["loss"] - mp["loss"]) <= 1e-4 * abs(mp["loss"]):
        fail(f"ratio training {name}: loss on the card {mc['loss']} != CPU "
             f"{mp['loss']} (rtol 1e-4)")
    worst = {"grad": 0.0, "bn_stats": 0.0, "adam": 0.0, "ema": 0.0}
    card_sd = card.model.state_dict()
    for k, t in ref.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            worst["bn_stats"] = max(worst["bn_stats"], _within(
                card_sd[k].cpu(), t, f"ratio training {name}: {k}"))
        elif k.endswith("num_batches_tracked") and int(card_sd[k]) != int(t):
            fail(f"ratio training {name}: {k} {int(card_sd[k])} != {int(t)}")
    rep = copy.deepcopy(net0)
    again = create_ratio_state(rep, cpu, lr=LR, clip_norm=1.0,
                               ema_decay=EMA_DECAY)
    card_p = dict(card.model.named_parameters())
    rep_p = dict(rep.named_parameters())
    for n, p in ref.model.named_parameters():
        worst["grad"] = max(worst["grad"], _within(
            card_p[n].grad.cpu(), p.grad, f"ratio training {name}: "
                                          f"post-clip gradient {n}"))
        rep_p[n].grad = card_p[n].grad.cpu()
    again.optimizer.step()
    update_ema(again, EMA_DECAY)
    for n, p in again.model.named_parameters():
        worst["adam"] = max(worst["adam"], _within(
            card_p[n].detach().cpu(), p.detach(),
            f"ratio training {name}: post-Adam {n}"))
        worst["ema"] = max(worst["ema"], _within(
            card.ema[n].cpu(), again.ema[n], f"ratio training {name}: EMA "
                                             f"{n}"))
    print(f"ratio training {name}: one step card == CPU (B=4, dropout off, "
          f"the CPU's max-pools routed through the card's argmax): loss "
          f"{mc['loss']:.6f} / {mp['loss']:.6f}; metrics card {mc}, CPU "
          f"{mp}; worst post-clip gradient, BatchNorm statistics, post-Adam "
          f"and EMA |Δ| as a share of 1e-4·max|ref| + 1e-6: "
          + ", ".join(f"{v:.3g}" for v in worst.values())
          + f"; max-pool windows whose argmax differs: {flips} of {windows} "
          f"(gradients against the CPU's own argmax, not held: "
          f"{unpinned:.3g})")
    return dict(card_vs_cpu=dict(metrics_card=mc, metrics_cpu=mp, **worst,
                                 pool_argmax_flips=flips,
                                 pool_windows=windows,
                                 grad_vs_cpu_own_argmax=unpinned))


def run_ratio_training(name, make_net, x_shape, y_shape, steps, dev, smi):
    """The ratio-net counted run: the full-width net (disc, clip 1.0, Adam
    lr 1e-4, EMA 0.999) on ratio batches of random images and labels held
    on the card (data/pipeline.py:ratio_batches: pairs gathered there,
    is_real moved there), through the epoch driver with metrics-dict steps
    (loss_key 'loss')."""
    import itertools

    import numpy as np
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
        Pairing,
        ratio_batches,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        create_ratio_state,
        make_ratio_train_step,
    )

    net = _ratio_net(make_net, 52)
    sites = gn_sites(net)
    state = create_ratio_state(net, dev, lr=LR, clip_norm=1.0,
                               ema_decay=EMA_DECAY)
    rstep = make_ratio_train_step("disc", EMA_DECAY)
    n = (steps + 7) * B_TRAIN
    g = torch.Generator(dev).manual_seed(53)
    xd = torch.rand((n,) + x_shape, generator=g, device=dev) * 2.0 - 1.0
    yd = torch.rand((n,) + y_shape, generator=g, device=dev) * 2.0 - 1.0
    lab = np.random.RandomState(54)
    xl, yl = lab.randint(0, 10, n), lab.randint(0, 10, n)
    pairing = Pairing(yl)

    def batches_of(e):
        return ratio_batches(xd, xl, yd, pairing, B_TRAIN,
                             np.random.RandomState(e))

    class Loader:
        def epoch(self, e):
            return itertools.islice(batches_of(e), steps)

    return counted_training(
        name, state, lambda s, b, gen: rstep(s, b["x"], b["y"], b["is_real"],
                                             gen),
        Loader(), lambda b: b, list(itertools.islice(batches_of(99), 5)),
        steps, dev, smi, sites, loss_key="loss", unit="pairs",
        bn=bn_sites(net))


def make_sampler(cfg_kw, x_shape=X_SHAPE, y_shape=Y_SHAPE,
                 fm_pair_apply=None):
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
        make_guided_sampler_p,
    )

    cfg = GuidedSamplerConfig(**{"guidance_method": "mc_feng",
                                 "guidance_strength": GAMMA,
                                 "x_shape": x_shape, "y_shape": y_shape,
                                 **cfg_kw})
    return make_guided_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                                 lambda m, y, t: velocity_fn(m)(y, t), cfg,
                                 lambda r, x, y: ratio_log_fn(r)(x, y),
                                 fm_pair_apply=fm_pair_apply)


# SMC needs a ratio net whose log r̂ varies across pairs: the random-init
# nets give a nearly constant one (std 0.003 / 0.05 over noise pairs for
# experiments 2 / 1), on which selection never fires. The SMC phases redraw
# the score MLP's last Linear from a seed with these stds (log r̂ std about
# 1.2 / 0.7 over noise pairs).
SMC_SCORE_STD = {"exp2": 15.0, "exp1": 1.0}
SMC_GAMMA = 1.0


def smc_ratio(ratio, std: float):
    """A copy of `ratio` whose score MLP's last Linear is redrawn N(0, std²)
    from a seed (bias 0)."""
    import copy

    import torch

    net = copy.deepcopy(ratio)
    last = net.score_net[-1]
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        last.weight.copy_(torch.randn(last.weight.shape, generator=g) * std)
        last.bias.zero_()
    return net


def make_smc(cfg_kw):
    """The SMC sampler over (model_x, model_y, ratio) at SMC_GAMMA."""
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.smc import (
        SMCSamplerConfig,
        make_smc_sampler_p,
    )

    cfg = SMCSamplerConfig(**{"guidance_strength": SMC_GAMMA, **cfg_kw})
    return make_smc_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                              lambda m, y, t: velocity_fn(m)(y, t), cfg,
                              lambda r, x, y: ratio_log_fn(r)(x, y))


def smc_card_vs_cpu(name, make_models, std, x_shape, y_shape, dev):
    """Phase 4s: SMC on the card against SMC on the CPU (plain versions),
    full-width float32 nets, B=8, islands of 4, γ=1, 10 Euler steps, the
    same injected draws: x1 and y1 within 1e-3 (phase 4's bound) and the
    per-step `resampled` equal (a decision that flips on a float32 near-tie
    is counted and fails the phase)."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import make_time_grid

    b, g, steps = 8, 4, 10
    gen = torch.Generator().manual_seed(5)
    init = (torch.randn((b,) + x_shape, generator=gen),
            torch.randn((b,) + y_shape, generator=gen))
    draws = [(torch.rand(b // g, generator=gen),
              torch.randn((b,) + x_shape, generator=gen),
              torch.randn((b,) + y_shape, generator=gen), [])
             for _ in make_time_grid(steps)[0]]
    sampler = make_smc(dict(num_steps=steps, x_shape=x_shape,
                            y_shape=y_shape, resample_group=g))
    outs = []
    for d in (dev, torch.device("cpu")):
        fx, fy, r = make_models(torch.float32, d)
        x1, y1, diags = sampler(
            (fx, fy, smc_ratio(r, std)), torch.Generator(d).manual_seed(0),
            b, init_noise=tuple(a.to(d) for a in init),
            step_noise=[(u.to(d), nx.to(d), ny.to(d), m)
                        for u, nx, ny, m in draws])
        outs.append((x1.cpu(), y1.cpu(), diags["resampled"].cpu()))
    (cx, cy, cr), (px, py, pr) = outs
    flips = int((cr != pr).sum())
    print(f"{name} SMC (f32, B={b}, islands of {g}, γ={SMC_GAMMA}, {steps} "
          f"steps, injected draws): resampled per step card {cr.tolist()}, "
          f"CPU {pr.tolist()}; {flips} decision(s) flipped")
    if flips:
        fail(f"{name} SMC: {flips} resampling decision(s) differ between the "
             "card and the CPU")
    if not float(pr.sum()) > 0:
        fail(f"{name} SMC: no resampling event in the card-vs-CPU case")
    for nm, a, bb in (("x1", cx, px), ("y1", cy, py)):
        try:
            torch.testing.assert_close(a, bb, rtol=1e-3, atol=1e-3)
        except AssertionError as e:
            fail(f"{name} SMC on the card != on the CPU ({nm})\n{e}")
    err = max(max_abs(cx, px), max_abs(cy, py))
    print(f"{name} SMC: card == CPU within 1e-3 (max |err| {err:.3g})")
    return dict(resampled=pr.tolist(), flips=flips, max_abs_err=err)


def sync_debug_smc(name, sampler, models, dev):
    """One SMC call under torch.cuda.set_sync_debug_mode('warn'): fails if
    any synchronising call was made from sample/smc.py's own lines; the
    others (in the models or the kernel wrappers) are counted."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sampler(models, torch.Generator(dev).manual_seed(6), B_MAIN)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    own = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs
           if w.filename.endswith(os.path.join("sample", "smc.py"))]
    others = sorted({f"{w.filename}:{w.lineno}" for w in syncs
                     if not w.filename.endswith(os.path.join("sample",
                                                             "smc.py"))})
    print(f"{name}: sync-debug call (10 steps): {len(own)} synchronising "
          f"calls from sample/smc.py, {len(syncs) - len(own)} elsewhere "
          f"{others}")
    if own:
        fail(f"{name}: sample/smc.py synchronises with the device at {own}")
    return dict(smc_py=len(own), elsewhere=len(syncs) - len(own),
                sites=others)


def run_couplings(name, make_net, shape, steps, batches, dev, smi):
    """Phase 5f: generate_couplings with a full-width float32 teacher at
    gen_batch_size B_MAIN, `steps` Euler steps, `batches` batches, the
    launch counters at 0 just before and held to `steps` × GN sites per
    batch; finite couplings; pairs/s and peak memory."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import velocity_fn
    from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
    from ratio_guided_multimodal_fm_tpu_torch.flow.reflow import (
        generate_couplings,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        batch_norm_silu,
        batch_norm_silu_backward,
        flash_guidance,
        fused_gn_silu_conv,
        group_norm_silu,
        group_norm_silu_backward,
        linear_tf32x3,
    )

    net = place_model(_train_net(make_net, 60), dev)
    sites = gn_sites(net)

    def apply(m, x, t):
        return velocity_fn(m)(x, t)

    generate_couplings(apply, net, 0, B_MAIN, shape, num_steps=2,
                       gen_batch_size=B_MAIN, device=dev)        # warm-up
    wrappers = (flash_guidance, group_norm_silu, group_norm_silu_backward,
                fused_gn_silu_conv, batch_norm_silu,
                batch_norm_silu_backward, linear_tf32x3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    h0 = time.perf_counter()
    x0, x1 = generate_couplings(apply, net, 1, batches * B_MAIN, shape,
                                num_steps=steps, gen_batch_size=B_MAIN,
                                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    counts = {w.__name__: w.launches for w in wrappers}
    expected = {"flash_guidance": 0,
                "group_norm_silu": batches * steps * sites,
                "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
                "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                "linear_tf32x3": 0}
    if counts != expected:
        fail(f"reflow couplings {name}: launch counts {counts} != derived "
             f"{expected}")
    if (tuple(x1.shape) != (batches * B_MAIN,) + shape
            or not bool(torch.isfinite(x1).all())):
        fail(f"reflow couplings {name}: non-finite or mis-shaped couplings")
    peak = torch.cuda.max_memory_allocated() / 2**30
    pps = batches * B_MAIN / wall
    print(f"reflow couplings {name}: {batches} batches of {B_MAIN}, {steps} "
          f"Euler steps, f32 teacher: {wall:.3f} s wall -> {pps:.1f} pairs/s; "
          f"peak mem {peak:.2f} GiB; launches {counts} ({sites} GN sites)  "
          f"[{smi}]")
    return dict(batches=batches, batch=B_MAIN, steps=steps, seconds=wall,
                pairs_per_s=pps, peak_mem_gib=peak, gn_sites=sites,
                launches=counts)


def reflow_and_smc_clis(smi):
    """Phase 7, after the train CLIs (in their directory): cli/reflow.py on
    their flow checkpoints for experiment 1 (x and y) and experiment 2
    (mnist32 and svhn) with --pairs 1024 --teacher_steps 20 --epochs 1;
    both sample CLIs with --reflow --num_steps 8 and with --guidance_method
    smc; both evaluate CLIs with smc in --guidance_methods."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        evaluate,
        evaluate_mnist_svhn,
        reflow,
        sample,
        sample_mnist_svhn,
    )

    rec = {}
    for name, extra in (("x", ["--modality", "x"]),
                        ("y", ["--modality", "y"]),
                        ("mnist32", ["--experiment", "mnist_svhn", "--flow",
                                     "mnist32"]),
                        ("svhn", ["--experiment", "mnist_svhn", "--flow",
                                  "svhn"])):
        h0 = time.perf_counter()
        best = reflow.main(["--pairs", "1024", "--teacher_steps", "20",
                            "--epochs", "1"] + extra)
        cli_s = time.perf_counter() - h0
        if not np.isfinite(best):
            fail(f"CLI reflow {name}: best loss {best}")
        print(f"CLI reflow {name} (1024 pairs, 20-step teacher, 1 epoch of 8 "
              f"steps at B=128): {cli_s:.1f} s wall, best loss {best:.4f}  "
              f"[{smi}]")
        rec[f"reflow {name}"] = dict(seconds=cli_s, loss=best)
    written = sorted(f for f in os.listdir("checkpoints") if "reflow" in f)
    want = sorted(f"flow_{m}_reflow_best.pth"
                  for m in ("x", "y_rotate90", "mnist32", "svhn"))
    if written != want:
        fail(f"the reflow CLI wrote {written}, expected {want}")
    for name, cli, flags, steps in (
            ("sample_mnist_svhn", sample_mnist_svhn,
             ["--reflow", "--guidance_method", "mc_feng"], 8),
            ("sample", sample, ["--reflow", "--guidance_method", "mc_feng"],
             8),
            ("sample_mnist_svhn", sample_mnist_svhn,
             ["--guidance_method", "smc"], 20),
            ("sample", sample, ["--guidance_method", "smc"], 20)):
        h0 = time.perf_counter()
        sx, sy, diags = cli.main(["--num_samples", "64", "--num_steps",
                                  str(steps), "--mc_batch_size", str(N_MC)]
                                 + flags)
        cli_s = time.perf_counter() - h0
        key = "smc_ess" if "smc" in flags else "ess"
        if not (bool(torch.isfinite(sx).all())
                and bool(torch.isfinite(sy).all())
                and len(diags[key]) == steps):
            fail(f"CLI {name} {flags}: non-finite samples or a short trace")
        extra = ""
        if "smc" in flags:
            fe = float(diags["final_ess"])
            if not 1.0 - 1e-4 <= fe <= 64 * (1 + 1e-4):
                fail(f"CLI {name} smc: final ESS {fe} outside [1, 64]")
            extra = (f", final ESS {fe:.1f}, "
                     f"{float(diags['resampled'].sum()):.3f} events")
        print(f"CLI {name} {' '.join(flags)} (64 pairs, {steps} steps): "
              f"{cli_s:.1f} s wall{extra}  [{smi}]")
        rec[f"{name} {' '.join(flags)}"] = dict(seconds=cli_s)
    smc_keys = {"smc_final_ess", "smc_resamples", "smc_churn",
                "smc_resample_tau"}
    for name, cli, tau in (("evaluate", evaluate, 0.5),
                           ("evaluate_mnist_svhn", evaluate_mnist_svhn, 0.7)):
        h0 = time.perf_counter()
        results = cli.main(["--guidance_methods", "smc",
                            "--guidance_strengths", "1.0", "--num_steps",
                            "20", "--num_samples", str(B_MAIN // 2),
                            "--fid", "--dtype", "bf16"])
        cli_s = time.perf_counter() - h0
        r = results[0] if len(results) == 1 else {}
        nums = [r.get(k, float("nan")) for k in smc_keys | {"coherence_acc"}]
        if (not smc_keys <= set(r) or not all(np.isfinite(nums))
                or r["smc_resample_tau"] != tau or r["n_chunks"] != 1
                or not 1.0 - 1e-4 <= r["smc_final_ess"] <= B_MAIN // 2):
            fail(f"CLI {name} smc: {results}")
        print(f"CLI {name} smc γ=1 ({B_MAIN // 2} pairs in one chunk, 20 "
              f"steps, bf16, --fid): {cli_s:.1f} s wall; coherence "
              f"{r['coherence_acc']:.3f}, final ESS {r['smc_final_ess']:.1f}, "
              f"resamples {r['smc_resamples']:.3f}  [{smi}]")
        rec[f"{name} smc"] = dict(seconds=cli_s, result=r)
    return rec


def serve_phase(smi):
    """Phase 7v: cli/serve.py's SamplerService and handler in-process on a
    thread (experiment 2 on the checkpoints under ./checkpoints, batch 64,
    100 steps): /healthz, then 8 concurrent POSTs mixing none, mc_feng and
    smc (16 pairs each; two mc_feng requests share a seed), holding shapes,
    finite values, fewer dispatches than requests and identical samples for
    the repeated seed; p50 / p90 latency and samples/s."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli import serve
    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        flash_guidance,
        group_norm_silu,
    )

    h0 = time.perf_counter()
    svc = serve.build_service(serve.make_parser().parse_args(
        ["--batch_size", "64", "--num_steps", "100"]))
    svc.warmup(("none", "mc_feng", "smc"))
    setup_s = time.perf_counter() - h0
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok":
            fail(f"serve: /healthz answered {health}")
        # the first request occupies the dispatcher; the other seven queue
        # behind it grouped by method, so same-method requests coalesce
        reqs = ([("mc_feng", 0.5, 1)] + [("mc_feng", 0.5, s)
                                         for s in (2, 1, 3)]
                + [("none", 0.0, s) for s in (4, 5)]
                + [("smc", 0.5, s) for s in (6, 7)])
        results = [None] * len(reqs)
        base = dict(svc.stats)
        torch.cuda.synchronize()
        flash_guidance.launches = group_norm_silu.launches = 0

        def post(i):
            method, strength, seed = reqs[i]
            body = json.dumps({"num_samples": 16, "guidance_method": method,
                               "guidance_strength": strength,
                               "seed": seed}).encode()
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"{url}/sample", data=body, method="POST"),
                        timeout=600) as r:
                    out = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 — reported below
                out = {"error": repr(e)}
            results[i] = (time.perf_counter() - t0, out)

        t_all = time.perf_counter()
        threads = []
        for i in range(len(reqs)):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
            time.sleep(0.3 if i == 0 else 0.05)
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_all
        launches = {"flash_guidance": flash_guidance.launches,
                    "group_norm_silu": group_norm_silu.launches}
        if any(th.is_alive() for th in threads) or None in results:
            fail("serve: a request did not finish")
        samples = []
        for (method, _, seed), (lat, out) in zip(reqs, results):
            if "data_b64" not in out:
                fail(f"serve: {method} seed {seed} failed: {out}")
            z = np.load(io.BytesIO(base64.b64decode(out["data_b64"])))
            if (z["x"].shape != (16, 32, 32, 1)
                    or z["y"].shape != (16, 32, 32, 3)
                    or not np.isfinite(z["x"]).all()
                    or not np.isfinite(z["y"]).all()):
                fail(f"serve: {method} seed {seed}: shapes {z['x'].shape}, "
                     f"{z['y'].shape} or non-finite samples")
            samples.append((z["x"], z["y"]))
        d = svc.stats["dispatches"] - base["dispatches"]
        n = svc.stats["requests"] - base["requests"]
        if not (n == len(reqs) and d < n):
            fail(f"serve: {d} dispatches for {n} requests (no coalescing)")
        if not (np.array_equal(samples[0][0], samples[2][0])
                and np.array_equal(samples[0][1], samples[2][1])):
            fail("serve: two mc_feng requests with seed 1 gave different "
                 "samples (max |Δ| "
                 f"{np.abs(samples[0][0] - samples[2][0]).max():.3g})")
        if launches["flash_guidance"] % 100 or not launches[
                "flash_guidance"]:
            fail(f"serve: flash_guidance launched "
                 f"{launches['flash_guidance']} times, not 100 per mc_feng "
                 "batch")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    lat = np.array([r[0] for r in results])
    rec = dict(setup_s=setup_s, requests=len(reqs), dispatches=d,
               coalesced_max=svc.stats["coalesced_max"],
               latency_p50_s=float(np.percentile(lat, 50)),
               latency_p90_s=float(np.percentile(lat, 90)),
               seconds=wall, samples_per_s=16 * len(reqs) / wall,
               launches=launches)
    print(f"serve (experiment 2, batch 64, 100 steps, the phase-7 "
          f"checkpoints): start-up and warm-up {setup_s:.1f} s; 8 concurrent "
          f"POSTs of 16 pairs (mc_feng x4, none x2, smc x2) in {wall:.2f} s "
          f"-> {rec['samples_per_s']:.1f} samples/s; latency p50 "
          f"{rec['latency_p50_s']:.2f} s, p90 {rec['latency_p90_s']:.2f} s; "
          f"{d} dispatches for 8 requests; repeated seed identical; "
          f"launches {launches}  [{smi}]")
    return rec


def merged_card_vs_two_net(dev):
    """Phase 4m: merged-pair evaluation against the two nets on the card,
    both in float32: the experiment-1 U-Nets (full width), mc_feng, B=8,
    N_mc=16, 4 steps, phase A drawn inside from one seeded generator; x1 and
    y1 within 5e-5 (the bound of the JAX package's
    tests/test_merged_unet.py). Returns the max |Δ|."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
        merged_pair_apply,
    )

    models = build_exp1_models(torch.float32, dev)
    outs = []
    for pair in (None, merged_pair_apply(models[0])):
        x1, y1, _ = make_sampler(dict(num_steps=4, mc_batch_size=16),
                                 E1_SHAPE, E1_SHAPE, pair)(
            models, torch.Generator(dev).manual_seed(5), 8)
        outs.append((x1, y1))
    err = max(max_abs(a, b) for a, b in zip(*outs))
    if not err <= 5e-5:
        fail(f"merged-pair sampler on the card != two-net sampler: max |Δ| "
             f"{err:.3g} > 5e-5")
    print(f"experiment-1 sampler, --merged_unet against two nets on the card "
          f"(f32, B=8, N_mc=16, 4 steps, both phases): max |Δ| {err:.3g} "
          f"(bound 5e-5)")
    return err


def sampler64_card_vs_cpu(dev):
    """Phase 4x: the 64-px sampler (narrow U-Nets, ch 16, and
    FlexibleRatioEstimator(3, 3), float32; mc_feng, B=4, N_mc=16, 4 steps,
    injected noise and MC set) on the card and on the CPU, each held to a
    yardstick: the CPU run with the guidance (and so the state) in float64.
    At D = 24,576 the scores are ~6x those at D = 4,096 and two correct
    float32 runs differ on near-tied rows beyond phase 4's 1e-3 (ROADMAP
    F4), so the card's max |err| against the yardstick may be at most twice
    the float32 CPU run's, plus 1e-3."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
        flash_guidance_reference,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample import guided

    g = torch.Generator().manual_seed(6)
    inj = [torch.randn((n,) + S64, generator=g) for n in (4, 4, 16, 16)]
    inj.append(torch.exp(torch.randn(16, generator=g)))
    sampler = make_sampler(dict(num_steps=4, mc_batch_size=16), S64, S64)
    cpu = torch.device("cpu")

    def run(d):
        x1, y1, _ = sampler(build_64_models(torch.float32, d, 16),
                            torch.Generator(d).manual_seed(0), 4,
                            mc_set=tuple(a.to(d) for a in inj[2:]),
                            init_noise=(inj[0].to(d), inj[1].to(d)))
        return x1.double().cpu(), y1.double().cpu()

    card, plain = run(dev), run(cpu)
    kernel = guided.flash_guidance
    guided.flash_guidance = lambda *a: flash_guidance_reference(
        *a, torch.float64)
    try:
        exact = run(cpu)
    finally:
        guided.flash_guidance = kernel
    err_k, err_p = (max(float((a - e).abs().max()) for a, e in zip(r, exact))
                    for r in (card, plain))
    if not err_k <= 2.0 * err_p + 1e-3:
        fail(f"64-px sampler: card max |err| against the float64-guidance "
             f"CPU run {err_k:.3g} > twice the float32 CPU run's "
             f"{err_p:.3g} + 1e-3")
    print(f"64-px sampler (ch 16, f32, B=4, N_mc=16, 4 steps, D=24576): max "
          f"|err| against the float64-guidance CPU run: card {err_k:.3g}, "
          f"float32 CPU {err_p:.3g} (card held to 2x + 1e-3)")
    return dict(card_err=err_k, cpu_f32_err=err_p)


def slice9_clis(smi):
    """Phase 7, slice 9, in the train CLIs' directory: the sample CLI and
    the service with --merged_unet on the experiment-1 U-Net checkpoints;
    then, in a subdirectory with the trained ratio net and classifier,
    train_flow --model original (x and y, one epoch, --metrics_dir and
    --profile_dir) and the sample and evaluate CLIs with --model original
    on what it wrote; then cli/config5_demo.py at a short setting that
    covers every step, two-net and --merged_unet (the second run reloads
    the first run's checkpoints)."""
    import shutil

    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        config5_demo,
        evaluate,
        sample,
        serve,
        train_flow,
    )

    rec = {}
    argv = ["--guidance_method", "mc_feng", "--num_samples", "64",
            "--num_steps", "20", "--mc_batch_size", str(N_MC)]
    out = {}
    for tag, extra in (("two-net", []), ("merged", ["--merged_unet"])):
        h0 = time.perf_counter()
        out[tag] = sample.main(argv + extra)
        rec[f"sample {tag}"] = time.perf_counter() - h0
        x1, y1, diags = out[tag]
        if not (bool(torch.isfinite(x1).all()) and bool(
                torch.isfinite(y1).all()) and len(diags["ess"]) == 20):
            fail(f"CLI sample {extra}: non-finite samples or a short trace")
    diff = max(max_abs(a, b) for a, b in zip(out["two-net"][:2],
                                             out["merged"][:2]))
    print(f"CLI sample --merged_unet on the trained experiment-1 flows "
          f"(mc_feng, 64 pairs, 20 steps, f32): {rec['sample merged']:.1f} s "
          f"wall (two nets {rec['sample two-net']:.1f} s); max |Δ| against "
          f"the two-net run {diff:.3g} (not held: phase 4m holds 5e-5)  "
          f"[{smi}]")
    h0 = time.perf_counter()
    svc = serve.build_service(serve.make_parser().parse_args([
        "--experiment", "mnist_transform", "--merged_unet", "--batch_size",
        "64", "--num_steps", "20", "--mc_batch_size", str(N_MC)]))
    if svc._fm_pair is None:
        fail("serve --merged_unet: the experiment-1 flows were not merged")
    x, y, _ = svc.sample(16, "mc_feng", 0.5, seed=3)
    rec["serve merged"] = time.perf_counter() - h0
    if x.shape != (16,) + E1_SHAPE or not (np.isfinite(x).all()
                                            and np.isfinite(y).all()):
        fail(f"serve --merged_unet: samples {x.shape}, finite "
             f"{np.isfinite(x).all() and np.isfinite(y).all()}")
    print(f"serve --experiment mnist_transform --merged_unet: start-up and "
          f"one mc_feng request of 16 pairs (batch 64, 20 steps) "
          f"{rec['serve merged']:.1f} s wall  [{smi}]")

    os.makedirs(os.path.join("original", "checkpoints"))
    for f in ("ratio_disc_rotate90_best.pth", "mnist_classifier.pth"):
        shutil.copy(os.path.join("checkpoints", f),
                    os.path.join("original", "checkpoints", f))
    cwd = os.getcwd()
    os.chdir("original")
    try:
        for modality in ("x", "y"):
            h0 = time.perf_counter()
            state, best, hist = train_flow.main([
                "--model", "original", "--modality", modality, "--epochs",
                "1", "--batch_size", str(B_TRAIN), "--metrics_dir", "m",
                "--profile_dir", "p"])
            rec[f"train_flow original {modality}"] = time.perf_counter() - h0
            with open(os.path.join("m", f"flow_{modality}.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            if (not np.isfinite(best) or len(rows) != 1 or set(rows[0])
                    != {"step", "time", "loss", "steps_per_sec"}):
                fail(f"CLI train_flow --model original: best {best}, "
                     f"metrics {rows}")
        traces = os.listdir("p")
        # per run, the profiler's trace and the port's spans beside it
        if sorted(t.split("_")[0] for t in traces) != ["spans", "spans",
                                                         "trace", "trace"]:
            fail(f"train_flow --profile_dir wrote {traces}")
        print(f"CLI train_flow --model original x, y (1 epoch at B="
              f"{B_TRAIN}, --metrics_dir, --profile_dir): "
              f"{rec['train_flow original x']:.1f} / "
              f"{rec['train_flow original y']:.1f} s wall, loss "
              f"{rows[0]['loss']:.4f}, {rows[0]['steps_per_sec']:.2f} steps/s "
              f"(profiler on), traces {traces}  [{smi}]")
        h0 = time.perf_counter()
        x1, y1, diags = sample.main(argv + ["--model", "original", "--dtype",
                                            "bf16"])
        rec["sample original"] = time.perf_counter() - h0
        if not (bool(torch.isfinite(x1).all())
                and bool(torch.isfinite(y1).all())):
            fail("CLI sample --model original: non-finite samples")
        h0 = time.perf_counter()
        results = evaluate.main([
            "--model", "original", "--guidance_methods", "none", "mc_feng",
            "--guidance_strengths", "0", str(GAMMA), "--num_steps", "20",
            "--num_samples", str(B_MAIN // 2), "--mc_batch_size", str(N_MC),
            "--fid", "--dtype", "bf16"])
        rec["evaluate original"] = time.perf_counter() - h0
        if len(results) != 3 or not all(
                np.isfinite(r["coherence_acc"])
                and np.isfinite(r["classifier_fid_x"]) for r in results):
            fail(f"CLI evaluate --model original: {results}")
        print(f"CLI sample / evaluate --model original on the flows "
              f"train_flow wrote (bf16, 20 steps): {rec['sample original']:.1f}"
              f" / {rec['evaluate original']:.1f} s wall; coherence "
              + ", ".join(f"{r['method']}@{r['guidance_strength']} "
                          f"{r['coherence_acc']:.3f}" for r in results)
              + f"  [{smi}]")
    finally:
        os.chdir(cwd)

    os.makedirs("config5")
    os.chdir("config5")
    try:
        c5 = CONFIG5_ARGV
        for tag, extra in (("two-net", []), ("merged", ["--merged_unet"])):
            h0 = time.perf_counter()
            res = config5_demo.main(c5 + extra)
            rec[f"config5_demo {tag}"] = time.perf_counter() - h0
            if (len(res["eval"]) != 4 or not all(r["finite"]
                                                 for r in res["eval"])
                    or (res["fm_params_per_modality"] != 37_375_683
                        and "--model_channels" not in c5)):
                fail(f"cli/config5_demo.py {extra}: {res}")
            print(f"CLI config5_demo {' '.join(c5 + extra)}: "
                  f"{rec[f'config5_demo {tag}']:.1f} s wall; sources "
                  f"{res['data_sources']}, classifier acc "
                  f"{res['classifier_acc']}; " + ", ".join(
                      f"γ={r['gamma']} coherence {r['coherence']} "
                      f"{r['samples_per_sec']} samples/s"
                      for r in res["eval"]) + f"  [{smi}]")
            rec[f"config5_demo {tag} eval"] = res["eval"]
    finally:
        os.chdir(cwd)
    return rec


# ---- slice 10: the fused K-step trainer, data-parallel training and the
#      MC-sharded sampler on torch.distributed, the stretch demo ---------

K_FUSED = 8          # --fused_steps of phase 5k and phase 7
FUSED_STEPS = 48     # optimizer steps of each timed phase-5k run
FUSED_DATA = 4096    # images of phase 5k's datasets on the card
DP_STEPS = 10        # phase 5d's steps, two processes against one
DP_LRS = (1e-3, 1e-2)  # phase 5d's SGD rates: the first's update is per
                       # element about the CLIs' Adam update at lr 1e-4
DP_SHARE = 1e-2      # phase 5d at lr 1e-3: the largest difference as a share
                     # of the largest update (a rank's rows lost: ~0.5)
SHARD_SMALL = (16, 32, 10)   # phase 5p's float32 check: B, N_mc, steps
MESHES = ((2, 1), (1, 2))    # phase 5p: (data, mc)
STRETCH64_ARGV = ["--n", "256", "--epochs", "1", "--ratio_epochs", "1",
                  "--num_steps", "20"]


def sit_linear_step(dev, smi, batch: int = 32, steps: int = 3) -> dict:
    """SiT-XL/2 in float32 (32×32×4 latents, 1,000 classes) at `batch`:
    one eager forward and backward of a squared-output loss from launch
    counters at 0, whose 3×TF32 linear launches and split pre-passes are
    held to 4 token projections × depth × 3 roles each (forward, dgrad,
    wgrad; every other product of the net is F.linear); then `steps` more
    such steps timed by CUDA events."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.card import time_ms
    from ratio_guided_multimodal_fm_tpu_torch.models.sit import SiT_XL_2
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts

    torch.manual_seed(0)
    net = SiT_XL_2(input_size=32, in_channels=4, num_classes=1000).to(dev)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(batch, 4, 32, 32, generator=g, device=dev)
    t = torch.rand(batch, generator=g, device=dev)
    y = torch.randint(0, 1000, (batch,), generator=g, device=dev)

    def step():
        net.zero_grad(set_to_none=True)
        net(x, t, y).square().mean().backward()

    reset_launches()
    step()
    torch.cuda.synchronize()
    counts = launch_counts()
    depth = len(net.blocks)
    got = {k: counts[f"linear_tf32x3.{k}"]
           for k in ("launches", "split_launches")}
    want = 4 * depth * 3
    if got != {"launches": want, "split_launches": want}:
        fail(f"SiT-XL/2 eager step: linear_tf32x3 counted {got}, derived "
             f"{want} launches and {want} pre-passes (4 sites x {depth} "
             f"blocks x 3 roles)")
    step_ms = time_ms(step, dev, steps, 0)
    print(f"  SiT-XL/2 eager step at B={batch}: linear_tf32x3 "
          f"{got['launches']} launches and {got['split_launches']} "
          f"pre-passes (4 x {depth} x 3), {step_ms:.1f} ms a step by CUDA "
          f"events over {steps}  [{smi}]")
    del net
    torch.cuda.empty_cache()
    return dict(batch=batch, depth=depth, **got, step_ms=step_ms,
                steps_timed=steps)


def reset_launches():
    """Every wrapper's launch counters to 0."""
    from ratio_guided_multimodal_fm_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def short_counts(counts):
    return {k.replace(".launches", "").replace(".weight_grad_launches",
                                               " (dγ/dβ)"): v
            for k, v in counts.items()}


def _fused_models():
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNetMNIST,
        FlowMatchingUNetSVHN,
        RatioEstimatorMNIST,
        RatioEstimatorMNISTSVHN,
    )

    return (("MNIST-32 U-Net", lambda: FlowMatchingUNetMNIST(img_size=32),
             "fm", (32, 32, 1), None),
            ("SVHN U-Net", FlowMatchingUNetSVHN, "fm", (32, 32, 3), None),
            ("experiment-1 ratio", RatioEstimatorMNIST, "ratio", E1_SHAPE,
             E1_SHAPE),
            ("experiment-2 ratio", RatioEstimatorMNISTSVHN, "ratio",
             X_SHAPE, Y_SHAPE))


def _fresh_state(make_net, kind, dev, seed=40, dropout=True):
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    if kind == "fm":
        return S.create_fm_state(_train_net(make_net, seed, dropout), dev,
                                 lr=LR, ema_decay=EMA_DECAY)
    return S.create_ratio_state(_ratio_net(make_net, seed, dropout), dev,
                                lr=LR, ema_decay=EMA_DECAY)


def _state_arrays(state):
    out = {"p:" + k: v.detach() for k, v in state.model.state_dict().items()
           if v.is_floating_point()}
    out.update({"e:" + k: v.detach() for k, v in (state.ema or {}).items()})
    return out


def before_batchnorm(model) -> set:
    """The state keys of the conv biases that a BatchNorm follows (the
    experiment-2 ratio net's encoders: convN -> bnN): their gradient is
    zero in exact arithmetic, so Adam moves them by float32 noise, about
    ±lr a step, whichever the order of the sums."""
    from ratio_guided_multimodal_fm_tpu_torch.models.ratio import (
        BatchNorm2d,
    )

    bns = {n for n, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    out = set()
    for n, _ in model.named_parameters():
        head, _, leaf = n.rpartition(".")
        prefix, _, conv = head.rpartition(".")
        bn = (prefix + "." if prefix else "") + conv.replace("conv", "bn", 1)
        if leaf == "bias" and conv.startswith("conv") and bn in bns:
            out |= {"p:" + n, "e:" + n}
    return out


def _state_diff(a, b):
    """(max |a-b| over every float tensor of two states but the conv
    biases before a BatchNorm, max |b| over the same, max |a-b| over those
    biases)."""
    ta, tb = _state_arrays(a), _state_arrays(b)
    free = before_batchnorm(b.model)
    held = [k for k in tb if k not in free]
    return (max(float((ta[k] - tb[k]).abs().max()) for k in held),
            max(float(tb[k].abs().max()) for k in held),
            max([float((ta[k] - tb[k]).abs().max()) for k in tb
                 if k in free] or [0.0]))


def _graph_vs_eager(name, what, sg, se, lg, le):
    """Hold a graph-trained state to the eager K-step loop's on the same
    draws: bit for bit expected, else within 1e-4·max|ref| (the conv
    biases before a BatchNorm not held, their difference printed)."""
    diff, scale, free = _state_diff(sg, se)
    loss_rel = abs(float(lg) - float(le)) / max(abs(float(le)), 1e-30)
    bitwise = diff == 0.0 and free == 0.0 and float(lg) == float(le)
    if not bitwise and (diff > 1e-4 * scale or loss_rel > 1e-4):
        fail(f"fused {name}: {what}: the graph's state differs from the "
             f"eager loop's by {diff:.3g} (bound {1e-4 * scale:.3g}), loss "
             f"rel {loss_rel:.3g}")
    print(f"fused {name}: {what}: CUDA graph == eager K-step loop "
          + ("bit for bit (parameters, EMA, buffers, losses)" if bitwise else
             f"within 1e-4·max|ref|: max |Δ| {diff:.3g} (bound "
             f"{1e-4 * scale:.3g}), loss rel {loss_rel:.3g}"
             + (f"; the conv biases before a BatchNorm (zero gradient in "
                f"exact arithmetic, not held) {free:.3g}" if free else "")
             + " (not bit for bit)"))
    return dict(bitwise=bitwise, max_abs_diff=diff, bound=1e-4 * scale,
                loss_rel=loss_rel, before_batchnorm_max_abs_diff=free)


def fused_training_phase(dev, smi, steps=None, batch=None, k_fused=None):
    """5k: the fused K-step trainer at full width (float32, TF32 off, Adam
    lr 1e-4, EMA 0.999, dropout on), all of it with cuDNN's deterministic
    algorithms (its default wgrad kernels add with atomics, so two eager
    runs differ, and a conv bias before a BatchNorm then drifts by ±lr a
    step and its running mean with it). Per net: two macro steps of the
    CUDA graph against the eager K-step loop on the same draws; then the
    plain single step (--fused_steps 1), the graph at K=1 and at K=8 in
    turns, twice, `steps` optimizer steps each: steps/s, graph replays,
    peak memory, the wrappers' counts (the eager launches: K·sites a macro
    step for the single step, none in a replay); then the timed K=8
    graph's state against the eager loop on all the draws it took; then a
    profile of each variant, whose trace gives the busy share and the GN
    kernels' launches, held to K·sites a macro step (a replay's launches
    show only there)."""
    import torch

    steps, batch = steps or FUSED_STEPS, batch or B_TRAIN
    k_fused = k_fused or K_FUSED
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, make_net, kind, xs, ys in _fused_models():
            out[name] = _fused_net(name, make_net, kind, xs, ys, dev, smi,
                                   steps, batch, k_fused)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _fused_net(name, make_net, kind, xs, ys, dev, smi, steps, batch,
               k_fused):
    import numpy as np
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    g = torch.Generator(dev).manual_seed(7)
    xa = torch.rand((FUSED_DATA,) + xs, generator=g, device=dev) * 2 - 1
    ya = (torch.rand((FUSED_DATA,) + ys, generator=g, device=dev) * 2 - 1
          if ys else None)
    sites = gn_sites(make_net())
    bn = bn_sites(make_net())
    host = np.random.RandomState(3)

    def chunk(k):
        idx = host.randint(0, FUSED_DATA, (k, batch)).astype(np.int32)
        if kind == "fm":
            return (idx,)
        return (idx, host.randint(0, FUSED_DATA, (k, batch)).astype(
            np.int32), (host.rand(k, batch) < 0.5).astype(np.float32))

    def trainer(graph=None):
        if kind == "fm":
            f = S.make_fm_train_multistep(EMA_DECAY, graph=graph)
            return f, lambda s, c, gen: f(s, xa, c[0], gen)
        f = S.make_ratio_train_multistep("disc", EMA_DECAY, graph=graph)
        return f, lambda s, c, gen: f(s, xa, ya, *c, gen)["loss"]

    # the graph against the eager K-step loop, two macro steps
    sg, se = (_fresh_state(make_net, kind, dev) for _ in range(2))
    (_, run_g), (_, run_e) = trainer(), trainer(graph=False)
    for m in range(2):
        c = chunk(k_fused)
        lg = run_g(sg, c, torch.Generator(dev).manual_seed(100 + m))
        le = run_e(se, c, torch.Generator(dev).manual_seed(100 + m))
        if not bool(torch.isfinite(lg)):
            fail(f"fused {name}: non-finite loss")
    torch.cuda.synchronize()
    rec = dict(gn_sites=sites, graph_vs_eager=_graph_vs_eager(
        name, f"2 macro steps of K={k_fused}, B={batch}", sg, se, lg, le))
    del sg, se
    torch.cuda.empty_cache()

    # the timed runs: the single step, the graph at K=1 and at K=8
    single = (S.make_fm_train_step(EMA_DECAY) if kind == "fm" else
              S.make_ratio_train_step("disc", EMA_DECAY))

    def run_single(s, c, gen):
        outs = []
        for j in range(len(c[0])):
            rows = torch.from_numpy(c[0][j]).to(dev)
            gj = torch.Generator(dev).manual_seed(gen.initial_seed() + j)
            if kind == "fm":
                outs.append(single(s, xa.index_select(0, rows), gj))
            else:
                outs.append(single(
                    s, xa.index_select(0, rows), ya.index_select(
                        0, torch.from_numpy(c[1][j]).to(dev)),
                    c[2][j], gj)["loss"])
        return outs[-1]

    checked = f"graph K={k_fused}"
    draws = []            # (chunk, seed) of every macro step of `checked`
    variants = {}
    for tag, k in (("single step", 1), ("graph K=1", 1), (checked, k_fused)):
        s = _fresh_state(make_net, kind, dev)
        f, run = ((None, run_single) if tag == "single step"
                  else trainer())
        if tag == checked:
            run = _recorded(run, draws)
        variants[tag] = (s, f, run, k)
        for w in range(2):                # warm-up (capture, replay)
            run(s, chunk(k), torch.Generator(dev).manual_seed(w))
    torch.cuda.synchronize()
    rows = {}
    for rnd_i in range(2):
        for tag, (s, f, run, k) in variants.items():
            macro = steps // k
            chunks = [chunk(k) for _ in range(macro)]
            replays0 = sum(gr.replays for gr in (f.graphs.values()
                                                 if f else ()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            h0 = time.perf_counter()
            for i, c in enumerate(chunks):
                last = run(s, c, torch.Generator(dev).manual_seed(1000 + i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - h0
            counts = launch_counts()
            replays = sum(gr.replays for gr in (f.graphs.values()
                                                if f else ())) - replays0
            per = {kk: v / macro for kk, v in counts.items()}
            eager = k * sites if f is None else 0
            bn_eager = k * bn if f is None else 0
            want = {"group_norm_silu.launches": eager,
                    "group_norm_silu_backward.launches": eager,
                    "group_norm_silu_backward.weight_grad_launches": eager,
                    "flash_guidance.launches": 0,
                    "fused_gn_silu_conv.launches": 0,
                    "batch_norm_silu.launches": bn_eager,
                    "batch_norm_silu_backward.launches": bn_eager,
                    "linear_tf32x3.launches": 0,
                    "linear_tf32x3.split_launches": 0,
                    "sdpa.efficient_launches": 0,
                    "sdpa.math_launches": 0}
            if per != want:
                fail(f"fused {name} {tag}: the wrappers' launches per macro "
                     f"step {per} != derived {want}")
            if f is not None and replays != macro:
                fail(f"fused {name} {tag}: {replays} graph replays for "
                     f"{macro} macro steps")
            if not bool(torch.isfinite(last)):
                fail(f"fused {name} {tag}: non-finite loss")
            peak = torch.cuda.max_memory_allocated() / 2**30
            rows.setdefault(tag, []).append(dict(
                steps=macro * k, seconds=wall,
                steps_per_s=macro * k / wall, replays=replays,
                eager_launches_per_macro_step=short_counts(per),
                peak_mem_gib=peak))

    # the timed K=8 graph's state against the eager loop on its draws
    se = _fresh_state(make_net, kind, dev)
    _, run_e = trainer(graph=False)
    for c, seed, _ in draws:
        le = run_e(se, c, torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    rec["timed_graph_vs_eager"] = _graph_vs_eager(
        name, f"the timed {checked} graph after its {len(draws)} macro "
        f"steps", variants[checked][0], se, draws[-1][2], le)
    del se

    for tag, (s, f, run, k) in variants.items():
        r = rows[tag]
        macro = max(1, 8 // k)
        prof = profile_call(lambda: [run(s, chunk(k), torch.Generator(
            dev).manual_seed(2000 + i)) for i in range(macro)], macro * k)
        traced = {"group_norm_silu": prof["group_norm_silu_launches"],
                  "group_norm_silu_backward":
                      prof["group_norm_silu_backward_launches"],
                  "group_norm_silu_backward (dγ/dβ)":
                      prof["gn_weight_grad_reduce_launches"]}
        if traced != {kk: macro * k * sites for kk in traced}:
            fail(f"fused {name} {tag}: the profiler traced {traced} GN "
                 f"launches over {macro} macro steps, derived "
                 f"{macro * k * sites} each")
        per = dict(r[0]["eager_launches_per_macro_step"])
        per.update({kk: v / macro for kk, v in traced.items()})
        busy = prof["device_busy_ms"] / max(prof["wall_ms"], 1e-9)
        print(f"fused {name} {tag}: "
              + ", ".join(f"{x['steps_per_s']:.2f}" for x in r)
              + f" steps/s ({r[0]['steps']} steps a run, in turns), "
              f"busy {100 * busy:.0f}% (profiled run), replays "
              f"{r[0]['replays']}, launches per macro step {per} (GN: "
              f"the profiler's trace; the wrappers counted "
              f"{r[0]['eager_launches_per_macro_step']['group_norm_silu']}"
              f" eagerly), peak mem {r[0]['peak_mem_gib']:.2f} GiB  "
              f"[{smi}]")
        rec[tag] = dict(runs=r, busy_share=busy, profile=prof,
                        launches_per_macro_step=per)
    del variants
    torch.cuda.empty_cache()
    return rec


def _recorded(run, draws):
    """`run` that also appends each macro step's (chunk, seed) and loss."""
    def rec(s, c, gen):
        loss = run(s, c, gen)
        draws.append((c, gen.initial_seed(), loss))
        return loss
    return rec


def spawn_ranks(what, n, argv, timeout=600):
    """Run `n` processes, `argv(rank, port)` each, joined on a free local
    port (gloo: the ranks share the card); return their stdout. Fails on a
    non-zero exit; kills every process it started."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, *argv(r, port)], env=env, cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{what} rank {r} exited {p.returncode}:\n{o[-6000:]}")
    return outs


def spawn_workers(kind, n, out_dir, extra=(), timeout=600):
    """Run this script as `n` --worker processes of `kind`."""
    return spawn_ranks(f"{kind} worker", n, lambda r, port: [
        os.path.abspath(__file__), "--worker", kind, "--rank", str(r),
        "--world", str(n), "--port", str(port), "--out", out_dir, *extra],
        timeout)


def _dp_cases():
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNetMNIST,
        RatioEstimatorMNISTSVHN,
    )

    return (("train_flow_mnist32 (MNIST-32 U-Net)",
             lambda: FlowMatchingUNetMNIST(img_size=32), "fm", (32, 32, 1),
             None),
            ("train_ratio_mnist_svhn (experiment-2 ratio, BatchNorm, disc)",
             RatioEstimatorMNISTSVHN, "ratio", X_SHAPE, Y_SHAPE))


def dp_run(dev, adapt, steps, batch, lr, ulp=False):
    """Each phase-5d case trained `steps` steps on seeded global batches
    of `batch` (dropout off, SGD at `lr`, cuDNN's deterministic
    algorithms: its default weight-gradient kernels add with atomics)
    through `adapt` (the one-process identity or cli/common.py:
    multihost_adapt); with `ulp` every initial parameter moved by one
    float32 ulp (the yardstick of how far rounding grows). Returns
    {name: (state, seconds, last loss)}."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
    from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

    out = {}
    torch.backends.cudnn.deterministic = True
    for name, make_net, kind, xs, ys in _dp_cases():
        state = _fresh_state(make_net, kind, dev, seed=50, dropout=False)
        if ulp:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(1 + 2 ** -23)
        state.optimizer = torch.optim.SGD(state.model.parameters(), lr=lr)
        if kind == "fm":
            step = S.make_fm_train_step()
            state, step, extract = adapt(state, step, lambda b: b["x"])
        else:
            rstep = S.make_ratio_train_step("disc")
            state, step, extract = adapt(
                state, lambda s, b, g: rstep(s, b["x"], b["y"],
                                             b["is_real"], g), lambda b: b)
        g = torch.Generator(dev).manual_seed(60)
        batches = []
        for _ in range(steps + 1):
            b = {"x": torch.rand((batch,) + xs, generator=g, device=dev)
                 * 2 - 1}
            if ys:
                b["y"] = torch.rand((batch,) + ys, generator=g,
                                    device=dev) * 2 - 1
                b["is_real"] = (torch.rand(batch, generator=g, device=dev)
                                < 0.5).float()
            batches.append(b)
        rng = RNG(61, dev)
        step(state, extract(batches[0]), rng.generator(9, 9))   # warm-up
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for i, b in enumerate(batches[1:]):
            last = step(state, extract(b), rng.generator(0, i))
        torch.cuda.synchronize()
        loss = last if kind == "fm" else last["loss"]
        out[name] = (state, time.perf_counter() - h0, float(loss))
    torch.backends.cudnn.deterministic = False
    return out


def dp_training_phase(dev, smi, out_dir, steps=None, batch=None):
    """5d: data-parallel training, two processes on the one card (gloo on
    CUDA tensors), against one process on the same global batches: the
    MNIST-32 U-Net's CFM step and the experiment-2 ratio net (BatchNorm on
    the global batch's statistics, disc), dropout off, `steps` steps at
    B=`batch`, each rank on its B/2 rows. The update is SGD: Adam divides
    each gradient element by its size, so an element whose gradient is at
    float32 rounding level (a conv bias before a BatchNorm: zero in exact
    arithmetic) moves by ±lr whatever the sum order; the parity of the
    data-parallel step itself (loss shares, the gradient sum, the global
    statistics) is held with an update linear in the gradient, at the
    first lr of DP_LRS, whose steps are about the size of the CLIs' Adam
    steps at lr 1e-4: the largest difference within DP_SHARE of the
    largest update (|p_end − p_start|), per group, parameters and EMA
    within 1e-5·max|p| and the BatchNorm running statistics (averages of
    activations, which sum a layer's fan-in of parameter differences)
    within 1e-4·max|ref| + 1e-6, phase 5r's bound for them. At lr 1e-2
    the float32 difference grows faster than the step (the experiment-2
    net's first SVHN conv: 1.9e-2 of the update, against 1.6e-3 at lr
    1e-3), so there the share is printed beside its yardstick, not held:
    the same one-process run from parameters moved by one float32 ulp
    against the unmoved one. Steps/s of both."""
    import numpy as np

    steps, batch = steps or DP_STEPS, batch or B_TRAIN
    one = lambda s, st, ex: (s, st, ex)  # noqa: E731
    refs = [dp_run(dev, one, steps, batch, lr) for lr in DP_LRS]
    ulps = [dp_run(dev, one, steps, batch, lr, ulp=True) for lr in DP_LRS]
    spawn_workers("dp", 2, out_dir, ["--steps", str(steps), "--batch",
                                     str(batch)])
    rec = {}
    metas = [json.load(open(os.path.join(out_dir, f"dp{r}.json")))
             for r in (0, 1)]
    for j, (lr, ref, ulp) in enumerate(zip(DP_LRS, refs, ulps)):
        for i, (name, make_net, kind, _, _) in enumerate(_dp_cases()):
            rec[f"{name} lr {lr:g}"] = _dp_case(
                name, make_net, kind, lr, j == 0, ref[name], [dict(np.load(
                    os.path.join(out_dir, f"dp{r}_{j}_{i}.npz")))
                    for r in (0, 1)], {k: v.cpu().numpy() for k, v in
                                       _state_arrays(ulp[name][0]).items()},
                [m["cases"][f"{name} lr {lr:g}"] for m in metas], dev,
                steps, batch, smi)
    rec["launches_rank0"] = metas[0]["launches"]
    print(f"data-parallel launches on rank 0 (both cases at both rates, "
          f"warm-up included): {metas[0]['launches']}")
    return rec


def _dp_case(name, make_net, kind, lr, held, ref, ranks, ulp, meta, dev,
             steps, batch, smi):
    import numpy as np

    state, secs, loss = ref
    want = {k: v.cpu().numpy() for k, v in _state_arrays(state).items()}
    start = {k: v.cpu().numpy() for k, v in _state_arrays(_fresh_state(
        make_net, kind, dev, seed=50, dropout=False)).items()}
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    worst, bound, yard = {}, {}, {}
    for group, keys, rel, floor in (
            ("params", [k for k in want if k not in stats], 1e-5, 0.0),
            ("running statistics", stats, 1e-4, 1e-6)):
        if not keys:
            continue
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        bound[group] = rel * scale + floor
        worst[group] = max((float(np.abs(rk[k] - want[k]).max()), k)
                           for rk in ranks for k in keys)
        moved = max(float(np.abs(want[k] - start[k]).max()) for k in keys)
        worst[group] += (worst[group][0] / max(moved, 1e-30),)
        yard[group] = max(float(np.abs(ulp[k] - want[k]).max())
                          for k in keys) / max(moved, 1e-30)
        if held and worst[group][0] > bound[group]:
            fail(f"data-parallel {name} lr {lr:g}: {group} differ from one "
                 f"process by {worst[group][0]:.3g} ({worst[group][1]}) > "
                 f"{bound[group]:.3g}")
        if held and worst[group][2] > DP_SHARE:
            fail(f"data-parallel {name} lr {lr:g}: {group} differ from one "
                 f"process by {worst[group][2]:.3g} of the largest update "
                 f"({worst[group][1]}) > {DP_SHARE:g}")
    if meta[0]["loss"] != meta[1]["loss"]:
        fail(f"data-parallel {name}: the ranks report different losses")
    dp_rate = steps / max(m["seconds"] for m in meta)
    print(f"data-parallel {name}: 2 processes (gloo, one card), {steps} "
          f"steps at B={batch} ({batch // 2} rows a rank), SGD lr {lr:g}: "
          f"max |Δ| against one process: " + "; ".join(
              f"{g} {worst[g][0]:.3g} ("
              + (f"bound {bound[g]:.3g}; " if held else "not held; ")
              + f"{worst[g][2]:.3g} of the largest update"
              + (f", bound {DP_SHARE:g}" if held else "")
              + f"; one process from parameters one ulp off: "
              f"{yard[g]:.3g} of it)" for g in worst)
          + f"; {dp_rate:.2f} steps/s against {steps / secs:.2f} in one "
          f"process; loss {meta[0]['loss']:.5f} / {loss:.5f}  [{smi}]")
    return dict(lr=lr, max_abs_diff={g: w[0] for g, w in worst.items()},
                share_of_update={g: w[2] for g, w in worst.items()},
                one_ulp_share_of_update=yard,
                bound=bound if held else None,
                share_bound=DP_SHARE if held else None,
                steps_per_s_dp=dp_rate, steps_per_s_one_process=steps / secs)


def dp_worker(args, dev):
    import numpy as np

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        multihost_adapt,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts

    reset_launches()
    meta = {"cases": {}}
    for j, lr in enumerate(DP_LRS):
        res = dp_run(dev, multihost_adapt, args.steps, args.batch, lr)
        for i, (name, (state, secs, loss)) in enumerate(res.items()):
            np.savez(os.path.join(args.out, f"dp{args.rank}_{j}_{i}.npz"),
                     **{k: v.cpu().numpy()
                        for k, v in _state_arrays(state).items()})
            meta["cases"][f"{name} lr {lr:g}"] = dict(seconds=secs,
                                                      loss=loss)
    meta["launches"] = short_counts(launch_counts())
    with open(os.path.join(args.out, f"dp{args.rank}.json"), "w") as f:
        json.dump(meta, f)


def sharded_worker(args, dev):
    """One rank of phase 5p: for each mesh, the float32 small check and the
    full-width bf16 call of the distributed sampler."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts
    from ratio_guided_multimodal_fm_tpu_torch.parallel import (
        make_distributed_guided_sampler_p,
        make_mesh,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
    )

    coll = {"s": 0.0, "n": 0}
    raw = dist.all_reduce

    def timed(*a, **k):
        h0 = time.perf_counter()
        try:
            return raw(*a, **k)
        finally:
            coll["s"] += time.perf_counter() - h0
            coll["n"] += 1

    dist.all_reduce = timed
    res = {}
    small_b, small_n, small_steps = map(int, args.small.split(","))
    f32 = build_models(torch.float32, dev)
    bf16 = build_models(torch.bfloat16, dev)
    for sizes in MESHES:
        mesh = make_mesh(axis_names=("data", "mc"), axis_sizes=sizes)
        tag = f"{sizes[0]}x{sizes[1]}"

        def sampler(n_mc, steps):
            cfg = GuidedSamplerConfig(
                guidance_method="mc_feng", guidance_strength=GAMMA,
                num_steps=steps, mc_batch_size=n_mc, x_shape=X_SHAPE,
                y_shape=Y_SHAPE)
            return make_distributed_guided_sampler_p(
                lambda m, x, t: velocity_fn(m)(x, t),
                lambda m, y, t: velocity_fn(m)(y, t), cfg,
                lambda r, x, y: ratio_log_fn(r)(x, y), mesh)

        x1, y1 = sampler(small_n, small_steps)(
            f32, torch.Generator(dev).manual_seed(5), small_b)
        np.savez(os.path.join(args.out, f"small{args.rank}_{tag}.npz"),
                 x=x1.cpu().numpy(), y=y1.cpu().numpy())
        sampler(args.n_mc, 2)(bf16, torch.Generator(dev).manual_seed(1),
                              args.batch)                         # warm-up
        full = sampler(args.n_mc, args.steps)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        coll.update(s=0.0, n=0)
        h0 = time.perf_counter()
        x1, y1, diags = full(bf16, torch.Generator(dev).manual_seed(2),
                             args.batch, return_diagnostics=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - h0
        counts = short_counts(launch_counts())
        ess = diags["ess"]
        res[tag] = dict(
            seconds=secs, collective_host_s=coll["s"],
            collectives=coll["n"], launches=counts,
            finite=bool(torch.isfinite(x1).all() and torch.isfinite(y1).all()),
            shape=[list(x1.shape), list(y1.shape)],
            ess_min=float(ess.min()), ess_max=float(ess.max()),
            ess_mean=float(ess.mean()))
    with open(os.path.join(args.out, f"sharded{args.rank}.json"), "w") as f:
        json.dump(res, f)


def sharded_sampler_phase(dev, smi, out_dir, steps):
    """5p: the distributed sampler (parallel/sharded_guidance.py) at full
    width: experiment-2 nets in bf16, B=B_MAIN, N_mc=N_MC, `steps` steps,
    mc_feng, two processes on the card on meshes (data 2, mc 1) and (data
    1, mc 2). First, in float32 nets on a small input (SHARD_SMALL), the
    gathered samples against this process's single-process sampler on the
    same generator (1e-3, the card-against-CPU bound). At full width:
    finite samples assembled on both ranks, 1 <= ESS <= N_mc, the launch
    counts as derived (kernel A once a step on (2, 1), never on (1, 2),
    where the guidance runs in tensor ops with its reductions over the mc
    group; kernel B at each U-Net site, in phase A on the rank's MC shard
    and in phase B on its rows), the call time and the host time in
    collectives."""
    import numpy as np
    import torch

    small_b, small_n, small_steps = SHARD_SMALL
    f32 = build_models(torch.float32, dev)
    ref = make_sampler(dict(mc_batch_size=small_n, num_steps=small_steps))(
        f32, torch.Generator(dev).manual_seed(5), small_b)
    del f32
    torch.cuda.empty_cache()
    spawn_workers("sharded", 2, out_dir, [
        "--steps", str(steps), "--batch", str(B_MAIN), "--n_mc", str(N_MC),
        "--small", ",".join(map(str, SHARD_SMALL))])
    meta = [json.load(open(os.path.join(out_dir, f"sharded{r}.json")))
            for r in (0, 1)]
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNetMNIST,
        FlowMatchingUNetSVHN,
    )

    sites = (gn_sites(FlowMatchingUNetMNIST(img_size=32))
             + gn_sites(FlowMatchingUNetSVHN()))
    rec = {}
    for sizes in MESHES:
        tag = f"{sizes[0]}x{sizes[1]}"
        errs = []
        for r in (0, 1):
            got = np.load(os.path.join(out_dir, f"small{r}_{tag}.npz"))
            errs.append(max(float(np.abs(got["x"] - ref[0].cpu().numpy()
                                         ).max()),
                            float(np.abs(got["y"] - ref[1].cpu().numpy()
                                         ).max())))
        if max(errs) > 1e-3:
            fail(f"sharded sampler {tag}: gathered samples differ from the "
                 f"single-process sampler by {max(errs):.3g} > 1e-3")
        want = {"flash_guidance": steps if sizes[1] == 1 else 0,
                "group_norm_silu": 2 * steps * sites,
                "group_norm_silu_backward": 0,
                "group_norm_silu_backward (dγ/dβ)": 0,
                "fused_gn_silu_conv": 0, "batch_norm_silu": 0,
                "batch_norm_silu_backward": 0,
                "linear_tf32x3": 0, "linear_tf32x3.split_launches": 0,
                "sdpa.efficient_launches": 0, "sdpa.math_launches": 0}
        for r, m in enumerate(meta):
            x = m[tag]
            if x["launches"] != want:
                fail(f"sharded sampler {tag} rank {r}: launches "
                     f"{x['launches']} != derived {want}")
            if not (x["finite"] and 1.0 - 1e-3 <= x["ess_min"]
                    and x["ess_max"] <= N_MC + 1e-3):
                fail(f"sharded sampler {tag} rank {r}: non-finite samples "
                     f"or ESS outside [1, {N_MC}]: {x}")
            if x["shape"] != [[B_MAIN, *X_SHAPE], [B_MAIN, *Y_SHAPE]]:
                fail(f"sharded sampler {tag}: assembled shapes {x['shape']}")
        m0 = meta[0][tag]
        print(f"sharded sampler mesh (data {sizes[0]}, mc {sizes[1]}), 2 "
              f"processes (gloo, one card): small f32 check max |err| "
              f"{max(errs):.3g} (bound 1e-3); full width B={B_MAIN} "
              f"N_mc={N_MC} {steps} steps bf16: "
              + " / ".join(f"{m[tag]['seconds']:.3f}" for m in meta)
              + f" s a call (ranks 0 / 1), {m0['collectives']} collectives "
              f"taking {m0['collective_host_s']:.3f} s of host time on rank "
              f"0, ESS [{m0['ess_min']:.2f}, {m0['ess_max']:.2f}] mean "
              f"{m0['ess_mean']:.2f}, launches a rank {m0['launches']}  "
              f"[{smi}]")
        rec[tag] = dict(small_max_abs_err=max(errs), ranks=[m[tag]
                                                            for m in meta])
    return rec


def run_worker(args) -> int:
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        resolve_device,
    )
    from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
        maybe_init_distributed,
        process_device,
    )

    if not torch.cuda.is_available():
        fail("worker: no CUDA device")
    dev = resolve_device("cuda")
    maybe_init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                           device=dev)
    dev = process_device(dev)
    if args.worker == "dp":
        dp_worker(args, dev)
    else:
        sharded_worker(args, dev)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---- phase 8q: experiment 1 at full width, trained, through the CLIs -------
#
# FlowMatchingUNet(28) x 2 trained in float32 (--fused_steps 8), the
# experiment-1 ratio net (disc) and the MNIST classifier, on the offline
# synthetic digits, then the evaluate CLI at B = 512, N_mc = 256, 100 steps,
# bf16: the gate is the JAX capstone's (tests/test_integration_e2e.py),
# mc_feng at γ = 0.5 above none by more than 0.1, behind a held-out
# classifier accuracy of at least 0.9. The budget, fixed here before the
# phase's first gated run, is the JAX round-1 budget (docs/ROUND1.md: 20k
# digits, 12-epoch flows, an 8-epoch ratio net, γ in 0, 0.3, 0.5, 1.0): the
# γ other than 0.5 are a record beside its figures, not a gate.
Q8 = dict(digits=20000, flow_epochs=12, ratio_epochs=8, clf_epochs=3,
          strengths=(0.0, 0.3, 0.5, 1.0))
Q8_GAMMA, Q8_MARGIN, Q8_CLF_MIN = 0.5, 0.1, 0.9


def exp1_trained_phase(smi, budget):
    """Phase 8q: train the classifier,
    both flows and the ratio net with the train CLIs in a fresh directory
    of `budget["digits"]` synthetic digits, then evaluate none and mc_feng
    at `budget["strengths"]`. The kernels' launch counts are set to 0
    before and read after. Returns the record."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        evaluate,
        train_classifier,
        train_flow,
        train_ratio,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts

    rec = {"budget": dict(budget, strengths=list(budget["strengths"])),
           "seconds": {}}
    synth_n = os.environ.get("RGMF_SYNTH_N")
    os.environ["RGMF_SYNTH_N"] = str(budget["digits"])
    cwd = os.getcwd()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            h0 = time.perf_counter()
            _, hist = train_classifier.main(
                ["--epochs", str(budget["clf_epochs"])])
            rec["seconds"]["train_classifier"] = time.perf_counter() - h0
            acc = hist[-1]["test_acc"]
            rec["classifier_test_acc"] = acc
            print(f"8q: MNIST classifier, {budget['clf_epochs']} epochs on "
                  f"{budget['digits']} synthetic digits: held-out accuracy "
                  f"{acc:.4f} (train {hist[-1]['train_acc']:.4f}), "
                  f"{rec['seconds']['train_classifier']:.1f} s wall  [{smi}]",
                  flush=True)
            if not acc >= Q8_CLF_MIN:
                fail(f"phase 8q: the classifier's held-out accuracy {acc:.4f}"
                     f" is below {Q8_CLF_MIN}: coherence would mean nothing")
            for mod in ("x", "y"):
                h0 = time.perf_counter()
                _, best, hist = train_flow.main(
                    ["--modality", mod, "--epochs",
                     str(budget["flow_epochs"]), "--fused_steps", "8"])
                wall = time.perf_counter() - h0
                rec["seconds"][f"train_flow {mod}"] = wall
                rates = [h["steps_per_sec"] for h in hist]
                rec[f"flow_{mod}"] = dict(best=best, epochs=len(hist),
                                          macro_steps_per_s=rates)
                print(f"8q: train_flow --modality {mod} --fused_steps 8, "
                      f"{len(hist)} epochs: {wall:.1f} s wall, best loss "
                      f"{best:.4f}, {8 * sorted(rates)[len(rates) // 2]:.1f} "
                      f"steps/s (median epoch)  [{smi}]", flush=True)
                if not np.isfinite(best):
                    fail(f"phase 8q: train_flow {mod} loss {best}")
            h0 = time.perf_counter()
            _, best, hist = train_ratio.main(
                ["--epochs", str(budget["ratio_epochs"])])
            rec["seconds"]["train_ratio"] = time.perf_counter() - h0
            rec["ratio"] = {k: v for k, v in hist[-1].items()}
            print(f"8q: train_ratio, {len(hist)} epochs: "
                  f"{rec['seconds']['train_ratio']:.1f} s wall, " + ", ".join(
                      f"{k} {v:.4f}" for k, v in hist[-1].items()
                      if k != "epoch") + f"  [{smi}]", flush=True)
            if not np.isfinite(best):
                fail(f"phase 8q: train_ratio loss {best}")
            h0 = time.perf_counter()
            results = evaluate.main(
                ["--guidance_methods", "none", "mc_feng",
                 "--guidance_strengths"]
                + [str(g) for g in budget["strengths"]]
                + ["--num_samples", str(B_MAIN), "--mc_batch_size",
                   str(N_MC), "--num_steps", "100", "--dtype", "bf16"])
            rec["seconds"]["evaluate"] = time.perf_counter() - h0
        finally:
            os.chdir(cwd)
            if synth_n is None:
                os.environ.pop("RGMF_SYNTH_N")
            else:
                os.environ["RGMF_SYNTH_N"] = synth_n
    torch.cuda.synchronize()
    rec["launches"] = short_counts(launch_counts())
    rec["results"] = [{k: r[k] for k in (
        "method", "guidance_strength", "coherence_acc", "label_entropy_x",
        "label_entropy_y", "n_chunks")} for r in results]
    print(f"8q: evaluate (none, mc_feng at γ in {budget['strengths']}; "
          f"B={B_MAIN}, N_mc={N_MC}, 100 steps, bf16): "
          f"{rec['seconds']['evaluate']:.1f} s wall; " + "; ".join(
              f"{r['method']}@{r['guidance_strength']} coherence "
              f"{r['coherence_acc']:.3f}, label entropy "
              f"{r['label_entropy_x']:.3f} / {r['label_entropy_y']:.3f}"
              for r in results) + f"  [{smi}]", flush=True)
    if not all(np.isfinite([r["coherence_acc"], r["label_entropy_x"],
                            r["label_entropy_y"]]).all() for r in results):
        fail(f"phase 8q: evaluate gave {results}")
    # kernel A runs once a step of every mc_feng chunk (γ = 0 included)
    want_a = 100 * sum(r["n_chunks"] for r in results
                       if r["method"] == "mc_feng")
    got = rec["launches"]
    print(f"8q: launches {got} (flash_guidance expected {want_a})",
          flush=True)
    if (got["flash_guidance"] != want_a or not got["group_norm_silu"]
            or not got["group_norm_silu_backward"]):
        fail(f"phase 8q: launches {got}, flash_guidance expected {want_a}")
    coh = {(r["method"], r["guidance_strength"]): r["coherence_acc"]
           for r in results}
    rec["lift"] = coh[("mc_feng", Q8_GAMMA)] - coh[("none", 0.0)]
    if not rec["lift"] > Q8_MARGIN:
        fail(f"phase 8q: mc_feng at γ={Q8_GAMMA} coherence "
             f"{coh[('mc_feng', Q8_GAMMA)]:.3f} is not above none's "
             f"{coh[('none', 0.0)]:.3f} by more than {Q8_MARGIN}")
    return rec


def slice10_clis(smi):
    """Phase 7 (slice 10), in phase 7's directory of synthetic digits and
    checkpoints: train_flow_mnist32 and train_ratio with --fused_steps 8
    for one epoch, then both sample CLIs on what they wrote;
    train_flow_mnist32 as two processes through its multi-process flags;
    cli/stretch64_demo.py at STRETCH64_ARGV (kernel A at Dx = 12,288,
    Dy = 4,096 in its mc_feng steps)."""
    import re

    import numpy as np
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        sample,
        sample_mnist_svhn,
        stretch64_demo,
        train_flow_mnist32,
        train_ratio,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import launch_counts

    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingUNetMNIST,
        RatioEstimatorMNIST,
    )
    from ratio_guided_multimodal_fm_tpu_torch.train.graphs import TrainGraph

    # the CLIs' graph replays, each under the profiler: a replay runs its
    # kernels without the wrappers, so its GN launches come from the trace
    replayed = {k: 0 for k in GN_TRACE_NAMES}
    replays = [0]
    run_graph = TrainGraph.run

    def traced_run(graph):
        if graph.graph is None:                  # eager warm-up, capture
            return run_graph(graph)
        out, _, by_kernel = traced(lambda: run_graph(graph))
        replays[0] += 1
        for k, v in gn_traced_launches(by_kernel).items():
            replayed[k] += v
        return out

    rec = {}
    TrainGraph.run = traced_run
    try:
        for name, cli, flags, net in (
                ("train_flow_mnist32", train_flow_mnist32, [],
                 FlowMatchingUNetMNIST(img_size=32)),
                ("train_ratio", train_ratio, ["--ema_decay", "0.999"],
                 RatioEstimatorMNIST())):
            reset_launches()
            replayed.update({k: 0 for k in replayed})
            replays[0] = 0
            h0 = time.perf_counter()
            _, best, hist = cli.main(["--epochs", "1", "--fused_steps",
                                      str(K_FUSED)] + flags)
            secs = time.perf_counter() - h0
            if not (np.isfinite(best) and hist and hist[-1]["epoch"] == 1):
                fail(f"CLI {name} --fused_steps {K_FUSED}: {hist}")
            counts = short_counts(launch_counts())
            want = replays[0] * K_FUSED * gn_sites(net)
            if replays[0] < 1 or any(v != want for v in replayed.values()):
                fail(f"CLI {name} --fused_steps {K_FUSED}: {replays[0]} "
                     f"graph replays traced {replayed} GN launches, "
                     f"derived {want} each")
            print(f"CLI {name} --fused_steps {K_FUSED}, 1 epoch: {secs:.1f} "
                  f"s wall (its {replays[0]} graph replays profiled), "
                  f"{hist[-1]['steps_per_sec']:.2f} macro steps/s, best "
                  f"{best:.4f}, launches: the wrappers' (eager: the "
                  f"graph's warm-up, evaluation) {counts}, the replays' "
                  f"(traced) {replayed}  [{smi}]")
            rec[name] = dict(seconds=secs, history=hist, launches=counts,
                             graph_replays=replays[0],
                             replay_launches_traced=dict(replayed))
    finally:
        TrainGraph.run = run_graph
    for name, cli in (("sample_mnist_svhn", sample_mnist_svhn),
                      ("sample", sample)):
        x1, y1, diags = cli.main(["--guidance_method", "mc_feng",
                                  "--num_samples", "64", "--num_steps", "20",
                                  "--mc_batch_size", str(N_MC)])
        if not (bool(torch.isfinite(x1).all())
                and bool(torch.isfinite(y1).all())):
            fail(f"CLI {name} on the fused trainers' checkpoints: "
                 "non-finite samples")
        print(f"CLI {name} on the checkpoints the fused train CLIs wrote: "
              "finite samples")
    # train_flow_mnist32 as two processes (gloo on the one card)
    h0 = time.perf_counter()
    outs = spawn_ranks("two-process train_flow_mnist32", 2, lambda r, port: [
        "-m", "ratio_guided_multimodal_fm_tpu_torch.cli.train_flow_mnist32",
        "--epochs", "1", "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(r)])
    secs = time.perf_counter() - h0
    losses = []
    for r, o in enumerate(outs):
        m = re.search(r"Epoch 1/1 - Loss: ([0-9.]+) \(([0-9.]+) steps/s\)",
                      o)
        if m is None:
            fail(f"two-process train_flow_mnist32 rank {r}: no epoch line"
                 f"\n{o[-4000:]}")
        losses.append(m.groups())
    if losses[0][0] != losses[1][0] or "backend gloo" not in outs[0]:
        fail(f"two-process train_flow_mnist32: ranks disagree {losses} or "
             "the backend is not gloo")
    print(f"CLI train_flow_mnist32 as 2 processes (gloo, one card), 1 "
          f"epoch: {secs:.1f} s wall with start-up, loss {losses[0][0]}, "
          f"{losses[0][1]} / {losses[1][1]} steps/s (ranks 0 / 1)  [{smi}]")
    rec["train_flow_mnist32_2proc"] = dict(seconds=secs, losses=losses)
    # the stretch demo
    reset_launches()
    h0 = time.perf_counter()
    res = stretch64_demo.main(STRETCH64_ARGV)
    secs = time.perf_counter() - h0
    counts = short_counts(launch_counts())
    steps = int(STRETCH64_ARGV[STRETCH64_ARGV.index("--num_steps") + 1])
    keys = {"loss_curve", "none_gamma0.0", "mc_feng_gamma0.5",
            "mc_feng_gamma1.0"}
    if (set(res) != keys or not all(res[k]["finite"] for k in keys
                                    if k != "loss_curve")
            or counts["flash_guidance"] != 2 * steps):
        fail(f"stretch64_demo: {res} launches {counts}")
    print(f"CLI stretch64_demo {' '.join(STRETCH64_ARGV)}: {secs:.1f} s wall; "
          + ", ".join(f"{k} {v['wall_sec']} s coherence "
                      f"{v['centroid_coherence']}" for k, v in res.items()
                      if k != "loss_curve")
          + f"; launches {counts}  [{smi}]")
    rec["stretch64_demo"] = dict(seconds=secs, results=res, launches=counts)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100,
                    help="Euler steps of the main-path run (default 100)")
    ap.add_argument("--train_steps", type=int, default=TRAIN_STEPS,
                    help="optimizer steps of each counted training run "
                         f"(default {TRAIN_STEPS})")
    # the multi-process phases (5d, 5p) run this script as their workers
    ap.add_argument("--worker", choices=["dp", "sharded"], default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=str, default="", help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=B_TRAIN,
                    help=argparse.SUPPRESS)
    ap.add_argument("--n_mc", type=int, default=N_MC, help=argparse.SUPPRESS)
    ap.add_argument("--small", type=str, default="16,32,10",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return run_worker(args)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        from ratio_guided_multimodal_fm_tpu_torch.core.card import (
            ProfilerSilent,
            call_times,
            card_info,
            device_ms,
            l2_flusher,
            peaks_for,
            time_ms,
        )
        from ratio_guided_multimodal_fm_tpu_torch.core.device import (
            resolve_device,
        )
        from ratio_guided_multimodal_fm_tpu_torch.models import (
            FlowMatchingUNet,
            FlowMatchingUNetMNIST,
            FlowMatchingUNetSVHN,
            RatioEstimatorMNIST,
            RatioEstimatorMNISTSVHN,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops import _build
        from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
            TOL_BF16 as TOL_GN_BF16,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
            backward_plan,
            gn_backward_plan,
            gn_plan,
            gn_stats_reference,
            group_norm_silu,
            group_norm_silu_backward,
            group_norm_silu_backward_reference,
            group_norm_silu_reference,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
            CAPACITY,
            _launch as guidance_launch,
            _scalars,
            card_capacity,
            flash_guidance,
            flash_guidance_reference,
            bound_ratios,
            guidance_plan,
            last_error,
        )
        from ratio_guided_multimodal_fm_tpu_torch.cli.guidance_kernel_bench import (  # noqa: E501
            WIDTHS as F4_WIDTHS,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
            TOL_BF16,
            fused_gn_silu_conv,
            fused_gn_silu_conv_reference,
        )
    except ImportError as e:
        fail(f"the port package is not importable ({e}); run from the "
             "repository root")
    t_start = time.perf_counter()
    details = {"phase_s": {}}
    t_phase = [t_start]

    def mark(label):
        """Print and record the wall time since the previous mark."""
        now = time.perf_counter()
        details["phase_s"][label] = now - t_phase[0]
        print(f"phase {label}: {now - t_phase[0]:.1f} s wall")
        t_phase[0] = now

    # 1. versions and the card
    dev = resolve_device("cuda")       # pins float32 (no TF32)
    kind = torch.cuda.get_device_name(0)
    smi = card_info()
    peak_key, (peak_f32, peak_bw, peak_bf16) = peaks_for(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {kind} x{torch.cuda.device_count()}; peaks used "
          f"({peak_key}): {peak_f32 / 1e12:.0f} TFLOP/s f32, "
          f"{peak_bf16 / 1e12:.0f} TFLOP/s bf16 tensor, "
          f"{peak_bw / 1e12:.2f} TB/s")
    details.update(device=kind, nvidia_smi=smi, torch=torch.__version__)

    # 2. build the CUDA kernels
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, rep in built.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    details["build_s"] = time.perf_counter() - t0
    mark("1-2 versions, card, build")

    # 3. every kernel against its plain version, at main-path shapes
    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def guidance_inputs(B, N, H, images, lr_scale=1.0, y_ch=3):
        return (images(B, H, H, 1), images(B, H, H, y_ch), images(N, H, H, 1),
                images(N, H, H, y_ch), rnd(N) * lr_scale)

    def quarter_ints(*shape):
        # Quarter-integers in [-2, 2]: at D=4096 every product and partial
        # sum is exact in float32, so no summation order can move the
        # scores. With N(0,1) images the scores are ~2000 in magnitude and
        # float32 rounding alone shifts near-tied weights by more than atol
        # (see PERF.md). The kernel's scores are float64, so its plain
        # version is run in float64 too: the float32 one's finishing
        # rounds scores of ~4e3 (t = 0.5) by ~2e-4, which moves g by up to
        # 8e-4, more than the kernel's own error.
        return torch.randint(-8, 9, shape, generator=gen, device=dev) / 4.0

    flush = l2_flusher(dev)

    def hold_kernel_a(label, inputs, t, twice):
        """Kernel A on N(0,1)-scale inputs (ROADMAP F4): the scores it wrote
        within their a-priori bound and kernel 2's g, ESS and l
        within their float32 tolerance from those scores
        (ops/guidance.py:bound_ratios); ess and l within rtol 2e-2
        of the float64 plain version; a second launch, the L2 flushed in
        between, bit for bit; with `twice`, g's max |err| against float64
        at most twice the float32 plain version's. Returns the errors."""
        held = bound_ratios(inputs, t)
        got = held["out"]
        for nm, r in held["ratios"].items():
            if not r <= 1.0:
                fail(f"flash_guidance {label}: {nm} outside its float32 "
                     f"bound (ratio {r:.3g})")
        flush()
        again = flash_guidance(*inputs, t)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_guidance {label}: two launches on the same inputs "
                 "differ")
        plain = flash_guidance_reference(*inputs, t)
        exact = flash_guidance_reference(*inputs, t, torch.float64)
        err_k, err_p = (max(float((r[i].double() - exact[i]).abs().max())
                            for i in (0, 1)) for r in (got, plain))
        for i, nm in ((2, "ess"), (3, "l")):
            check_close(f"flash_guidance {nm} {label} against float64",
                        got[i].double(), exact[i], rtol=2e-2, atol=1e-4)
        if twice and err_k > 2.0 * err_p + 1e-6:
            fail(f"flash_guidance {label}: max |err| in g against float64 "
                 f"{err_k:.3g} exceeds twice the float32 plain version's "
                 f"{err_p:.3g}")
        return dict(kernel=err_k, plain_f32=err_p,
                    bound_ratios=held["ratios"])

    fg_err = 0.0
    main_in = guidance_inputs(B_MAIN, N_MC, 32, quarter_ints)
    e1_in = guidance_inputs(B_MAIN, N_MC, 28, quarter_ints, y_ch=1)
    cases = [(main_in, t) for t in (0.05, 0.5, 0.95)]
    cases += [(e1_in, t) for t in (0.05, 0.5, 0.95)]
    cases.append((guidance_inputs(5, 300, 5, rnd, lr_scale=5.0), 0.7))
    for inputs, t in cases:
        got = flash_guidance(*inputs, t)
        torch.cuda.synchronize()
        want = flash_guidance_reference(*inputs, t, torch.float64)
        D_in = inputs[0][0].numel() + inputs[1][0].numel()
        for nm, a, b in zip(("g_x", "g_y", "ess", "l"), got, want):
            err = check_close(f"flash_guidance {nm} B={inputs[0].shape[0]} "
                              f"D={D_in} t={t}", a, b, **TOL_GUIDANCE)
            if inputs is main_in or inputs is e1_in:
                fg_err = max(fg_err, err)
    print(f"flash_guidance == plain (run in float64): main shapes D=4096 "
          f"and D=1568 (quarter-integer images) t in (0.05, 0.5, 0.95) and "
          f"B=5,N=300 ragged (N(0,1)); max |err| {fg_err:.3g}")
    # N(0,1) images: no fixed tolerance holds (see quarter_ints), so the
    # yardsticks are float64 (hold_kernel_a): at every width the scores
    # kernel 1 wrote within their a-priori bound, and kernel 2's g,
    # ESS and l within what its float32 rounding allows from those same
    # scores; at the main widths (D = 4096, 1568) also g within twice the
    # float32 plain version's max |err| against float64. The fixed draws of
    # `gen` below, then F4_DRAWS fresh draws a width from a generator of
    # their own (so that no other phase's draws move them).
    yardstick = {}
    for tag, H, y_ch in (("D4096", 32, 3), ("D1568", 28, 1)):
        normal_in = guidance_inputs(B_MAIN, N_MC, H, rnd, y_ch=y_ch)
        for t in (0.05, 0.5, 0.95):
            yardstick[f"{tag}_t{t}"] = hold_kernel_a(f"{tag} t={t}",
                                                     normal_in, t, True)
    # F8: the score kernel at EVERY cluster size 1-8, not only the one this
    # card's capacity picks (another H100 may pick another), at B=512,
    # N=256, D=4096, t=0.05: quarter-integer images against the plain
    # version in float64 (TOL_GUIDANCE); N(0,1) images: ess and l against the float64
    # plain version, g's error printed; a NaN stops the phase after
    # printing what the launch saw. Its inputs come from a generator of
    # its own, so that the checks after it see the inputs they saw before
    # it was added.
    cap = card_capacity(dev.index or 0)
    print(f"flash_guidance cluster capacity of this card "
          f"(cudaOccupancyMaxActiveClusters, sizes 1-8): {cap}; built-in "
          f"CAPACITY {CAPACITY}; the plan picks "
          f"{guidance_plan(B_MAIN, N_MC, 1024, 3072, True, cap).cluster}")
    gen_f8 = torch.Generator(dev).manual_seed(8)

    def rnd_f8(*shape):
        return torch.randn(shape, generator=gen_f8, device=dev)

    def quarter_f8(*shape):
        return torch.randint(-8, 9, shape, generator=gen_f8, device=dev) / 4.0

    f8_shapes = ((B_MAIN, 32, 32, 1), (B_MAIN, 32, 32, 3),
                 (N_MC, 32, 32, 1), (N_MC, 32, 32, 3))
    normal_in = tuple(rnd_f8(*sh) for sh in f8_shapes) + (rnd_f8(N_MC),)
    f8_in = tuple(quarter_f8(*sh) for sh in f8_shapes) + (rnd_f8(N_MC),)
    flat = [lambda a: a.reshape(a.shape[0], -1)] * 4 + [lambda a: a]
    sweep = {}
    for K in range(1, 9):
        errs = []
        for tag, inputs in (("quarter_ints", f8_in), ("normal", normal_in)):
            if tag == "quarter_ints":
                got = guidance_launch(*(f(a) for f, a in zip(flat, inputs)),
                                      0.05, cluster=K)[:4]
            else:
                held = bound_ratios(inputs, 0.05, cluster=K)
                got = held["out"]
            torch.cuda.synchronize()
            nans = [int(torch.isnan(v).sum()) for v in got]
            if any(nans):
                plan = guidance_plan(B_MAIN, N_MC, 1024, 3072, True, cap)
                print(f"F8: NaN at cluster {K} ({tag}): plan {plan} with "
                      f"cluster {K}; capacity {cap} (built-in {CAPACITY}); "
                      f"cudaGetLastError after synchronize {last_error()}; "
                      f"NaN counts g_x {nans[0]}, g_y {nans[1]}, ess "
                      f"{nans[2]}, l {nans[3]}", flush=True)
                fail(f"flash_guidance at cluster {K}: NaN in the output")
            got = (got[0].reshape(inputs[0].shape),
                   got[1].reshape(inputs[1].shape), got[2], got[3])
            if tag == "quarter_ints":
                want = flash_guidance_reference(*inputs, 0.05, torch.float64)
                for nm, a, b in zip(("g_x", "g_y", "ess", "l"), got, want):
                    errs.append(check_close(
                        f"flash_guidance {nm} at cluster {K}", a, b,
                        **TOL_GUIDANCE))
                continue
            plain = flash_guidance_reference(*inputs, 0.05)
            exact = flash_guidance_reference(*inputs, 0.05, torch.float64)
            err_k, err_p = (max(float((r[i].double() - exact[i]).abs().max())
                                for i in (0, 1)) for r in (got, plain))
            for i, nm in ((2, "ess"), (3, "l")):
                check_close(f"flash_guidance {nm} at cluster {K} against "
                            "float64", got[i].double(), exact[i], rtol=2e-2,
                            atol=1e-4)
            # the scores and kernel 2 within their bounds at this K; g
            # against twice the plain version's error is held at the plan's
            # own size above
            for nm, r in held["ratios"].items():
                if not r <= 1.0:
                    fail(f"flash_guidance at cluster {K}: {nm} outside its "
                         f"bound (ratio {r:.3g})")
            sweep[K] = dict(max_abs_err_vs_plain=max(errs), g_err_f64=err_k,
                            plain_g_err_f64=err_p,
                            bound_ratios=held["ratios"])
    print("flash_guidance at every cluster size 1-8 (B=512, N=256, D=4096, "
          "t=0.05), no NaN, quarter-integer images equal to the plain "
          "version (1e-3 / 1e-4), ess and l within 2e-2 of float64, the "
          "scores and kernel 2 within their bounds; max "
          "|err| against plain (quarter-integer) / g against float64 (N(0,1),"
          " kernel | float32 plain, printed): " + ", ".join(
              f"K={K} {v['max_abs_err_vs_plain']:.3g} / {v['g_err_f64']:.3g}"
              f" | {v['plain_g_err_f64']:.3g}" for K, v in sweep.items()))
    details["flash_guidance_cluster_sweep"] = dict(
        capacity=list(cap), builtin_capacity=list(CAPACITY), rows=sweep)
    # the cluster's ranks add in rank order and nothing is atomic: two
    # launches on the same inputs, the L2 flushed in between, give the same bits
    for inputs, t in (cases[1], cases[4], cases[6]):
        first = flash_guidance(*inputs, t)
        flush()
        second = flash_guidance(*inputs, t)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"flash_guidance B={inputs[0].shape[0]}: two launches on the "
                 "same inputs differ")
    print("flash_guidance: two launches on the same inputs are bit-identical "
          "(D=4096, D=1568, ragged)")
    # the 64-px path: B=B64, N=N64, D=24,576 (both modalities 64x64x3). Its
    # scores are ~6x those at D=4096 and no float32 order holds g within
    # twice another's error on every draw (PERF.md; ROADMAP F4), so both kinds
    # of input are held to the scores' and kernel 2's bounds, ess
    # and l within rtol 2e-2 of float64, and two launches bit for bit
    yard64 = {}
    s64_in = None
    for tag, images in (("quarter_ints", quarter_ints), ("normal", rnd)):
        inputs = (images(B64, 64, 64, 3), images(B64, 64, 64, 3),
                  images(N64, 64, 64, 3), images(N64, 64, 64, 3), rnd(N64))
        s64_in = s64_in or inputs
        for t in (0.05, 0.5, 0.95):
            yard64[f"{tag}_t{t}"] = hold_kernel_a(f"D=24576 {tag} t={t}",
                                                  inputs, t, False)
    # F4: fresh draws at every width, from a generator of their own
    gen_f4 = torch.Generator(dev).manual_seed(4)
    fresh = {}
    for tag, (B, N, H, ch) in F4_WIDTHS.items():
        for draw in range(F4_DRAWS):
            inputs = tuple(torch.randn(sh, generator=gen_f4, device=dev)
                           for sh in ((B, H, H, ch[0]), (B, H, H, ch[1]),
                                      (N, H, H, ch[0]), (N, H, H, ch[1]),
                                      (N,)))
            for t in (0.05, 0.5, 0.95):
                fresh[f"{tag}_draw{draw}_t{t}"] = hold_kernel_a(
                    f"{tag} draw {draw} t={t}", inputs, t, tag in F4_TWICE)
    kernel_a_yardsticks = dict(yardstick, **{f"D24576_{k}": v
                                             for k, v in yard64.items()})
    kernel_a_yardsticks.update(fresh)
    print("flash_guidance against float64, N(0,1) images (D=4096 and 1568 "
          "also g within twice the float32 plain version's max |err|), "
          f"{F4_DRAWS} fresh draws a width x 3 t plus the fixed ones: "
          + "; ".join(
              f"{w}: g err kernel / plain max "
              f"{max(v['kernel'] for k, v in kernel_a_yardsticks.items() if k.startswith(w)):.3g}"
              f" / {max(v['plain_f32'] for k, v in kernel_a_yardsticks.items() if k.startswith(w)):.3g}"
              for w in F4_WIDTHS)
          + "; largest ratio to the bounds (<= 1 holds): " + ", ".join(
              f"{nm} {max(v['bound_ratios'][nm] for v in kernel_a_yardsticks.values()):.3g}"
              for nm in ("S", "g", "ess", "l"))
          + "; reruns bit-identical")
    details["flash_guidance_float64_yardstick"] = kernel_a_yardsticks

    models = build_models(torch.bfloat16, dev)
    shapes, rb_shapes = layer_shapes(models, dev, X_SHAPE, Y_SHAPE)
    e1_models = build_exp1_models(torch.bfloat16, dev)
    e1_shapes, e1_rb_shapes = layer_shapes(e1_models, dev, E1_SHAPE,
                                           E1_SHAPE)
    gn_err = {"bf16": 0.0, "f32": 0.0}
    tol_gn = {"bf16": TOL_GN_BF16, "f32": TOL_GN_F32}
    # the exp-1 ratio net at B=B_MAIN (the grad path's forward and backward)
    # gives the 7x7 and 3x3 sites several samples a CTA; B_MAIN+1 leaves the
    # last CTA of such a plan a partial one
    e1_ratio_shapes = ratio_gn_shapes(e1_models[2], dev, E1_SHAPE)
    odd = [(5, 96, 16), (B_MAIN + 1, 128, 3)]
    gn_check = sorted(set(shapes) | set(e1_shapes) | set(e1_ratio_shapes))
    spc = {"forward": {}, "backward": {}}
    for (B, C, H) in gn_check + odd:
        for isz in (2, 4):
            for cl in (True, False):
                for key, plan in (("forward", gn_plan),
                                  ("backward", gn_backward_plan)):
                    n = plan(B, C, H, H, 8, isz, cl).samples_per_cta
                    if n > 1:
                        spc[key][f"B{B}_C{C}_H{H}_{isz}B_"
                                 f"{'cl' if cl else 'nchw'}"] = n
    if not (spc["forward"] and spc["backward"]):
        fail("group_norm_silu: no checked shape gives a plan of several "
             "samples a CTA")
    for (B, C, H) in gn_check + odd:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = (rnd(B, C, H, H) * 2.0 + 0.5).to(dt).contiguous(
                    memory_format=fmt)
                w = torch.rand(C, generator=gen, device=dev) + 0.5
                b = rnd(C) * 0.1
                got = group_norm_silu(x, w, b, 8)
                torch.cuda.synchronize()
                if got.stride() != x.stride():
                    fail(f"group_norm_silu: output strides {got.stride()} "
                         f"!= input strides {x.stride()}")
                err = check_close(
                    f"group_norm_silu {tag} B={B} C={C} H={H} {fmt}", got,
                    group_norm_silu_reference(x, w, b, 8), **tol_gn[tag])
                gn_err[tag] = max(gn_err[tag], err)
    print(f"group_norm_silu == plain at {len(gn_check)} main-path (B,C,H) "
          f"shapes of both experiments (ratio net included) + odd B=5 and "
          f"B={B_MAIN + 1}, channels_last and NCHW; max |err| bf16 "
          f"{gn_err['bf16']:.3g} (rtol 2**-7, atol 1e-3), f32 "
          f"{gn_err['f32']:.3g}; samples_per_cta > 1 (forward) at "
          + ", ".join(f"{k}: {v}" for k, v in spc["forward"].items()))
    details["gn_samples_per_cta"] = spc
    details["gn_shapes"] = {f"B{B}_C{C}_H{H}": n
                            for (B, C, H), n in sorted(shapes.items())}
    details["exp1_gn_shapes"] = {f"B{B}_C{C}_H{H}": n
                                 for (B, C, H), n in sorted(e1_shapes.items())}
    details["exp1_ratio_gn_shapes"] = {
        f"B{B}_C{C}_H{H}": n for (B, C, H), n in sorted(e1_ratio_shapes.items())}

    # group_norm_silu's backward at the same shapes: float32 against the
    # float64 plain backward (at most twice the float32 plain backward's
    # max |err|), bfloat16 one bf16 step from the bfloat16 plain backward;
    # dx alone and with dγ, dβ; the forward's saved statistics; two
    # launches bit for bit
    bwd_err = {"f32_vs_plain": 0.0, "bf16_vs_plain": 0.0}
    stats_checked = [0]     # saved (mean, rstd) entries held bit for bit

    def check_saved_stats(name, saved, mean, rstd):
        for nm, u, v in (("mean", saved[3], mean), ("rstd", saved[4], rstd)):
            if not torch.equal(u, v):
                fail(f"{name}: the forward's saved {nm} differs from the "
                     f"plain version's at {int((u != v).sum())} of "
                     f"{u.numel()} entries (max |err| {max_abs(u, v):.3g})")
            stats_checked[0] += u.numel()
    yard = {"dx": [0.0, 0.0], "dgamma": [0.0, 0.0], "dbeta": [0.0, 0.0]}
    for (B, C, H) in gn_check + odd:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = (rnd(B, C, H, H) * 2.0 + 0.5).to(dt).contiguous(
                    memory_format=fmt)
                w = torch.rand(C, generator=gen, device=dev) + 0.5
                b = rnd(C) * 0.1
                dy = rnd(B, C, H, H).to(dt)
                name = f"group_norm_silu_backward {tag} B={B} C={C} H={H} {fmt}"
                xs = x.clone().requires_grad_(True)
                y = group_norm_silu(xs, w, b, 8)
                saved = y.grad_fn.saved_tensors
                mean, rstd = gn_stats_reference(x, 8)
                check_saved_stats(name, saved, mean, rstd)
                (dx_auto,) = torch.autograd.grad(y, xs, dy)
                if not torch.equal(dx_auto, group_norm_silu_backward(
                        dy, x, w, b, saved[3], saved[4], False)[0]):
                    fail(f"{name}: autograd's dx != the kernel's at the saved "
                         "statistics")
                dx_only, _, _ = group_norm_silu_backward(
                    dy, x, w, b, mean, rstd, weight_grads=False)
                got = group_norm_silu_backward(dy, x, w, b, mean, rstd)
                flush()
                again = group_norm_silu_backward(dy, x, w, b, mean, rstd)
                torch.cuda.synchronize()
                if dx_only.stride() != x.stride():
                    fail(f"{name}: dx strides {dx_only.stride()} != x's")
                if not (torch.equal(dx_only, got[0]) and all(
                        torch.equal(u, v) for u, v in zip(got, again))):
                    fail(f"{name}: two launches on the same inputs differ")
                plain = group_norm_silu_backward_reference(dy, x, w, b, mean,
                                                           rstd)
                if tag == "bf16":
                    bwd_err["bf16_vs_plain"] = max(
                        bwd_err["bf16_vs_plain"],
                        check_close(f"{name} dx", got[0], plain[0],
                                    **TOL_GN_BF16))
                    for nm, u, v in zip(("dgamma", "dbeta"), got[1:],
                                        plain[1:]):
                        check_close(f"{name} {nm}", u, v, rtol=1e-3,
                                    atol=1e-3)
                    continue
                bwd_err["f32_vs_plain"] = max(bwd_err["f32_vs_plain"],
                                              max_abs(got[0], plain[0]))
                exact = group_norm_silu_backward_reference(
                    dy.double(), x.double(), w.double(), b.double(),
                    mean.double(), rstd.double())
                for nm, k_, p_, e_ in zip(("dx", "dgamma", "dbeta"), got,
                                          plain, exact):
                    err_k = float((k_.double() - e_).abs().max())
                    err_p = float((p_.double() - e_).abs().max())
                    yard[nm][0] = max(yard[nm][0], err_k)
                    yard[nm][1] = max(yard[nm][1], err_p)
                    if err_k > 2.0 * err_p + 1e-6:
                        fail(f"{name} {nm}: max |err| against float64 "
                             f"{err_k:.3g} exceeds twice the float32 plain "
                             f"backward's {err_p:.3g}")
    print(f"group_norm_silu_backward == plain at the same {len(gn_check)} "
          f"shapes + odd B=5 and B={B_MAIN + 1}, both layouts, dx alone and "
          f"with dγ, dβ; samples_per_cta > 1 (backward) at "
          + ", ".join(f"{k}: {v}" for k, v in spc["backward"].items())
          + "; "
          f"float32 max |err| against float64 (kernel / float32 plain): "
          + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}" for k, v in yard.items())
          + f"; bf16 dx max |err| {bwd_err['bf16_vs_plain']:.3g} (one bf16 "
          f"step); saved statistics equal to the plain version's bit for "
          f"bit; reruns bit-identical")
    details["gn_backward_float64_yardstick"] = yard
    details["gn_backward_max_abs_err"] = bwd_err

    # both GroupNorm kernels as a train step runs them, at every GN site of
    # the three trained U-Nets and of the experiment-1 ratio net (float32,
    # channels_last, B=B_TRAIN and an odd B_TRAIN-1): the forward's output
    # (1e-4) and saved statistics (bit for bit), then dx, dγ and dβ through
    # autograd, each within twice the float32 plain backward's max |err|
    # against the float64 plain backward, and two direct launches bit for
    # bit
    train_sites = {}
    ratio_sites = ratio_train_sites()
    for sites_of in ([unet_gn_sites(net, *shp) for net, shp in (
            (FlowMatchingUNetSVHN(), (3, 32)),
            (FlowMatchingUNetMNIST(img_size=32), (1, 32)),
            (FlowMatchingUNet(), (1, 28)))] + [ratio_sites]):
        for key, n in sites_of.items():
            train_sites[key] = train_sites.get(key, 0) + n
    train_yard = {"dx": [0.0, 0.0], "dgamma": [0.0, 0.0], "dbeta": [0.0, 0.0]}
    train_err = {"forward": 0.0, "backward": 0.0}

    def check_train_site(B, C, H, yard):
        """Both GN kernels at one site as a train step runs them (above);
        the float64 yardstick's worst errors go into `yard`."""
        name = f"training GN B={B} C={C} {H}x{H} f32 channels_last"
        x = (rnd(B, C, H, H) * 2.0 + 0.5).contiguous(
            memory_format=torch.channels_last)
        w = (torch.rand(C, generator=gen, device=dev) + 0.5
             ).requires_grad_(True)
        b = (rnd(C) * 0.1).requires_grad_(True)
        dy = rnd(B, C, H, H).contiguous(memory_format=torch.channels_last)
        xs = x.clone().requires_grad_(True)
        y = group_norm_silu(xs, w, b, 8)
        train_err["forward"] = max(train_err["forward"], check_close(
            f"{name} forward", y.detach(),
            group_norm_silu_reference(x, w.detach(), b.detach(), 8),
            **TOL_GN_F32))
        saved = y.grad_fn.saved_tensors
        mean, rstd = gn_stats_reference(x, 8)
        check_saved_stats(name, saved, mean, rstd)
        got = torch.autograd.grad(y, (xs, w, b), dy)
        wd, bd = w.detach(), b.detach()
        first = group_norm_silu_backward(dy, x, wd, bd, mean, rstd)
        flush()
        again = group_norm_silu_backward(dy, x, wd, bd, mean, rstd)
        torch.cuda.synchronize()
        if not (all(torch.equal(u, v) for u, v in zip(first, again))
                and all(torch.equal(u, v) for u, v in zip(got, first))):
            fail(f"{name}: two backward launches on the same inputs "
                 "differ")
        plain = group_norm_silu_backward_reference(dy, x, wd, bd, mean,
                                                   rstd)
        train_err["backward"] = max(train_err["backward"],
                                    max_abs(got[0], plain[0]))
        exact = group_norm_silu_backward_reference(
            dy.double(), x.double(), wd.double(), bd.double(),
            mean.double(), rstd.double())
        for nm, k_, p_, e_ in zip(("dx", "dgamma", "dbeta"), got, plain,
                                  exact):
            err_k = float((k_.double() - e_).abs().max())
            err_p = float((p_.double() - e_).abs().max())
            yard[nm][0] = max(yard[nm][0], err_k)
            yard[nm][1] = max(yard[nm][1], err_p)
            if err_k > 2.0 * err_p + 1e-6:
                fail(f"{name} {nm}: max |err| against float64 "
                     f"{err_k:.3g} exceeds twice the float32 plain "
                     f"backward's {err_p:.3g}")

    for B in (B_TRAIN, B_TRAIN - 1):
        for (C, H) in sorted(train_sites):
            check_train_site(B, C, H, train_yard)
    train_fwd_err, train_bwd_err = train_err["forward"], train_err["backward"]
    print(f"training GN sites ({len(train_sites)} (C,H) of the SVHN, "
          f"MNIST-32 and 28-px U-Nets and the experiment-1 ratio net's "
          f"{sum(ratio_sites.values())} sites {sorted(ratio_sites)}, "
          f"B={B_TRAIN} and {B_TRAIN - 1}, f32 "
          f"channels_last): forward max |err| {train_fwd_err:.3g}, saved "
          f"statistics bit for bit ({stats_checked[0]} entries checked in "
          f"phase 3); dx, dγ, dβ max |err| against float64 (kernel / float32 "
          f"plain): " + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}"
                                  for k, v in train_yard.items())
          + "; reruns bit-identical")
    details["training_gn_sites"] = {f"C{C}_H{H}": n for (C, H), n
                                    in sorted(train_sites.items())}
    details["training_gn_float64_yardstick"] = train_yard
    details["ratio_training_gn_plans"] = {
        f"B{B}_C{C}_H{H}": dict(
            forward_samples_per_cta=gn_plan(B, C, H, H, 8, 4,
                                            True).samples_per_cta,
            backward=vars(gn_backward_plan(B, C, H, H, 8, 4, True)))
        for B in (B_TRAIN, B_TRAIN - 1) for (C, H) in sorted(ratio_sites)}
    details["gn_saved_stats_entries_checked"] = stats_checked[0]
    # the fused BatchNorm+SiLU at the experiment-2 ratio net's 12 sites
    # (bn_kernels_check); the net's conv outputs, the kernels' inputs, are
    # channels_last on the card (no copy in the wrapper)
    bn_err = bn_kernels_check(dev)
    details["bn_silu_float64_yardstick"] = bn_err
    details["bn_silu_calls_in_one_forward"] = bn_sites_layout(dev)

    # slice 9: kernel B at the new paths' sampler shapes (the
    # encoder-decoder at B=N_MC and B=B_MAIN; the 64-px U-Nets at B=N64 and
    # B64 and the 64-px ratio net on the MC set; every merged-pair site of
    # the 28-px and 64-px U-Net pairs: 2C channels in 2G groups) in bf16
    # and float32, channels_last and NCHW, two launches bit for bit; then
    # both kernels as a train step runs them at the encoder-decoder's 7
    # sites (B_TRAIN and B_TRAIN-1) and FlowMatchingUNet64's 45 (B64_TRAIN
    # and B64_TRAIN-1)
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        FlowMatchingModel,
        FlowMatchingUNet64,
    )

    o_models = build_original_models(torch.bfloat16, dev)
    o_shapes, _ = layer_shapes(o_models, dev, E1_SHAPE, E1_SHAPE)
    m64 = build_64_models(torch.bfloat16, dev)
    s64_shapes, _ = layer_shapes(m64, dev, S64, S64, (N64, B64))
    sites64 = unet_gn_sites(FlowMatchingUNet64(), 3, 64)
    sites_e1 = unet_gn_sites(FlowMatchingUNet(), 1, 28)
    sites_o = model_gn_sites(FlowMatchingModel(), torch.zeros(1, 1, 28, 28),
                             torch.zeros(1))
    merged_gn = {}
    for sites_of, batches in ((sites_e1, (N_MC, B_MAIN)),
                              (sites64, (N64, B64))):
        for B in batches:
            for (C, H), n in sites_of.items():
                merged_gn[(B, 2 * C, H, 16)] = n
    s9_check = sorted({(B, C, H, 8) for (B, C, H) in set(o_shapes)
                       | set(s64_shapes)} | set(merged_gn))
    s9_err = {"bf16": 0.0, "f32": 0.0}
    for (B, C, H, G) in s9_check:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = (rnd(B, C, H, H) * 2.0 + 0.5).to(dt).contiguous(
                    memory_format=fmt)
                w = torch.rand(C, generator=gen, device=dev) + 0.5
                b = rnd(C) * 0.1
                got = group_norm_silu(x, w, b, G)
                again = group_norm_silu(x, w, b, G)
                torch.cuda.synchronize()
                if got.stride() != x.stride() or not torch.equal(got, again):
                    fail(f"group_norm_silu B={B} C={C} H={H} G={G}: output "
                         "strides differ from the input's, or two launches "
                         "differ")
                s9_err[tag] = max(s9_err[tag], check_close(
                    f"group_norm_silu {tag} B={B} C={C} H={H} G={G} {fmt}",
                    got, group_norm_silu_reference(x, w, b, G),
                    **tol_gn[tag]))
                del x, got, again
    gn_err = {k: max(gn_err[k], s9_err[k]) for k in gn_err}
    s9_yard = {"dx": [0.0, 0.0], "dgamma": [0.0, 0.0], "dbeta": [0.0, 0.0]}
    for sites_of, batch in ((sites_o, B_TRAIN), (sites64, B64_TRAIN)):
        for B in (batch, batch - 1):
            for (C, H) in sorted(sites_of):
                check_train_site(B, C, H, s9_yard)
    train_bwd_err = train_err["backward"]
    torch.cuda.empty_cache()
    print(f"slice-9 GN shapes: group_norm_silu == plain at {len(s9_check)} "
          f"(B,C,H,G) shapes (the encoder-decoder's, the 64-px U-Nets' and "
          f"ratio net's at B={N64} and {B64}, {len(merged_gn)} merged-pair "
          f"sites at 2C channels in 16 groups), both layouts, reruns "
          f"bit-identical; max |err| bf16 {s9_err['bf16']:.3g}, f32 "
          f"{s9_err['f32']:.3g}; training sites of the encoder-decoder "
          f"({sum(sites_o.values())} sites, B={B_TRAIN} and {B_TRAIN - 1}) "
          f"and FlowMatchingUNet64 ({sum(sites64.values())} sites, "
          f"{len(sites64)} (C,H), B={B64_TRAIN} and {B64_TRAIN - 1}): dx, "
          f"dγ, dβ max |err| against float64 (kernel / float32 plain): "
          + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}"
                      for k, v in s9_yard.items()))
    details["slice9_gn"] = dict(
        shapes=[f"B{B}_C{C}_H{H}_G{G}" for (B, C, H, G) in s9_check],
        max_abs_err=s9_err, training_float64_yardstick=s9_yard,
        original_sites={f"C{C}_H{H}": n for (C, H), n in sites_o.items()},
        unet64_sites={f"C{C}_H{H}": n for (C, H), n in sites64.items()})
    if sum(sites_o.values()) != 7 or sum(sites64.values()) != 45:
        fail(f"GN sites: encoder-decoder {sum(sites_o.values())} (7 "
             f"expected), FlowMatchingUNet64 {sum(sites64.values())} (45)")

    # slice 10: kernel A at the stretch demo's unequal halves (B=B64,
    # N=N64, Dx = 12,288, Dy = 4,096) held as at D = 4096 (hold_kernel_a:
    # the bounds, g within twice the float32 plain version's error against
    # float64, reruns bit for bit); kernel B at the sharded sampler's
    # row and shard batches (B_MAIN/2 and N_MC/2) of the experiment-2
    # U-Nets, both layouts, bf16 and float32; both GN kernels at the
    # MNIST-32 U-Net's training sites at the data-parallel ranks' B/2 rows
    yard10 = {}
    s10_in = None
    for tag, images in (("quarter_ints", quarter_ints), ("normal", rnd)):
        inputs = (images(B64, 64, 64, 3), images(B64, 64, 64, 1),
                  images(N64, 64, 64, 3), images(N64, 64, 64, 1), rnd(N64))
        s10_in = s10_in or inputs
        for t in (0.05, 0.5, 0.95):
            yard10[f"{tag}_t{t}"] = hold_kernel_a(
                f"Dx=12288 Dy=4096 {tag} t={t}", inputs, t, True)
    print(f"flash_guidance at the stretch demo's B={B64} N={N64} Dx=12288 "
          f"Dy=4096: scores and kernel 2 within their bounds, g within "
          f"twice the float32 plain version's error against float64 "
          f"(largest ratios " + ", ".join(
              f"{nm} {max(v['bound_ratios'][nm] for v in yard10.values()):.3g}"
              for nm in ("S", "g", "ess", "l"))
          + "), ess and l within 2e-2 of float64; reruns bit-identical")
    details["flash_guidance_d16384_yardstick"] = yard10
    sh_shapes, _ = layer_shapes(models, dev, X_SHAPE, Y_SHAPE,
                                (N_MC // 2, B_MAIN // 2))
    s10_err = {"bf16": 0.0, "f32": 0.0}
    for (B, C, H) in sorted(sh_shapes):
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = (rnd(B, C, H, H) * 2.0 + 0.5).to(dt).contiguous(
                    memory_format=fmt)
                w = torch.rand(C, generator=gen, device=dev) + 0.5
                b = rnd(C) * 0.1
                s10_err[tag] = max(s10_err[tag], check_close(
                    f"group_norm_silu {tag} B={B} C={C} H={H} {fmt}",
                    group_norm_silu(x, w, b, 8),
                    group_norm_silu_reference(x, w, b, 8), **tol_gn[tag]))
    gn_err = {k: max(gn_err[k], s10_err[k]) for k in gn_err}
    dp_yard = {"dx": [0.0, 0.0], "dgamma": [0.0, 0.0], "dbeta": [0.0, 0.0]}
    for (C, H) in sorted(unet_gn_sites(FlowMatchingUNetMNIST(img_size=32), 1,
                                       32)):
        check_train_site(B_TRAIN // 2, C, H, dp_yard)
    train_bwd_err = train_err["backward"]
    print(f"slice-10 GN shapes: group_norm_silu == plain at "
          f"{len(sh_shapes)} (B,C,H) sharded-sampler shapes (B={N_MC // 2} "
          f"and {B_MAIN // 2}), max |err| bf16 {s10_err['bf16']:.3g}, f32 "
          f"{s10_err['f32']:.3g}; the MNIST-32 U-Net's training sites at "
          f"B={B_TRAIN // 2}: dx, dγ, dβ max |err| against float64 (kernel "
          f"/ float32 plain): " + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}"
                                            for k, v in dp_yard.items()))
    details["slice10_gn"] = dict(
        sharded_shapes=[f"B{B}_C{C}_H{H}" for (B, C, H) in sorted(sh_shapes)],
        max_abs_err=s10_err, dp_training_float64_yardstick=dp_yard)

    # kernel C at every ResBlock norm1 -> conv1 shape of the U-Nets
    conv_err = {"f32": 0.0, "bf16_vs_f32": 0.0, "bf16": 0.0}
    conv_check = sorted(set(rb_shapes) | set(e1_rb_shapes))
    for (B, C, H, O) in conv_check + [(5, 96, 14, 32)]:
        x = rnd(B, H, H, C)
        sc, bi = 1.0 + 0.1 * rnd(C), 0.1 * rnd(C)
        w, cb = 0.2 * rnd(3, 3, C, O), 0.1 * rnd(O)
        tag = f"B={B} C={C} H={H} O={O}"
        got = fused_gn_silu_conv(x, sc, bi, w, cb, 8)
        torch.cuda.synchronize()
        conv_err["f32"] = max(conv_err["f32"], check_close(
            f"fused_gn_silu_conv f32 {tag}", got,
            fused_gn_silu_conv_reference(x, sc, bi, w, cb, 8),
            **TOL_CONV["f32"]))
        xb = x.to(torch.bfloat16)
        got = fused_gn_silu_conv(xb, sc, bi, w, cb, 8)
        torch.cuda.synchronize()
        conv_err["bf16_vs_f32"] = max(conv_err["bf16_vs_f32"], check_close(
            f"fused_gn_silu_conv bf16 {tag} (against float32 plain)", got,
            fused_gn_silu_conv_reference(xb.float(), sc, bi, w, cb, 8),
            **TOL_CONV["bf16_vs_f32"]))
        conv_err["bf16"] = max(conv_err["bf16"], check_close(
            f"fused_gn_silu_conv bf16 {tag}", got,
            fused_gn_silu_conv_reference(xb, sc, bi, w, cb, 8), **TOL_BF16))
    print(f"fused_gn_silu_conv == plain at {len(conv_check)} ResBlock "
          f"norm1->conv1 (B,C,H,O) shapes of both experiments' U-Nets + odd "
          f"B=5: max |err| f32 {conv_err['f32']:.3g}; bf16 against float32 "
          f"plain {conv_err['bf16_vs_f32']:.3g}, against bf16 plain "
          f"{conv_err['bf16']:.3g}")
    details["conv_shapes"] = {f"B{B}_C{C}_H{H}_O{O}": n for (B, C, H, O), n
                              in sorted(rb_shapes.items())}
    details["exp1_conv_shapes"] = {f"B{B}_C{C}_H{H}_O{O}": n
                                   for (B, C, H, O), n
                                   in sorted(e1_rb_shapes.items())}
    details["conv_max_abs_err"] = conv_err

    mark("3 kernels against their plain versions")

    # 4. each sampler on the card against the sampler on the CPU (plain
    #    versions): the same seeded weights in float32, injected noise and
    #    MC set
    def card_vs_cpu(name, make_models, x_shape, y_shape, method="mc_feng"):
        g_cpu = torch.Generator().manual_seed(3)
        inj = [torch.randn((8,) + x_shape, generator=g_cpu),
               torch.randn((8,) + y_shape, generator=g_cpu),
               torch.randn((16,) + x_shape, generator=g_cpu),
               torch.randn((16,) + y_shape, generator=g_cpu),
               torch.exp(torch.randn(16, generator=g_cpu))]
        outs = []      # [card, CPU]
        for d in (dev, torch.device("cpu")):
            x1, y1, diags = make_sampler(dict(
                num_steps=4, mc_batch_size=16, guidance_method=method,
                grad_strength=GRAD_STRENGTH), x_shape, y_shape)(
                make_models(torch.float32, d),
                torch.Generator(d).manual_seed(0),
                8, mc_set=tuple(a.to(d) for a in inj[2:]),
                init_noise=(inj[0].to(d), inj[1].to(d)))
            outs.append((x1.cpu(), y1.cpu())
                        + ((diags["ess"].cpu(),) if diags else ()))
        for nm, a, b in zip(("x1", "y1", "ess"), *outs):
            try:
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
            except AssertionError as e:
                fail(f"{name} {method} on the card != on the CPU ({nm})\n{e}")
        print(f"{name} {method} (f32, B=8, N_mc=16, 4 steps): card == CPU "
              f"within 1e-3")

    for method in ("mc_feng", "grad", "mc_feng+grad"):
        card_vs_cpu("sampler", build_models, X_SHAPE, Y_SHAPE, method)
        card_vs_cpu("experiment-1 sampler", build_exp1_models, E1_SHAPE,
                    E1_SHAPE, method)
    # slice 9: --model original (as above), merged against two nets on the
    # card (4m), the 64-px sampler against a float64-guidance yardstick (4x)
    card_vs_cpu("experiment-1 sampler, --model original",
                build_original_models, E1_SHAPE, E1_SHAPE)
    details["merged_card_max_abs_diff"] = merged_card_vs_two_net(dev)
    details["s64_card_vs_cpu"] = sampler64_card_vs_cpu(dev)
    mark("4 samplers card against CPU")

    # 4s. SMC on the card against SMC on the CPU, both experiments
    details["smc_card_vs_cpu"] = {
        "exp2": smc_card_vs_cpu("sampler", build_models, SMC_SCORE_STD["exp2"],
                                X_SHAPE, Y_SHAPE, dev),
        "exp1": smc_card_vs_cpu("experiment-1 sampler", build_exp1_models,
                                SMC_SCORE_STD["exp1"], E1_SHAPE, E1_SHAPE,
                                dev)}
    mark("4s SMC card against CPU")

    # 5. the main path, counted; 5b. where its time goes (a profiled
    #    5-step call, outside the counted run). Every full-width sampler
    #    path prints its convolution and dense FLOP rate (core/flops.py:
    #    the velocity nets and the guidance products; the ratio nets are
    #    not counted) beside the bf16 dense peak, its nets' compute type
    from ratio_guided_multimodal_fm_tpu_torch.core.flops import (
        flow_matching_model_flops,
        mnist_unet_flops,
        pair_sampler_flops,
        svhn_unet_flops,
        unet64_flops,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
        merged_pair_apply,
    )

    bf16_peak = ("bf16 dense", peak_bf16)

    def sampler_flops(fx, fy, d, method="mc_feng", batch=None, n_mc=None):
        mc = "mc_feng" in method
        return pair_sampler_flops(fx, fy, batch or B_MAIN, n_mc or N_MC,
                                  args.steps,
                                  d if mc else 0, with_phase_a=mc)

    def mnist28(b):
        return mnist_unet_flops(b, 28)

    sampler = make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC))
    warm = make_sampler(dict(num_steps=2, mc_batch_size=N_MC))
    warm(models, torch.Generator(dev).manual_seed(1), B_MAIN)
    sites = [gn_sites(net) for net in models[:2]]
    expected = {"flash_guidance": args.steps,
                "group_norm_silu": 2 * args.steps * sum(sites),
                "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
                "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                "linear_tf32x3": 0}
    details["main_path"] = run_main_path(
        "main path", sampler, models, expected, 2, X_SHAPE, Y_SHAPE,
        args.steps, smi, flops=sampler_flops(mnist_unet_flops,
                                             svhn_unet_flops, 4096),
        peak=bf16_peak)
    details["main_path"]["gn_sites"] = sites
    counts = details["main_path"]["launches"]
    prof_sampler = make_sampler(dict(num_steps=5, mc_batch_size=N_MC))
    details["profile"] = profile_call(
        lambda: prof_sampler(models, torch.Generator(dev).manual_seed(4),
                             B_MAIN), 5)

    mark("5 main path")

    # 5e. the experiment-1 path, counted, and its profile. The ratio net's
    #     GN sites run once, on the MC set.
    e1_sampler = make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC),
                              E1_SHAPE, E1_SHAPE)
    make_sampler(dict(num_steps=2, mc_batch_size=N_MC), E1_SHAPE, E1_SHAPE)(
        e1_models, torch.Generator(dev).manual_seed(1), B_MAIN)
    e1_sites = [gn_sites(net) for net in e1_models]
    e1_expected = {"flash_guidance": args.steps,
                   "group_norm_silu": (2 * args.steps * sum(e1_sites[:2])
                                       + e1_sites[2]),
                   "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
                   "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                   "linear_tf32x3": 0}
    details["exp1_path"] = run_main_path(
        "experiment-1 path", e1_sampler, e1_models, e1_expected, 2, E1_SHAPE,
        E1_SHAPE, args.steps, smi,
        flops=sampler_flops(mnist28, mnist28, 1568), peak=bf16_peak)
    details["exp1_path"]["gn_sites"] = e1_sites
    e1_prof = make_sampler(dict(num_steps=5, mc_batch_size=N_MC), E1_SHAPE,
                           E1_SHAPE)
    details["exp1_profile"] = profile_call(
        lambda: e1_prof(e1_models, torch.Generator(dev).manual_seed(4),
                        B_MAIN), 5)

    mark("5e experiment-1 path")

    # 5o. --model original, experiment 1, full width: two FlowMatchingModel
    #     in bf16 + RatioEstimatorMNIST (float32), B=512, N_mc=256, --steps
    #     steps, mc_feng at γ=0.5, counted and profiled as 5e
    o_sites = [gn_sites(net) for net in o_models]
    make_sampler(dict(num_steps=2, mc_batch_size=N_MC), E1_SHAPE, E1_SHAPE)(
        o_models, torch.Generator(dev).manual_seed(1), B_MAIN)
    details["original_path"] = run_main_path(
        "experiment-1 path, --model original",
        make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC), E1_SHAPE,
                     E1_SHAPE), o_models,
        {"flash_guidance": args.steps,
         "group_norm_silu": 2 * args.steps * sum(o_sites[:2]) + o_sites[2],
         "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
         "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
         "linear_tf32x3": 0},
        2, E1_SHAPE, E1_SHAPE, args.steps, smi,
        flops=sampler_flops(flow_matching_model_flops,
                            flow_matching_model_flops, 1568),
        peak=bf16_peak)
    details["original_path"]["gn_sites"] = o_sites
    details["original_profile"] = profile_call(
        lambda: make_sampler(dict(num_steps=5, mc_batch_size=N_MC), E1_SHAPE,
                             E1_SHAPE)(o_models,
                                       torch.Generator(dev).manual_seed(4),
                                       B_MAIN), 5)
    mark("5o --model original path")

    # 5m. --merged_unet on 5e's path (its nets and sizes): both U-Nets as
    #     one merged network, one GN launch per site pair; counted and
    #     profiled, then two-net and merged calls in turns (two-net,
    #     merged, merged, two-net) for the call-time comparison
    merged_e1 = merged_pair_apply(e1_models[0])
    m_sampler = make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC),
                             E1_SHAPE, E1_SHAPE, merged_e1)
    make_sampler(dict(num_steps=2, mc_batch_size=N_MC), E1_SHAPE, E1_SHAPE,
                 merged_e1)(e1_models, torch.Generator(dev).manual_seed(1),
                            B_MAIN)
    details["merged_exp1_path"] = run_main_path(
        "experiment-1 path, --merged_unet", m_sampler, e1_models,
        {"flash_guidance": args.steps,
         "group_norm_silu": args.steps * sum(e1_sites[:2]) + e1_sites[2],
         "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
         "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
         "linear_tf32x3": 0},
        2, E1_SHAPE, E1_SHAPE, args.steps, smi,
        flops=sampler_flops(mnist28, mnist28, 1568), peak=bf16_peak)
    details["merged_exp1_profile"] = profile_call(
        lambda: make_sampler(dict(num_steps=5, mc_batch_size=N_MC), E1_SHAPE,
                             E1_SHAPE, merged_e1)(
            e1_models, torch.Generator(dev).manual_seed(4), B_MAIN), 5)
    turns = []
    for tag, smp in (("two-net", e1_sampler), ("merged", m_sampler),
                     ("merged", m_sampler), ("two-net", e1_sampler)):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
        smp(e1_models, torch.Generator(dev).manual_seed(2), B_MAIN)
        ev1.record()
        torch.cuda.synchronize()
        turns.append((tag, ev0.elapsed_time(ev1) / 1e3))
    details["merged_vs_two_net_turns_s"] = turns
    e1p, mp = details["exp1_profile"], details["merged_exp1_profile"]
    print(f"experiment-1 call, two nets against --merged_unet in turns: "
          + ", ".join(f"{t} {sec:.3f} s" for t, sec in turns)
          + f"; kernels per 5 profiled steps {e1p['device_busy_ms']:.1f} / "
          f"{mp['device_busy_ms']:.1f} ms (busy {100 * e1p['device_busy_ms'] / e1p['wall_ms']:.0f}% / "
          f"{100 * mp['device_busy_ms'] / mp['wall_ms']:.0f}%)  [{smi}]")
    mark("5m --merged_unet path")

    # 5g. gradient guidance at full width. Experiment 1, mc_feng+grad: phase
    #     A and B as above, plus every step the ratio net's forward (its 8
    #     GN sites) and the backward kernel at each of them. Experiment 2,
    #     grad: no MC set (no phase A, no flash_guidance) and a BatchNorm
    #     ratio net, so no GN forward or backward beyond the U-Nets'.
    grad_kw = dict(mc_batch_size=N_MC, grad_strength=GRAD_STRENGTH)
    e1g_kw = dict(grad_kw, guidance_method="mc_feng+grad")
    e2g_kw = dict(grad_kw, guidance_method="grad")
    for kw, mdl, shp in ((e1g_kw, e1_models, (E1_SHAPE, E1_SHAPE)),
                         (e2g_kw, models, (X_SHAPE, Y_SHAPE))):
        make_sampler(dict(kw, num_steps=2), *shp)(
            mdl, torch.Generator(dev).manual_seed(1), B_MAIN)
    details["exp1_grad_path"] = run_main_path(
        "experiment-1 mc_feng+grad path",
        make_sampler(dict(e1g_kw, num_steps=args.steps), E1_SHAPE, E1_SHAPE),
        e1_models, {"flash_guidance": args.steps,
                    "group_norm_silu": (2 * args.steps * sum(e1_sites[:2])
                                        + e1_sites[2]
                                        + args.steps * e1_sites[2]),
                    "group_norm_silu_backward": args.steps * e1_sites[2],
                    "fused_gn_silu_conv": 0,
                    "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                    "linear_tf32x3": 0},
        2, E1_SHAPE, E1_SHAPE, args.steps, smi, method="mc_feng+grad",
        flops=sampler_flops(mnist28, mnist28, 1568), peak=bf16_peak)
    details["exp1_grad_profile"] = profile_call(
        lambda: make_sampler(dict(e1g_kw, num_steps=5), E1_SHAPE, E1_SHAPE)(
            e1_models, torch.Generator(dev).manual_seed(4), B_MAIN), 5)
    details["main_grad_path"] = run_main_path(
        "main grad path (experiment 2)",
        make_sampler(dict(e2g_kw, num_steps=args.steps)), models,
        {"flash_guidance": 0, "group_norm_silu": args.steps * sum(sites),
         "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
         "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
         "linear_tf32x3": 0},
        2, X_SHAPE, Y_SHAPE, args.steps, smi, method="grad",
        flops=sampler_flops(mnist_unet_flops, svhn_unet_flops, 4096, "grad"),
        peak=bf16_peak)
    details["main_grad_profile"] = profile_call(
        lambda: make_sampler(dict(e2g_kw, num_steps=5))(
            models, torch.Generator(dev).manual_seed(4), B_MAIN), 5)

    mark("5g grad paths")

    # 5s. SMC at full width on both experiments (the nets of phases 5 and
    #     5e, bf16 U-Nets, the ratio net's last layer redrawn: SMC_SCORE_STD),
    #     B=512, --steps Euler steps, γ=1, each experiment's CLI defaults
    #     (exp 2: islands of 8, tau 0.7; exp 1: 16, 0.5). No MC set, so no
    #     flash_guidance; per step both U-Nets and the ratio net once each.
    #     Then one 10-step call under the sync debug mode and a 5-step profile
    details["smc_paths"] = {}
    for tag, mdl, (xs, ys), grp, tau in (
            ("exp2", models, (X_SHAPE, Y_SHAPE), 8, 0.7),
            ("exp1", e1_models, (E1_SHAPE, E1_SHAPE), 16, 0.5)):
        smc_models = mdl[:2] + (smc_ratio(mdl[2], SMC_SCORE_STD[tag]),)
        kw = dict(x_shape=xs, y_shape=ys, resample_group=grp,
                  resample_tau=tau)
        make_smc(dict(kw, num_steps=2))(
            smc_models, torch.Generator(dev).manual_seed(1), B_MAIN)
        smc_sites = [gn_sites(net) for net in smc_models]
        rec = run_main_path(
            f"SMC path ({tag})", make_smc(dict(kw, num_steps=args.steps)),
            smc_models, {"flash_guidance": 0,
                         "group_norm_silu": args.steps * sum(smc_sites),
                         "group_norm_silu_backward": 0,
                         "fused_gn_silu_conv": 0,
                         "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                         "linear_tf32x3": 0},
            2, xs, ys, args.steps, smi, method="smc", gamma=SMC_GAMMA,
            flops=sampler_flops(*((mnist_unet_flops, svhn_unet_flops)
                                  if tag == "exp2" else (mnist28, mnist28)),
                                0, "smc"), peak=bf16_peak)
        rec.update(gn_sites=smc_sites, group=grp, tau=tau)
        rec["sync_debug"] = sync_debug_smc(
            f"SMC path ({tag})", make_smc(dict(kw, num_steps=10)),
            smc_models, dev)
        rec["profile"] = profile_call(
            lambda: make_smc(dict(kw, num_steps=5))(
                smc_models, torch.Generator(dev).manual_seed(4), B_MAIN), 5)
        details["smc_paths"][tag] = rec
    mark("5s SMC paths")

    # 5t. flow-matching training at full width (float32, B=B_TRAIN, Adam
    #     lr 1e-4, EMA 0.999): one step card against CPU, then a counted run
    #     of --train_steps steps through the epoch driver and a 5-step profile
    details["training"] = {}
    for name, make_net, shp in (("SVHN", FlowMatchingUNetSVHN, (32, 32, 3)),
                                ("MNIST-32",
                                 lambda: FlowMatchingUNetMNIST(img_size=32),
                                 (32, 32, 1))):
        rec = train_step_card_vs_cpu(name, make_net, shp, dev)
        rec.update(run_training(name, make_net, shp, args.train_steps, dev,
                                smi))
        details["training"][name] = rec

    mark("5t flow-matching training")

    # 5r. ratio-net training at full width (disc, float32, B=B_TRAIN, clip
    #     1.0, Adam lr 1e-4, EMA 0.999): one step card against CPU, then a
    #     counted run of --train_steps steps through the epoch driver with
    #     metrics-dict steps and a 5-step profile. The experiment-1 net runs
    #     both GN kernels at its 8 sites every step; the experiment-2 net's
    #     BatchNorm encoders run the fused BatchNorm+SiLU forward and
    #     backward at their 12.
    details["ratio_training"] = {}
    for name, make_net, xs, ys in (
            ("experiment-1 ratio (RatioEstimatorMNIST)", RatioEstimatorMNIST,
             E1_SHAPE, E1_SHAPE),
            ("experiment-2 ratio (RatioEstimatorMNISTSVHN)",
             RatioEstimatorMNISTSVHN, X_SHAPE, Y_SHAPE)):
        rec = ratio_step_card_vs_cpu(name, make_net, xs, ys, dev)
        rec.update(run_ratio_training(name, make_net, xs, ys,
                                      args.train_steps, dev, smi))
        details["ratio_training"][name.split(" (")[0]] = rec
    if details["ratio_training"]["experiment-1 ratio"]["gn_sites"] != 8:
        fail("the experiment-1 ratio net should hold 8 GN sites")
    mark("5r ratio-net training")

    # 5f. reflow at full width: coupling generation with the SVHN and
    #     MNIST-32 teachers (float32, gen batch B_MAIN, 100 Euler steps, 2
    #     batches each), counted; one reflow step card against CPU, its card
    #     launches held to one GN forward, backward and dγ/dβ per site
    details["reflow"] = {}
    for name, make_net, shp in (("SVHN", FlowMatchingUNetSVHN, (32, 32, 3)),
                                ("MNIST-32",
                                 lambda: FlowMatchingUNetMNIST(img_size=32),
                                 (32, 32, 1))):
        rec = run_couplings(name, make_net, shp, 100, 2, dev, smi)
        rec["step"] = train_step_card_vs_cpu(name, make_net, shp, dev,
                                             reflow=True)
        details["reflow"][name] = rec
    mark("5f reflow")

    # 5x. the 64-px config at full width: FlowMatchingUNet64 x2 (ch 96) and
    #     FlexibleRatioEstimator(3, 3), bf16, one mc_feng chunk at the
    #     demo's sizes (B=B64, N_mc=N64, --steps steps, γ=0.5), two-net
    #     and --merged_unet, counted and profiled; then one
    #     FlowMatchingUNet64's CFM training (float32, B=B64_TRAIN, Adam lr
    #     1e-4, EMA 0.999): one step card against CPU and TRAIN64_STEPS
    #     counted steps
    s64_sites = [gn_sites(net) for net in m64]
    details["s64_paths"] = {}
    for tag, pair in (("two-net", None), ("merged",
                                          merged_pair_apply(m64[0]))):
        kw = dict(mc_batch_size=N64)
        make_sampler(dict(kw, num_steps=2), S64, S64, pair)(
            m64, torch.Generator(dev).manual_seed(1), B64)
        per = 2 if pair is None else 1
        rec = run_main_path(
            f"64-px path ({tag})",
            make_sampler(dict(kw, num_steps=args.steps), S64, S64, pair),
            m64, {"flash_guidance": args.steps,
                  "group_norm_silu": (per * args.steps * sum(s64_sites[:2])
                                      + s64_sites[2]),
                  "group_norm_silu_backward": 0, "fused_gn_silu_conv": 0,
                  "batch_norm_silu": 0, "batch_norm_silu_backward": 0,
                  "linear_tf32x3": 0},
            2, S64, S64, args.steps, smi, batch=B64, n_mc=N64,
            flops=sampler_flops(unet64_flops, unet64_flops, 2 * 64 * 64 * 3,
                                batch=B64, n_mc=N64), peak=bf16_peak)
        rec["gn_sites"] = s64_sites
        rec["profile"] = profile_call(
            lambda: make_sampler(dict(kw, num_steps=5), S64, S64, pair)(
                m64, torch.Generator(dev).manual_seed(4), B64), 5)
        details["s64_paths"][tag] = rec
    del m64
    torch.cuda.empty_cache()
    rec = train_step_card_vs_cpu("64-px U-Net",
                                 lambda: FlowMatchingUNet64(in_channels=3),
                                 S64, dev)
    rec.update(run_training("64-px U-Net",
                            lambda: FlowMatchingUNet64(in_channels=3), S64,
                            TRAIN64_STEPS, dev, smi, batch=B64_TRAIN))
    details["training"]["64-px U-Net"] = rec
    if rec["gn_sites"] != 45:
        fail(f"FlowMatchingUNet64 holds {rec['gn_sites']} GN sites, not 45")
    torch.cuda.empty_cache()
    mark("5x 64-px config")

    # 5k. the fused K-step trainer (--fused_steps): the CUDA graph against
    #     the eager K-step loop, then the single step, K=1 and K=8 in turns
    details["fused_training"] = fused_training_phase(dev, smi)
    torch.cuda.empty_cache()
    mark("5k fused training")

    # 5d / 5p. two processes on the card (gloo): data-parallel training
    #     against one process; the MC-sharded sampler at full width
    import shutil

    mp_dir = tempfile.mkdtemp(prefix="rgmf_mp_")
    try:
        details["dp_training"] = dp_training_phase(dev, smi, mp_dir)
        mark("5d data-parallel training")
        details["sharded_sampler"] = sharded_sampler_phase(dev, smi, mp_dir,
                                                           args.steps)
        mark("5p sharded sampler")
    finally:
        shutil.rmtree(mp_dir, ignore_errors=True)

    # 6. kernel times beside their bounds
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    kernels = []
    t_mid = 0.5
    t32, sigma, inv_2s2, inv_sigma = _scalars(t_mid)

    def sdpa_for(inputs):
        """Library yardstick: scaled_dot_product_attention computes the
        weighted sum (g only, not ess or l) with q = [x_t | y_t], k = v =
        [X1 | Y1], attn_mask = log r - t²|k|²/(2σ²) and scale t/σ².
        Returns (the call, max |err| of its g against the kernel's)."""
        xt_, yt_, X1_, Y1_, lr_ = inputs
        B, N = xt_.shape[0], X1_.shape[0]
        q = torch.cat([xt_.reshape(B, -1), yt_.reshape(B, -1)],
                      1)[None, None]
        kv = torch.cat([X1_.reshape(N, -1), Y1_.reshape(N, -1)],
                       1)[None, None]
        mask = (lr_ - float(t32 * t32 * inv_2s2)
                * (kv[0, 0] * kv[0, 0]).sum(1))[None, None, None, :]
        scale = float(t32 / (sigma * sigma))

        def sdpa():
            return F.scaled_dot_product_attention(q, kv, kv, attn_mask=mask,
                                                  scale=scale)

        gx, gy, _, _ = flash_guidance(*inputs, t_mid)
        err = max_abs((sdpa()[0, 0] - q[0, 0]) * float(inv_sigma),
                      torch.cat([gx.reshape(B, -1), gy.reshape(B, -1)], 1))
        return sdpa, err

    # flash_guidance at the three widths (the 64-px path's at its B and N):
    # the four times of core/card.py:call_times, the plain version, the
    # library call and the bound
    capacity = card_capacity(dev.index or 0)
    fg_times = {}
    for tag, inputs in (("D4096", main_in), ("D1568", e1_in),
                        ("D24576", s64_in), ("D16384", s10_in)):
        B, N = inputs[0].shape[0], inputs[2].shape[0]
        Dx, Dy = inputs[0][0].numel(), inputs[1][0].numel()
        D = Dx + Dy
        fl = 2.0 * 2 * B * N * D             # two GEMMs, 2 flop/FMA
        by = 4.0 * (2 * B * D + N * D + N + 2 * B)
        row = call_times(lambda: flash_guidance(*inputs, t_mid), dev,
                         ("scores_kernel", "weighted_sum_kernel"), 2,
                         strict=False)
        sdpa, sdpa_err = sdpa_for(inputs)
        row.update(
            D=D, plain_ms=time_ms(
                lambda: flash_guidance_reference(*inputs, t_mid), dev),
            library_ms=time_ms(sdpa, dev), library_max_abs_err_g=sdpa_err,
            bound_ms=max(fl / peak_f32, by / peak_bw) * 1e3,
            bound_by="operations" if fl / peak_f32 > by / peak_bw else "bytes",
            plan=vars(guidance_plan(B, N, Dx, Dy, True, capacity)))
        fg_times[tag] = row
        check_bound(f"flash_guidance {tag}", row["bound_ms"],
                    row["bound_by"], by, device_ms=row["device_ms"],
                    device_cold_ms=row["device_cold_ms"],
                    event_ms=row["event_ms"])
        print(f"  flash_guidance B={B} N={N} D={D} f32: device "
              f"{ms_str(row['device_ms'])} ms (profiler, both kernels; L2 cold "
              f"{ms_str(row['device_cold_ms'])}), {row['event_ms']:.4f} by "
              f"events, "
              f"host {row['host_ms']:.4f} per call; plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}  [{smi}]")
    details["flash_guidance_times"] = fg_times
    details["flash_guidance_cluster_capacity"] = capacity

    sdpa, sdpa_err = sdpa_for(main_in)
    sdpa_ms = fg_times["D4096"]["library_ms"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    sdpa_events = {e.key[:100] for e in prof.key_averages()}
    sdpa_kernels = sorted({e.key[:100] for e in prof.key_averages()
                           if str(getattr(e, "device_type", "")).endswith(
                               "CUDA")})
    # the backend by the aten op that dispatch chose (host events), else by
    # the kernel names
    names = " ".join(sorted(sdpa_events)).lower()
    sdpa_backend = next((b for key, b in (
        ("_scaled_dot_product_flash", "flash"),
        ("_scaled_dot_product_efficient", "efficient"),
        ("_scaled_dot_product_cudnn", "cudnn"),
        ("_scaled_dot_product_attention_math", "math"),
        ("fmha", "efficient"), ("gemm", "math"), ("nvjet", "math"))
        if key in names), "not recorded" if not names else "unknown")
    # the backends that take these inputs, each forced alone
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa_eligible = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                sdpa()
            sdpa_eligible.append(backend.name)
        except RuntimeError:
            pass
    details["flash_guidance_library"] = dict(
        call="scaled_dot_product_attention", covers="g only (not ess, l)",
        backend=sdpa_backend, kernels=sdpa_kernels, eligible=sdpa_eligible,
        ms=sdpa_ms, max_abs_err_g=sdpa_err)
    # `ms` of flash_guidance is the device time of its two kernels (L2 warm,
    # like the event times of the plain version and the library call beside
    # it): 20 back-to-back wrapper calls by events follow the host's enqueue
    # rate as much as the kernels. Only where the profiler recorded nothing
    # is it the event time, and `ms_is` says so.
    main_row = fg_times["D4096"]
    fg_ms, fg_ms_is = main_row["device_ms"], (
        "device time by torch.profiler during which the wrapper's two "
        "kernels ran, L2 warm")
    if fg_ms is None:
        fg_ms, fg_ms_is = main_row["event_ms"], (
            "CUDA events around 20 back-to-back calls (the profiler "
            "recorded nothing in this run)")
    kernels.append(dict(
        name="flash_guidance", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/flash_guidance.cu",
        replaces="ratio_guided_multimodal_fm_tpu/ops/guidance_pallas.py:172",
        launches=counts["flash_guidance"], max_abs_err=fg_err,
        ms=fg_ms, plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=sdpa_ms, ms_is=fg_ms_is,
        d24576={k: fg_times["D24576"][k] for k in (
            "device_ms", "device_cold_ms", "event_ms", "host_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")},
        dx12288_dy4096={k: fg_times["D16384"][k] for k in (
            "device_ms", "device_cold_ms", "event_ms", "host_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}))
    D = fg_times["D4096"]["D"]

    per_shape = {}
    gn_call_ms = gn_call_dev_ms = gn_call_bound_ms = 0.0
    for (B, C, H), n in sorted(shapes.items()):
        x = rnd(B, C, H, H).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = torch.rand(C, generator=gen, device=dev) + 0.5, rnd(C) * 0.1
        k_ms = time_ms(lambda: group_norm_silu(x, w, b, 8), dev)
        try:
            k_dev, _ = device_ms(lambda: group_norm_silu(x, w, b, 8),
                                 "gn_silu_kernel", 1)
        except ProfilerSilent as e:
            print(f"  not measured: {e}")
            k_dev = None
        k_bytes = 2 * x.numel() * 2 + 2 * C * 4
        k_bound = k_bytes / peak_bw * 1e3
        check_bound(f"group_norm_silu B={B} C={C} {H}x{H} bf16", k_bound,
                    "bytes", k_bytes, device_ms=k_dev, event_ms=k_ms)
        per_shape[f"B{B}_C{C}_H{H}"] = dict(ms=k_ms, device_ms=k_dev,
                                            bound_ms=k_bound,
                                            calls_per_step=n)
        print(f"  group_norm_silu B={B} C={C} {H}x{H} bf16: {k_ms:.4f} ms "
              f"by events, {ms_str(k_dev)} ms on the device (profiler), "
              f"bound {k_bound:.4f} ms ({100 * k_bound / (k_dev or k_ms):.0f}"
              f"% of the {'device' if k_dev else 'event'} time), {n} calls "
              f"per step  [{smi}]")
        gn_call_ms += n * k_ms * args.steps
        if k_dev is None or gn_call_dev_ms is None:
            gn_call_dev_ms = None      # a sum that lacks a shape is no sum
        else:
            gn_call_dev_ms += n * k_dev * args.steps
        gn_call_bound_ms += n * k_bound * args.steps
    # representative shape: the SVHN level-0 map at B=512, 64 channels
    x = rnd(B_MAIN, 64, 32, 32).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.rand(64, generator=gen, device=dev) + 0.5, rnd(64) * 0.1
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    by = 2.0 * x.numel() * x.element_size() + 2 * 64 * 4
    kernels.append(dict(
        name="group_norm_silu", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/group_norm_silu.cu",
        replaces="ratio_guided_multimodal_fm_tpu/ops/groupnorm_pallas.py:68",
        launches=counts["group_norm_silu"], max_abs_err=gn_err["bf16"],
        ms=time_ms(lambda: group_norm_silu(x, w, b, 8), dev),
        plain_ms=time_ms(lambda: group_norm_silu_reference(x, w, b, 8), dev),
        bound_ms=by / peak_bw * 1e3, bound_by="bytes",
        library_ms=time_ms(
            lambda: F.silu(F.group_norm(x, 8, wb, bb, 1e-6)), dev),
        ms_is="CUDA events around 20 back-to-back calls",
        exp1_ratio_train_launches=details["ratio_training"][
            "experiment-1 ratio"]["launches"]["group_norm_silu"]))
    # the 64-px U-Net's largest site: 64 x 288 x 64 x 64 bf16 channels_last
    x = rnd(B64, 288, 64, 64).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.rand(288, generator=gen, device=dev) + 0.5, rnd(288) * 0.1
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    try:
        site_dev, _ = device_ms(lambda: group_norm_silu(x, w, b, 8),
                                "gn_silu_kernel", 1)
    except ProfilerSilent as e:
        print(f"  not measured: {e}")
        site_dev = None
    site = dict(
        shape=f"{B64}x288x64x64 bf16 channels_last",
        event_ms=time_ms(lambda: group_norm_silu(x, w, b, 8), dev),
        device_ms=site_dev,
        plain_ms=time_ms(lambda: group_norm_silu_reference(x, w, b, 8), dev),
        library_ms=time_ms(lambda: F.silu(F.group_norm(x, 8, wb, bb, 1e-6)),
                           dev),
        bound_ms=(2.0 * x.numel() * 2 + 2 * 288 * 4) / peak_bw * 1e3)
    kernels[-1]["unet64_largest_site"] = site
    check_bound(f"group_norm_silu {site['shape']}", site["bound_ms"],
                "bytes", 2.0 * x.numel() * 2, device_ms=site["device_ms"],
                event_ms=site["event_ms"])
    print(f"  group_norm_silu at the 64-px U-Net's largest site "
          f"{site['shape']}: {ms_str(site['device_ms'])} ms on the device "
          f"(profiler), {site['event_ms']:.4f} by events; plain "
          f"{site['plain_ms']:.4f}, library {site['library_ms']:.4f}, bound "
          f"{site['bound_ms']:.4f} by bytes  [{smi}]")
    del x
    details["gn_per_shape_bf16"] = per_shape
    details["gn_kernel_ms_per_sampler_call"] = gn_call_ms
    details["gn_device_ms_per_sampler_call"] = gn_call_dev_ms
    details["gn_bound_ms_per_sampler_call"] = gn_call_bound_ms

    # 6b. group_norm_silu's backward (dx alone, what gradient guidance asks
    #     for) at each GN site of the experiment-1 ratio net at B=512,
    #     float32 channels_last: the four times of call_times, the bound
    #     (read x and dy, write dx), the plain backward and the library call
    #     (autograd's backward of F.silu(F.group_norm(...)), its forward
    #     outside the timed region); summed over one grad call's sites
    bwd_rows = {}
    bwd_call = {"event_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
    for (B, C, H), n in sorted(ratio_gn_shapes(e1_models[2], dev,
                                               E1_SHAPE).items()):
        x = (rnd(B, C, H, H) * 2.0 + 0.5).contiguous(
            memory_format=torch.channels_last)
        w, b = torch.rand(C, generator=gen, device=dev) + 0.5, rnd(C) * 0.1
        dy = rnd(B, C, H, H).contiguous(memory_format=torch.channels_last)
        mean, rstd = gn_stats_reference(x, 8)
        xl = x.clone().requires_grad_(True)
        y_lib = F.silu(F.group_norm(xl, 8, w, b, 1e-6))
        row = call_times(
            lambda: group_norm_silu_backward(dy, x, w, b, mean, rstd, False),
            dev, ("gn_silu_bwd_kernel",), 1, strict=False)
        row.update(
            calls_per_step=n,
            bound_ms=3.0 * x.numel() * 4 / peak_bw * 1e3,
            plain_ms=time_ms(lambda: group_norm_silu_backward_reference(
                dy, x, w, b, mean, rstd, False), dev),
            library_ms=time_ms(lambda: torch.autograd.grad(
                y_lib, xl, dy, retain_graph=True), dev),
            plan=vars(backward_plan(x, dy, 8)))
        bwd_rows[f"B{B}_C{C}_H{H}"] = row
        check_bound(f"group_norm_silu_backward B={B} C={C} {H}x{H} dx",
                    row["bound_ms"], "bytes", 3.0 * x.numel() * 4,
                    device_ms=row["device_ms"],
                    device_cold_ms=row["device_cold_ms"],
                    event_ms=row["event_ms"])
        for k in bwd_call:
            bwd_call[k] = (None if bwd_call[k] is None or row[k] is None
                           else bwd_call[k] + n * row[k] * args.steps)
        print(f"  group_norm_silu_backward B={B} C={C} {H}x{H} f32 dx: "
              f"device {ms_str(row['device_ms'])} ms (L2 cold "
              f"{ms_str(row['device_cold_ms'])}), {row['event_ms']:.4f} by "
              f"events, host {row['host_ms']:.4f} per call; plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f} by bytes; {n} per step; "
              f"{plan_str(row['plan'])}  [{smi}]")
    print(f"  group_norm_silu_backward summed over one {args.steps}-step "
          f"experiment-1 grad call: {bwd_call['event_ms']:.2f} ms by events, "
          f"{ms_str(bwd_call['device_ms'], 2)} ms on the device, bound "
          f"{bwd_call['bound_ms']:.2f} ms  [{smi}]")
    details["gn_backward_times"] = bwd_rows
    details["gn_backward_ms_per_grad_call"] = bwd_call

    # 6t. the backward as a train step runs it, dx and the dγ/dβ second
    #     launch, at each GN site of the SVHN U-Net (B=B_TRAIN, float32,
    #     channels_last): the four times of call_times over both kernels,
    #     the bound (read x and dy, write dx, read the [B, G] statistics and
    #     w, b, write dγ, dβ), the plain backward and the library call
    #     (autograd's backward of F.silu(F.group_norm(...)) to x, w and b);
    #     summed over one train step's sites
    def train_backward_rows(sites, what, B=B_TRAIN):
        """The backward with dγ/dβ at each (C, H) of `sites` at batch B,
        timed four ways, with its bound, plain and library times; summed
        over one train step of `what`."""
        rows = {}
        step_sum = {"event_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
                    "library_ms": 0.0}
        for (C, H), n in sorted(sites.items()):
            x = (rnd(B, C, H, H) * 2.0 + 0.5).contiguous(
                memory_format=torch.channels_last)
            w, b = torch.rand(C, generator=gen, device=dev) + 0.5, \
                rnd(C) * 0.1
            dy = rnd(B, C, H, H).contiguous(
                memory_format=torch.channels_last)
            mean, rstd = gn_stats_reference(x, 8)
            xl, wl, bl = (v.clone().requires_grad_(True) for v in (x, w, b))
            y_lib = F.silu(F.group_norm(xl, 8, wl, bl, 1e-6))
            row = call_times(
                lambda: group_norm_silu_backward(dy, x, w, b, mean, rstd,
                                                 True),
                dev, ("gn_silu_bwd_kernel", "gn_wb_reduce_kernel"), 2,
                strict=False)
            by = 3.0 * x.numel() * 4 + 2 * B * 8 * 4 + 4 * C * 4
            row.update(
                calls_per_step=n, bound_ms=by / peak_bw * 1e3,
                plain_ms=time_ms(lambda: group_norm_silu_backward_reference(
                    dy, x, w, b, mean, rstd, True), dev),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    y_lib, (xl, wl, bl), dy, retain_graph=True), dev),
                plan=vars(backward_plan(x, dy, 8)))
            rows[f"B{B}_C{C}_H{H}"] = row
            check_bound(f"group_norm_silu_backward B={B} C={C} {H}x{H} "
                        f"dx+dγ/dβ", row["bound_ms"], "bytes", by,
                        device_ms=row["device_ms"],
                        device_cold_ms=row["device_cold_ms"],
                        event_ms=row["event_ms"])
            for k in step_sum:
                step_sum[k] = (None if step_sum[k] is None or row[k] is None
                               else step_sum[k] + n * row[k])
            print(f"  group_norm_silu_backward B={B} C={C} {H}x{H} f32 "
                  f"dx+dγ/dβ: device {ms_str(row['device_ms'])} ms (L2 cold "
                  f"{ms_str(row['device_cold_ms'])}), {row['event_ms']:.4f} "
                  f"by events, host {row['host_ms']:.4f} per call; plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f} by bytes; {n} per {what} "
                  f"step; {plan_str(row['plan'])}  [{smi}]")
        print(f"  group_norm_silu_backward (dx+dγ/dβ) summed over one {what} "
              f"train step's {sum(sites.values())} sites: "
              f"{step_sum['event_ms']:.3f} ms by events, "
              f"{ms_str(step_sum['device_ms'], 3)} ms on the device, library "
              f"{step_sum['library_ms']:.3f} ms, bound "
              f"{step_sum['bound_ms']:.3f} ms  [{smi}]")
        return rows, step_sum

    tr_rows, tr_step = train_backward_rows(
        unet_gn_sites(FlowMatchingUNetSVHN(), 3, 32), "SVHN")
    details["gn_backward_training_times"] = tr_rows
    details["gn_backward_ms_per_svhn_train_step"] = tr_step
    ratio_rows, ratio_step = train_backward_rows(ratio_sites,
                                                 "experiment-1 ratio")
    details["gn_backward_ratio_training_times"] = ratio_rows
    details["gn_backward_ms_per_exp1_ratio_train_step"] = ratio_step
    # the 64-px U-Net's two largest kinds of site (B64_TRAIN, the 8 sites of
    # 96 channels and the one of 288 at 64x64), whose slices do not fit a
    # CTA's shared memory at every plan
    u64_rows, _ = train_backward_rows(
        {k: sites64[k] for k in ((96, 64), (288, 64))}, "64-px",
        B=B64_TRAIN)
    details["gn_backward_unet64_times"] = u64_rows
    # the row: the SVHN U-Net's largest training site, dx + dγ/dβ
    largest = max(tr_rows, key=lambda k: tr_rows[k]["bound_ms"])
    top = tr_rows[largest]
    bwd_ms, bwd_ms_is = top["device_ms"], (
        "device time by torch.profiler during which either of the two "
        "kernels (dx, the dγ/dβ reduction) ran, L2 warm")
    if bwd_ms is None:
        bwd_ms, bwd_ms_is = top["event_ms"], (
            "CUDA events around 20 back-to-back calls (the profiler "
            "recorded nothing in this run)")
    svhn_launches = details["training"]["SVHN"]["launches"]
    r1 = ratio_rows[f"B{B_TRAIN}_C32_H28"]      # the ratio net's largest site
    r1_launches = details["ratio_training"]["experiment-1 ratio"]["launches"]
    kernels.append(dict(
        name="group_norm_silu_backward", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/"
               "group_norm_silu_backward.cu",
        replaces="none: JAX differentiates models/layers.py FusedGroupNorm",
        launches=svhn_launches["group_norm_silu_backward"],
        weight_grad_launches=svhn_launches[
            "group_norm_silu_backward (dγ/dβ)"],
        max_abs_err=train_bwd_err, ms=bwd_ms,
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by="bytes", library_ms=top["library_ms"], ms_is=bwd_ms_is,
        exp1_ratio_train_launches=r1_launches["group_norm_silu_backward"],
        exp1_ratio_train_weight_grad_launches=r1_launches[
            "group_norm_silu_backward (dγ/dβ)"],
        exp1_ratio_site=dict(
            shape=f"{B_TRAIN}x32x28x28 f32 channels_last, dx and dγ/dβ",
            ms=r1["device_ms"] if r1["device_ms"] is not None
            else r1["event_ms"], event_ms=r1["event_ms"],
            plain_ms=r1["plain_ms"], bound_ms=r1["bound_ms"],
            library_ms=r1["library_ms"]),
        exp1_ratio_step_ms=ratio_step,
        sites={k: {f: r[f] for f in ("device_ms", "device_cold_ms",
                                     "event_ms", "plain_ms", "library_ms",
                                     "bound_ms")}
               for k, r in list(tr_rows.items()) + list(u64_rows.items())
               + list(bwd_rows.items())}))

    # 6b'. the fused BatchNorm+SiLU at the experiment-2 ratio net's sites
    #      (bn_kernel_times), the row its B_TRAIN train step sums
    bn_times = bn_kernel_times(dev, smi, peak_bw)
    details["bn_silu_times"] = bn_times
    e2_launches = details["ratio_training"]["experiment-2 ratio"]["launches"]
    kernels.append(dict(
        name="batch_norm_silu", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/batch_norm_silu.cu",
        replaces="none: the JAX package composes flax's BatchNorm and SiLU "
                 "in XLA",
        launches=e2_launches["batch_norm_silu"],
        backward_launches=e2_launches["batch_norm_silu_backward"],
        max_abs_err=bn_err["y"], ms=bn_times["step"]["ms"],
        plain_ms=bn_times["step"]["plain_ms"],
        bound_ms=bn_times["step"]["bound_ms"], bound_by="bytes",
        library_ms=bn_times["step"]["library_ms"],
        ms_is=f"forward plus backward summed over one B={B_TRAIN} "
              "experiment-2 ratio train step's 12 sites, device time by "
              "torch.profiler, L2 warm"))

    # 6l. the 3×TF32 linear kernel: SiT-XL/2's eager step, then the bench
    sit = sit_linear_step(dev, smi)
    details["sit_linear_step"] = sit
    from ratio_guided_multimodal_fm_tpu_torch.cli import linear_kernel_bench

    with tempfile.TemporaryDirectory() as tmp:
        try:
            lin = linear_kernel_bench.main([
                "--out", os.path.join(tmp, "linear_kernel_bench.json")])
        except AssertionError as e:    # the kernel broke the 3×TF32 rule
            fail(f"linear bench: {e}")
    for row in lin["rows"]:
        check_bound(f"linear_tf32x3 {row['site']} {row['role']}",
                    row["bound_ms"], "operations", 0,
                    event_ms=row["kernel_ms"])
        print(f"  linear_tf32x3 {row['site']} {row['role']} {row['shape']}: "
              f"kernel {row['kernel_ms']:.4f} ms (split "
              f"{row['split_ms']:.4f}), library {row['library_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f} by operations; max |err| "
              f"{row['kernel_max_abs_err']:.3g} (float32 "
              f"{row['library_max_abs_err']:.3g}, TF32 "
              f"{row['tf32_max_abs_err']:.3g})  [{smi}]")
    details["linear_bench"] = lin
    fc1 = next(r for r in lin["rows"]
               if (r["site"], r["role"]) == ("fc1", "forward"))
    kernels.append(dict(
        name="linear_tf32x3", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/linear_tf32x3.cu",
        replaces="none: the JAX package leaves its dense layers to XLA",
        launches=sit["launches"], split_launches=sit["split_launches"],
        launches_are="one eager forward and backward of SiT-XL/2 at B=32",
        sit_xl2_eager_step_ms=sit["step_ms"],
        max_abs_err=fc1["kernel_max_abs_err"], ms=fc1["kernel_ms"],
        plain_ms=fc1["library_ms"], bound_ms=fc1["bound_ms"],
        bound_by="operations", library_ms=fc1["library_ms"],
        ms_is="CUDA events around 10 back-to-back calls of the wrapper "
              "(pre-pass and product); the plain version is the library's "
              "float32 product"))

    mark("6 kernel times")

    # 6c. the tier-C bench, kernel C's path, counted
    from ratio_guided_multimodal_fm_tpu_torch.cli import resblock_kernel_bench

    fused_gn_silu_conv.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            bench = resblock_kernel_bench.main([
                "--out", os.path.join(tmp, "resblock_kernel_bench.json")])
        except AssertionError as e:    # a row's kernel != its plain version
            fail(f"tier-C bench: {e}")
    conv_launches = fused_gn_silu_conv.launches
    conv_expected = len(bench["rows"]) * (1 + resblock_kernel_bench.WARMUP
                                          + resblock_kernel_bench.ITERS)
    if conv_launches != conv_expected:
        fail(f"tier-C bench: fused_gn_silu_conv launched {conv_launches} "
             f"times, derived {conv_expected}")
    for row in bench["rows"]:
        print(f"  tier-C {row['shape']} bf16: kernel {row['kernel_ms']:.4f} "
              f"ms, port (kernel B + cuDNN conv) {row['port_ms']:.4f}, "
              f"library (cuDNN composition) {row['library_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}; max |err| vs plain "
              f"{row['kernel_max_abs_err_vs_plain']:.3g}  [{smi}]")
    row0 = bench["rows"][0]
    kernels.append(dict(
        name="fused_gn_silu_conv", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/"
               "fused_gn_silu_conv.cu",
        replaces="ratio_guided_multimodal_fm_tpu/ops/resblock_pallas.py:88",
        launches=conv_launches, max_abs_err=conv_err["bf16"],
        ms=row0["kernel_ms"], plain_ms=row0["plain_ms"],
        bound_ms=row0["bound_ms"], bound_by=row0["bound_by"],
        library_ms=row0["library_ms"],
        ms_is="CUDA events around 20 back-to-back calls"))
    details["resblock_bench"] = bench
    details["kernel_shapes"] = {
        "flash_guidance": f"B={B_MAIN} N={N_MC} D={D} f32 t={t_mid}",
        "group_norm_silu": f"B={B_MAIN} C=64 H=W=32 bf16 channels_last",
        "group_norm_silu_backward": f"{largest} f32 channels_last, dx and "
                                    "dγ/dβ (the SVHN U-Net's largest "
                                    "training site)",
        "fused_gn_silu_conv": f"{row0['shape']} bf16 NHWC groups=8",
        "linear_tf32x3": "SiT-XL/2's fc1 forward, M=8192 K=1152 N=4608 "
                         "f32 (every site and role: details.linear_bench)",
        "batch_norm_silu": f"the experiment-2 ratio net's 12 sites at "
                           f"B={B_TRAIN}, f32 channels_last, forward and "
                           "backward"}
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms/launch (plain "
              f"{k['plain_ms']:.4f}, library {k['library_ms']}), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}, "
              f"{k['launches']} launches  [{smi}]")
    print(f"  group_norm_silu summed over one sampler call's shapes: "
          f"{gn_call_ms:.1f} ms by events, {ms_str(gn_call_dev_ms, 1)} ms on "
          f"the device, bound {gn_call_bound_ms:.1f} ms  [{smi}]")
    print(f"  flash_guidance library call: scaled_dot_product_attention "
          f"(backend: {sdpa_backend}; backends that take the "
          f"inputs: {sdpa_eligible}) {sdpa_ms:.4f} ms, g only; max |err| of "
          f"its g {sdpa_err:.3g}  [{smi}]")

    mark("6c tier-C bench")

    # 7. the CLIs on random-init reference-layout .pth files
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        evaluate,
        evaluate_mnist_svhn,
        sample,
        sample_mnist_svhn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.models import (
        MNISTClassifier,
        MNISTClassifier32,
        SVHNClassifier,
    )

    def run_cli(name, cli, nets, files, argv):
        """cli.main(argv) in a fresh directory holding `nets` as the .pth
        `files`; returns (wall s, what main returned, the directory's
        outputs/ as {relative path: parsed JSON})."""
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.makedirs(os.path.join(tmp, "checkpoints"))
            for net, fname in zip(nets, files):
                torch.save({k: v.detach().cpu().contiguous()
                            for k, v in net.state_dict().items()},
                           os.path.join(tmp, "checkpoints", fname))
            os.chdir(tmp)
            try:
                h0 = time.perf_counter()
                out = cli.main(argv)
                cli_s = time.perf_counter() - h0
                written = {}
                for root, _, fnames in os.walk("outputs"):
                    for fn in fnames:
                        if fn.endswith(".json"):
                            with open(os.path.join(root, fn)) as f:
                                written[os.path.join(root, fn)] = json.load(f)
            finally:
                os.chdir(cwd)
        return cli_s, out, written

    exp2_files = ("flow_mnist32_best.pth", "flow_svhn_best.pth",
                  "ratio_disc_mnist_svhn_best.pth")
    exp1_files = ("flow_x_best.pth", "flow_y_rotate90_best.pth",
                  "ratio_disc_rotate90_best.pth")
    details["cli_s"] = {}
    for method, extra in (("mc_feng", []),
                          ("mc_feng+grad", ["--mc_refresh", "2"])):
        argv = ["--guidance_method", method, "--num_samples", "64",
                "--num_steps", "20", "--mc_batch_size", str(N_MC),
                "--dtype", "bf16"] + extra
        for name, cli, nets, files, trace in (
                ("sample_mnist_svhn", sample_mnist_svhn, models, exp2_files,
                 os.path.join("outputs", "mnist_svhn",
                              f"diagnostics_{method}_gamma{GAMMA}.json")),
                ("sample", sample, e1_models, exp1_files,
                 os.path.join("outputs", f"diagnostics_{method}_gamma"
                                         f"{GAMMA}_rotate90.json"))):
            cli_s, (sx, sy, _), written = run_cli(name, cli, nets, files,
                                                  argv)
            rows = written.get(trace, [])
            if (len(rows) != 20 or not bool(torch.isfinite(sx).all())
                    or not bool(torch.isfinite(sy).all())):
                fail(f"CLI {name} {' '.join(argv)}: bad trace or non-finite "
                     "samples")
            print(f"CLI {name} ({method} {' '.join(extra)}, 64 pairs, 20 "
                  f"steps, bf16): {cli_s:.1f} s wall, {len(rows)} diagnostic "
                  f"rows  [{smi}]")
            details["cli_s"][f"{name} {method} {' '.join(extra)}".strip()] = \
                cli_s

    # the evaluation CLIs: the sweep of the JAX CLIs on random-init flows,
    # ratio nets and classifiers, classifier-FID against the synthetic
    # digits (RGMF_SYNTH_N: 2000 training, 1000 test images)
    os.environ.setdefault("RGMF_SYNTH_N", "2000")
    torch.manual_seed(20)
    clfs = [MNISTClassifier(), MNISTClassifier32(), SVHNClassifier()]
    eval_argv = ["--guidance_methods", "none", "mc_feng", "grad",
                 "mc_feng+grad", "--guidance_strengths", "0", str(GAMMA),
                 "--num_steps", "20", "--num_samples", str(B_MAIN // 2),
                 "--mc_batch_size", str(N_MC), "--fid",
                 "--dtype", "bf16", "--grad_strength", str(GRAD_STRENGTH)]
    base_keys = {"method", "guidance_strength", "coherence_acc",
                 "num_samples", "label_entropy_x", "label_entropy_y",
                 "n_chunks", "chunk_policy"}
    mc_keys = {"mc_set_ess", "ess_final_mean", "ess_final_min",
               "ess_trajectory_min", "ess_trajectory_mean"}
    details["eval_cli"] = {}
    for name, cli, nets, files, keys in (
            ("evaluate", evaluate, e1_models + (clfs[0],),
             exp1_files + ("mnist_classifier.pth",),
             base_keys | {"transform_type", "classifier_fid_x"}),
            ("evaluate_mnist_svhn", evaluate_mnist_svhn,
             models + (clfs[1], clfs[2]),
             exp2_files + ("mnist32_classifier.pth", "svhn_classifier.pth"),
             base_keys | {"classifier_fid_mnist"})):
        cli_s, results, written = run_cli(name, cli, nets, files, eval_argv)
        if len(results) != 7 or list(written.values()) != [results]:
            fail(f"CLI {name}: {len(results)} results, files "
                 f"{sorted(written)}")
        for r in results:
            want = keys | (mc_keys if "mc_feng" in r["method"] else set())
            nums = [v for k, v in r.items() if k not in (
                "method", "chunk_policy", "transform_type", "mc_set_ess")]
            if set(r) != want or not all(np.isfinite(nums)):
                fail(f"CLI {name}: result {r} (keys {sorted(set(r) ^ want)} "
                     "differ from the JAX CLI's, or a value is not finite)")
        print(f"CLI {name} (none, mc_feng, grad, mc_feng+grad at γ in (0, "
              f"{GAMMA}), {B_MAIN // 2} pairs in 4 chunks, N_mc={N_MC}, 20 "
              f"steps, bf16, --fid): "
              f"{cli_s:.1f} s wall; coherence "
              + ", ".join(f"{r['method']}@{r['guidance_strength']} "
                          f"{r['coherence_acc']:.3f}" for r in results)
              + f"  [{smi}]")
        details["eval_cli"][name] = dict(seconds=cli_s, results=results)

    mark("7 sample and evaluate CLIs")

    # the train CLIs for one epoch on the synthetic digits (RGMF_SYNTH_N
    # training images, B_TRAIN a step), in one directory: the flows, the
    # ratio nets and the evaluation classifiers; then the sample CLIs of
    # both experiments (with and without --ema and --ratio_ema) and the
    # evaluate CLIs on those checkpoints alone: every weight the port uses
    # in this part was trained by the port
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        train_classifier,
        train_classifiers_mnist_svhn,
        train_flow,
        train_flow_mnist32,
        train_flow_svhn,
        train_ratio,
        train_ratio_mnist_svhn,
    )

    synth_n = os.environ.get("RGMF_SYNTH_N")
    os.environ["RGMF_SYNTH_N"] = str(CLI_TRAIN_IMAGES)
    cwd = os.getcwd()
    details["train_cli"] = {}
    details["trained_chain"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            train_argv = ["--epochs", "1", "--batch_size", str(B_TRAIN)]
            ema = ["--ema_decay", str(EMA_DECAY)]
            steps = CLI_TRAIN_IMAGES // B_TRAIN
            for name, cli, extra in (
                    ("train_flow_mnist32", train_flow_mnist32,
                     ema + ["--save_every", "1"]),
                    ("train_flow_svhn", train_flow_svhn,
                     ema + ["--save_every", "1"]),
                    ("train_flow x", train_flow,
                     ema + ["--save_every", "1", "--modality", "x"]),
                    ("train_flow y", train_flow,
                     ema + ["--save_every", "1", "--modality", "y"]),
                    ("train_ratio", train_ratio, ema),
                    ("train_ratio_mnist_svhn", train_ratio_mnist_svhn, ema)):
                h0 = time.perf_counter()
                _, best, hist = cli.main(train_argv + extra)
                cli_s = time.perf_counter() - h0
                if not (np.isfinite(best) and hist and hist[-1]["epoch"] == 1):
                    fail(f"CLI {name}: best loss {best}, history {hist}")
                metrics = {k: v for k, v in hist[-1].items()
                           if k not in ("epoch", "steps_per_sec")}
                print(f"CLI {name} (1 epoch, {steps} steps at B={B_TRAIN}, "
                      f"EMA {EMA_DECAY}): {cli_s:.1f} s wall (synthetic "
                      f"digits and the first step included), "
                      + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                      + f", {hist[-1]['steps_per_sec']:.2f} steps/s in the "
                      f"epoch  [{smi}]")
                details["train_cli"][name] = dict(
                    seconds=cli_s, loss=best, metrics=metrics,
                    steps_per_s=hist[-1]["steps_per_sec"])
            for name, cli in (("train_classifier", train_classifier),
                              ("train_classifiers_mnist_svhn",
                               train_classifiers_mnist_svhn)):
                h0 = time.perf_counter()
                out = cli.main(train_argv)
                cli_s = time.perf_counter() - h0
                runs = out.values() if isinstance(out, dict) else [out]
                hists = [h[-1] for _, h in runs]
                if not all(np.isfinite(h["loss"]) for h in hists):
                    fail(f"CLI {name}: non-finite loss {hists}")
                print(f"CLI {name} (1 epoch, {steps} steps at B={B_TRAIN}): "
                      f"{cli_s:.1f} s wall; " + "; ".join(
                          f"loss {h['loss']:.4f}, train_acc "
                          f"{h['train_acc']:.4f}, test_acc "
                          f"{h['test_acc']:.4f}" for h in hists)
                      + f"  [{smi}]")
                details["train_cli"][name] = dict(seconds=cli_s,
                                                  epochs=hists)
            written = sorted(os.listdir("checkpoints"))
            want = sorted([f"flow_{m}{e}_{s}.pth"
                           for m in ("mnist32", "svhn", "x", "y_rotate90")
                           for e, s in (("", "best"), ("_ema", "best"),
                                        ("", "epoch1"))]
                          + [f"ratio_disc_{t}{e}_best.pth"
                             for t in ("rotate90", "mnist_svhn")
                             for e in ("", "_ema")]
                          + [f"{c}_classifier.pth"
                             for c in ("mnist", "mnist32", "svhn")])
            if written != want:
                fail(f"train CLIs wrote {written}, expected {want}")
            for name, cli, flags in (
                    ("sample_mnist_svhn", sample_mnist_svhn, []),
                    ("sample_mnist_svhn", sample_mnist_svhn,
                     ["--ema", "--ratio_ema"]),
                    ("sample", sample, []),
                    ("sample", sample, ["--ema", "--ratio_ema"])):
                h0 = time.perf_counter()
                sx, sy, diags = cli.main(
                    ["--guidance_method", "mc_feng", "--num_samples", "64",
                     "--num_steps", "20", "--mc_batch_size", str(N_MC)]
                    + flags)
                if not (bool(torch.isfinite(sx).all())
                        and bool(torch.isfinite(sy).all())
                        and len(diags["ess"]) == 20):
                    fail(f"CLI {name} {flags} on the trained checkpoints: "
                         "non-finite samples or a short trace")
                print(f"CLI {name} {' '.join(flags)} on the flows and ratio "
                      f"net the train CLIs wrote (mc_feng, 64 pairs, 20 "
                      f"steps): {time.perf_counter() - h0:.1f} s wall  "
                      f"[{smi}]")
            chain_argv = ["--guidance_methods", "none", "mc_feng",
                          "mc_feng+grad", "--guidance_strengths", "0",
                          str(GAMMA), "--num_steps", "20", "--num_samples",
                          str(B_MAIN // 2), "--mc_batch_size", str(N_MC),
                          "--fid", "--ema", "--ratio_ema", "--dtype", "bf16"]
            for name, cli, fid_key in (
                    ("evaluate", evaluate, "classifier_fid_x"),
                    ("evaluate_mnist_svhn", evaluate_mnist_svhn,
                     "classifier_fid_mnist")):
                h0 = time.perf_counter()
                results = cli.main(chain_argv)
                cli_s = time.perf_counter() - h0
                if (len(results) != 5 or not all(
                        np.isfinite(r["coherence_acc"])
                        and np.isfinite(r[fid_key]) for r in results)):
                    fail(f"CLI {name} on the trained checkpoints: {results}")
                print(f"CLI {name} on the flows, ratio net and classifiers "
                      f"the train CLIs wrote (EMA weights; none, mc_feng, "
                      f"mc_feng+grad at γ in (0, {GAMMA}), {B_MAIN // 2} "
                      f"pairs, 20 steps, bf16, --fid): {cli_s:.1f} s wall; "
                      + ", ".join(f"{r['method']}@{r['guidance_strength']} "
                                  f"coherence {r['coherence_acc']:.3f} FID "
                                  f"{r[fid_key]:.2f}" for r in results)
                      + f"  [{smi}]")
                details["trained_chain"][name] = dict(seconds=cli_s,
                                                      results=results)
            mark("7 train CLIs and the trained chain")
            details["reflow_cli"] = reflow_and_smc_clis(smi)
            mark("7 reflow and smc CLIs")
            details["serve"] = serve_phase(smi)
            mark("7v serve")
            details["slice9_cli"] = slice9_clis(smi)
            mark("7 slice-9 CLIs")
            details["slice10_cli"] = slice10_clis(smi)
            mark("7 slice-10 CLIs")
        finally:
            os.chdir(cwd)
            if synth_n is None:
                os.environ.pop("RGMF_SYNTH_N")
            else:
                os.environ["RGMF_SYNTH_N"] = synth_n

    # 8q: experiment 1 trained through the CLIs, its coherence gate
    details["exp1_trained"] = exp1_trained_phase(smi, Q8)
    mark("8q experiment 1 trained")

    # the kernels' launches on this slice's paths: SMC (5s), the couplings
    # and the reflow step (5f), serve (7v), the trained experiment 1 (8q)
    by_name = {k["name"]: k for k in kernels}
    for k in kernels:
        k["exp1_trained_launches"] = details["exp1_trained"]["launches"][
            k["name"]]
    for tag, rec in details["smc_paths"].items():
        for k in kernels:
            k[f"smc_{tag}_launches"] = rec["launches"][k["name"]]
    by_name["group_norm_silu"]["reflow_coupling_launches"] = {
        n: r["launches"]["group_norm_silu"]
        for n, r in details["reflow"].items()}
    by_name["group_norm_silu_backward"]["reflow_step_launches"] = {
        n: r["step"]["launches"] for n, r in details["reflow"].items()}
    for nm in ("flash_guidance", "group_norm_silu"):
        by_name[nm]["serve_launches"] = details["serve"]["launches"][nm]
    # slice 9: --model original (5o), --merged_unet (5m), the 64-px paths
    # and training (5x)
    new_paths = {"original": details["original_path"],
                 "merged_exp1": details["merged_exp1_path"],
                 "s64_two_net": details["s64_paths"]["two-net"],
                 "s64_merged": details["s64_paths"]["merged"],
                 "s64_training": details["training"]["64-px U-Net"]}
    for k in kernels:
        for tag, rec in new_paths.items():
            k[f"{tag}_launches"] = rec["launches"][k["name"]]
    # slice 10: the fused trainer's graph at K=8 per macro step (5k), one
    # rank's sharded-sampler call on each mesh (5p), the stretch demo (7)
    for k in kernels:
        k["fused_k8_launches_per_macro_step"] = {
            n: r[f"graph K={K_FUSED}"]["launches_per_macro_step"][
                k["name"]]
            for n, r in details["fused_training"].items()}
        for tag, r in details["sharded_sampler"].items():
            k[f"sharded_{tag}_launches_per_rank"] = \
                r["ranks"][0]["launches"][k["name"]]
        k["stretch64_demo_launches"] = details["slice10_cli"][
            "stretch64_demo"]["launches"][k["name"]]
    details["kernels"] = kernels
    details["total_s"] = time.perf_counter() - t_start
    print(f"total {details['total_s']:.1f} s")
    print("details: " + json.dumps(details))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
