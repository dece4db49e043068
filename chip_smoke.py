#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--steps N]

Run from the repository root. Imports nothing of JAX. Phases, each of
which fails the script (non-zero exit) on error:

1. versions, the card and its power limit (nvidia-smi);
2. builds the CUDA C++ kernels from csrc/ (all nvcc runs in parallel);
3. holds every hand-written kernel against its plain PyTorch version on
   the card: flash_guidance at both main-path shapes (D = 4096 and the
   experiment-1 D = 1568) for t in {0.05, 0.5, 0.95} plus a ragged shape
   (rtol 1e-3, atol 1e-4, on images that float32 sums exactly), on N(0,1)
   images against the plain version run in float64 (the kernel's max |err|
   in g at most twice the float32 plain version's, ess and l within rtol
   2e-2), and two launches on the same inputs bit for bit; group_norm_silu at every (B, C, H) shape the
   U-Nets and the experiment-1 ratio net run, in channels_last and NCHW
   memory, in bfloat16 (one bf16 step: rtol 2**-7, atol 1e-3) and float32
   (1e-4), plus an odd batch; fused_gn_silu_conv at every
   (B, C, H, O) shape a ResBlock's norm1 -> conv1 sees in those U-Nets plus
   an odd batch, in float32 (2e-4) and bfloat16 (rtol 0.1, atol 0.15
   against the float32 plain version, and rtol 2**-7, atol 0.05 against
   the bfloat16 plain version);
4. checks each experiment's full-width sampler on the card against the
   same sampler on the CPU (plain versions) on a small input;
5. drives the main path once with the launch counters set to 0: random-init
   FlowMatchingUNetMNIST(32) + FlowMatchingUNetSVHN + RatioEstimatorMNISTSVHN,
   bf16 activations, B=512 pairs, N_mc=256, --steps Euler steps (default
   100), mc_feng at γ=0.5; asserts finite outputs, 1 <= ESS <= N_mc and the
   launch counts derived from the code; then profiles a 5-step call;
5e. the same for experiment 1 (MNIST-28 ↔ transformed MNIST): random-init
   FlowMatchingUNet (28 px) x2 in bf16 + RatioEstimatorMNIST (disc,
   float32), B=512, N_mc=256, --steps steps, mc_feng at γ=0.5;
6. times each kernel, its plain version and the library call where one
   exists (scaled_dot_product_attention for flash_guidance's weighted sum),
   beside the kernel's bound at the card's published peak rates;
   flash_guidance at both widths four ways (CUDA events, device time by
   the profiler with L2 warm and cold, host time per call:
   core/card.py:call_times), and
   group_norm_silu at every main-path GN shape (CUDA events, and device
   time by the profiler) beside its bytes bound, summed over one sampler
   call;
6c. runs the tier-C bench (cli/resblock_kernel_bench.py), the path of
   fused_gn_silu_conv, with its launch counter set to 0; the bench holds
   the kernel against the bfloat16 plain version at each of its shapes
   (rtol 2**-7, atol 0.05) and its rows carry the bounds of the kernels
   line (peaks from core/card.py);
7. runs both sampler CLIs on random-init reference-layout .pth files.

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

B_MAIN, N_MC, GAMMA = 512, 256, 0.5
X_SHAPE, Y_SHAPE = (32, 32, 1), (32, 32, 3)
E1_SHAPE = (28, 28, 1)          # experiment 1: both modalities
TOL_GUIDANCE = dict(rtol=1e-3, atol=1e-4)
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
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for net in (fm_m, fm_s):
            net.out_conv.weight.copy_(
                torch.randn(net.out_conv.weight.shape, generator=g) * 0.02)
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
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for net in (fm_x, fm_y):
            net.out_conv.weight.copy_(
                torch.randn(net.out_conv.weight.shape, generator=g) * 0.02)
    return tuple(place_model(m, device) for m in (fm_x, fm_y, ratio))


def layer_shapes(models, device, x_shape, y_shape):
    """Shapes on the main path (B=N_MC in phase A, B=B_MAIN in phase B), by
    forward hooks: {(B, C, H): calls} of every GroupNormSiLU and
    {(B, C, H, O): calls} of every ResBlock's norm1 -> conv1, per forward
    pair at that B, plus the ratio net's GroupNormSiLU calls on the MC set
    (experiment 1)."""
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
        for B in (N_MC, B_MAIN):
            t = torch.full((B,), 0.5, device=device)
            for net, shp in zip(models, (x_shape, y_shape)):
                velocity_fn(net)(torch.zeros((B,) + shp, device=device), t)
        ratio_log_fn(models[2])(torch.zeros((N_MC,) + x_shape, device=device),
                                torch.zeros((N_MC,) + y_shape, device=device))
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    return gn, rb


def gn_sites(net) -> int:
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
    )

    return sum(isinstance(m, GroupNormSiLU) for m in net.modules())


def profile_call(run, steps: int):
    """Device time by kernel over one profiled call of `run` (a sampler
    call of `steps` steps, outside any counted run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
    by_kernel = sorted(
        ((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
         for e in prof.key_averages()
         if getattr(e, "device_type", None) is not None
         and str(e.device_type).endswith("CUDA")),
        key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    gn = [r for r in by_kernel if "gn_silu_kernel" in r[0]]
    gn_ms, gn_n = sum(r[1] for r in gn), sum(r[2] for r in gn)
    print(f"profile ({steps} steps, profiler on): wall {wall * 1e3:.1f} ms, "
          f"kernels {busy_ms:.1f} ms "
          f"({100 * busy_ms / max(wall * 1e3, 1e-9):.0f}% busy); "
          f"group_norm_silu {gn_ms:.1f} ms over {gn_n} launches")
    for k, ms_k, n in by_kernel[:8]:
        print(f"  {ms_k:9.2f} ms {n:6d}x  {k[:90]}")
    return dict(steps=steps, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                group_norm_silu_ms=gn_ms, group_norm_silu_launches=gn_n,
                top=[dict(kernel=k[:120], ms=ms, calls=n)
                     for k, ms, n in by_kernel[:25]])


def run_main_path(name, sampler, models, expected, gen_seed, x_shape,
                  y_shape, steps, smi):
    """One counted sampler call: every launch counter set to 0 just before,
    read just after and held to `expected`; finite samples of the right
    shape and 1 <= ESS <= N_mc. Returns the record."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.ops import (
        flash_guidance,
        fused_gn_silu_conv,
        group_norm_silu,
    )

    wrappers = {"flash_guidance": flash_guidance,
                "group_norm_silu": group_norm_silu,
                "fused_gn_silu_conv": fused_gn_silu_conv}
    dev = next(models[0].parameters()).device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    ev0.record()
    x1, y1, diags = sampler(models, torch.Generator(dev).manual_seed(gen_seed),
                            B_MAIN)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - h0
    counts = {k: w.launches for k, w in wrappers.items()}
    dev_s = ev0.elapsed_time(ev1) / 1e3
    if counts != expected:
        fail(f"{name}: launch counts {counts} != derived {expected}")
    if (tuple(x1.shape) != (B_MAIN,) + x_shape
            or tuple(y1.shape) != (B_MAIN,) + y_shape
            or not bool(torch.isfinite(x1).all())
            or not bool(torch.isfinite(y1).all())):
        fail(f"{name}: non-finite or mis-shaped samples")
    ess = diags["ess"]
    if not (float(ess.min()) >= 1.0 - 1e-4
            and float(ess.max()) <= N_MC * (1 + 1e-4)):
        fail(f"{name}: ESS outside [1, {N_MC}]: [{float(ess.min())}, "
             f"{float(ess.max())}]")
    sps = B_MAIN / dev_s
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name}: B={B_MAIN} N_mc={N_MC} steps={steps} bf16 "
          f"mc_feng γ={GAMMA}: {dev_s:.3f} s on the card (CUDA events), "
          f"{wall_s:.3f} s wall -> {sps:.1f} samples/s; peak mem "
          f"{peak_gib:.2f} GiB; launches {counts}; ESS "
          f"[{float(ess.min()):.3f}, {float(ess.max()):.3f}]  [{smi}]")
    return dict(batch=B_MAIN, n_mc=N_MC, steps=steps, seconds_device=dev_s,
                seconds_wall=wall_s, samples_per_s=sps, peak_mem_gib=peak_gib,
                launches=counts)


def make_sampler(cfg_kw, x_shape=X_SHAPE, y_shape=Y_SHAPE):
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
        make_guided_sampler_p,
    )

    cfg = GuidedSamplerConfig(guidance_method="mc_feng",
                              guidance_strength=GAMMA, x_shape=x_shape,
                              y_shape=y_shape, **cfg_kw)
    return make_guided_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                                 lambda m, y, t: velocity_fn(m)(y, t), cfg,
                                 lambda r, x, y: ratio_log_fn(r)(x, y))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100,
                    help="Euler steps of the main-path run (default 100)")
    args = ap.parse_args(argv)

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
        from ratio_guided_multimodal_fm_tpu_torch.ops import _build
        from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
            TOL_BF16 as TOL_GN_BF16,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
            group_norm_silu,
            group_norm_silu_reference,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
            _scalars,
            card_capacity,
            flash_guidance,
            flash_guidance_reference,
            guidance_plan,
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
    details = {}

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

    # 3. every kernel against its plain version, at main-path shapes
    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def guidance_inputs(B, N, H, images, lr_scale=1.0, y_ch=3):
        return (images(B, H, H, 1), images(B, H, H, y_ch), images(N, H, H, 1),
                images(N, H, H, y_ch), rnd(N) * lr_scale)

    def quarter_ints(*shape):
        # Quarter-integers in [-2, 2]: at D=4096 every product and partial
        # sum is exact in float32, so the kernel's and the plain version's
        # summation orders cannot move the scores. With N(0,1) images the
        # scores are ~2000 in magnitude and float32 rounding alone shifts
        # near-tied weights by more than atol (see PERF.md).
        return torch.randint(-8, 9, shape, generator=gen, device=dev) / 4.0

    fg_err = 0.0
    main_in = guidance_inputs(B_MAIN, N_MC, 32, quarter_ints)
    e1_in = guidance_inputs(B_MAIN, N_MC, 28, quarter_ints, y_ch=1)
    cases = [(main_in, t) for t in (0.05, 0.5, 0.95)]
    cases += [(e1_in, t) for t in (0.05, 0.5, 0.95)]
    cases.append((guidance_inputs(5, 300, 5, rnd, lr_scale=5.0), 0.7))
    for inputs, t in cases:
        got = flash_guidance(*inputs, t)
        torch.cuda.synchronize()
        want = flash_guidance_reference(*inputs, t)
        D_in = inputs[0][0].numel() + inputs[1][0].numel()
        for nm, a, b in zip(("g_x", "g_y", "ess", "l"), got, want):
            err = check_close(f"flash_guidance {nm} B={inputs[0].shape[0]} "
                              f"D={D_in} t={t}", a, b, **TOL_GUIDANCE)
            if inputs is main_in or inputs is e1_in:
                fg_err = max(fg_err, err)
    print(f"flash_guidance == plain: main shapes D=4096 and D=1568 "
          f"(quarter-integer images) t in (0.05, 0.5, 0.95) and B=5,N=300 "
          f"ragged (N(0,1)); max |err| {fg_err:.3g}")
    # N(0,1) images: no fixed tolerance holds (see quarter_ints), so the
    # yardstick is the plain version run in float64. The kernel's max |err|
    # in g may be at most twice the float32 plain version's: both are float32
    # sums of the same length in another order, so their errors are draws of
    # one distribution, and the largest of 2M such draws differs between two
    # draws by tens of percent, not by a factor.
    yardstick = {}
    for tag, H, y_ch in (("D4096", 32, 3), ("D1568", 28, 1)):
        normal_in = guidance_inputs(B_MAIN, N_MC, H, rnd, y_ch=y_ch)
        for t in (0.05, 0.5, 0.95):
            got = flash_guidance(*normal_in, t)
            torch.cuda.synchronize()
            plain = flash_guidance_reference(*normal_in, t)
            exact = flash_guidance_reference(*normal_in, t, torch.float64)
            err_k, err_p = (max(float((r[i].double() - exact[i]).abs().max())
                                for i in (0, 1)) for r in (got, plain))
            # ess and l: the same rounding moves them by ~1e-3 of their value
            rel_k, rel_p = (max(float(((r[i].double() - exact[i]).abs()
                                       / exact[i].abs()).max())
                                for i in (2, 3)) for r in (got, plain))
            yardstick[f"{tag}_t{t}"] = dict(kernel=err_k, plain_f32=err_p,
                                            kernel_ess_l_rel=rel_k,
                                            plain_f32_ess_l_rel=rel_p)
            for i, nm in ((2, "ess"), (3, "l")):
                check_close(f"flash_guidance {nm} {tag} t={t} on N(0,1) images "
                            "against float64", got[i].double(), exact[i],
                            rtol=2e-2, atol=1e-4)
            if err_k > 2.0 * err_p + 1e-6:
                fail(f"flash_guidance {tag} t={t} on N(0,1) images: max |err| "
                     f"in g against float64 {err_k:.3g} exceeds twice the "
                     f"float32 plain version's {err_p:.3g}")
    print("flash_guidance against the float64 plain version, N(0,1) images, "
          "max |err| in g (kernel / float32 plain): " + ", ".join(
              f"{k} {v['kernel']:.3g} / {v['plain_f32']:.3g}"
              for k, v in yardstick.items())
          + "; ess and l within rtol 2e-2 of float64, largest relative error "
          + "(kernel / float32 plain) "
          + " / ".join(f"{max(v[key] for v in yardstick.values()):.3g}"
                       for key in ("kernel_ess_l_rel", "plain_f32_ess_l_rel")))
    details["flash_guidance_float64_yardstick"] = yardstick
    # the cluster's ranks add in rank order and nothing is atomic: two
    # launches on the same inputs, the L2 flushed in between, give the same bits
    flush = l2_flusher(dev)
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

    models = build_models(torch.bfloat16, dev)
    shapes, rb_shapes = layer_shapes(models, dev, X_SHAPE, Y_SHAPE)
    e1_models = build_exp1_models(torch.bfloat16, dev)
    e1_shapes, e1_rb_shapes = layer_shapes(e1_models, dev, E1_SHAPE,
                                           E1_SHAPE)
    gn_err = {"bf16": 0.0, "f32": 0.0}
    tol_gn = {"bf16": TOL_GN_BF16, "f32": TOL_GN_F32}
    odd = (5, 96, 16)
    gn_check = sorted(set(shapes) | set(e1_shapes))
    for (B, C, H) in gn_check + [odd]:
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
          f"shapes of both experiments (ratio net included) + odd B=5, "
          f"channels_last and NCHW; max |err| bf16 {gn_err['bf16']:.3g} "
          f"(rtol 2**-7, atol 1e-3), f32 {gn_err['f32']:.3g}")
    details["gn_shapes"] = {f"B{B}_C{C}_H{H}": n
                            for (B, C, H), n in sorted(shapes.items())}
    details["exp1_gn_shapes"] = {f"B{B}_C{C}_H{H}": n
                                 for (B, C, H), n in sorted(e1_shapes.items())}

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

    # 4. each sampler on the card against the sampler on the CPU (plain
    #    versions): the same seeded weights in float32, injected noise and
    #    MC set
    def card_vs_cpu(name, make_models, x_shape, y_shape):
        g_cpu = torch.Generator().manual_seed(3)
        inj = [torch.randn((8,) + x_shape, generator=g_cpu),
               torch.randn((8,) + y_shape, generator=g_cpu),
               torch.randn((16,) + x_shape, generator=g_cpu),
               torch.randn((16,) + y_shape, generator=g_cpu),
               torch.exp(torch.randn(16, generator=g_cpu))]
        outs = []      # [card, CPU]
        for d in (dev, torch.device("cpu")):
            x1, y1, diags = make_sampler(dict(num_steps=4, mc_batch_size=16),
                                         x_shape, y_shape)(
                make_models(torch.float32, d),
                torch.Generator(d).manual_seed(0),
                8, mc_set=tuple(a.to(d) for a in inj[2:]),
                init_noise=(inj[0].to(d), inj[1].to(d)))
            outs.append((x1.cpu(), y1.cpu(), diags["ess"].cpu()))
        for nm, a, b in zip(("x1", "y1", "ess"), *outs):
            try:
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
            except AssertionError as e:
                fail(f"{name} on the card != {name} on the CPU ({nm})\n{e}")
        print(f"{name} (f32, B=8, N_mc=16, 4 steps): card == CPU within 1e-3")

    card_vs_cpu("sampler", build_models, X_SHAPE, Y_SHAPE)
    card_vs_cpu("experiment-1 sampler", build_exp1_models, E1_SHAPE, E1_SHAPE)

    # 5. the main path, counted; 5b. where its time goes (a profiled
    #    5-step call, outside the counted run)
    sampler = make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC))
    warm = make_sampler(dict(num_steps=2, mc_batch_size=N_MC))
    warm(models, torch.Generator(dev).manual_seed(1), B_MAIN)
    sites = [gn_sites(net) for net in models[:2]]
    expected = {"flash_guidance": args.steps,
                "group_norm_silu": 2 * args.steps * sum(sites),
                "fused_gn_silu_conv": 0}
    details["main_path"] = run_main_path(
        "main path", sampler, models, expected, 2, X_SHAPE, Y_SHAPE,
        args.steps, smi)
    details["main_path"]["gn_sites"] = sites
    counts = details["main_path"]["launches"]
    prof_sampler = make_sampler(dict(num_steps=5, mc_batch_size=N_MC))
    details["profile"] = profile_call(
        lambda: prof_sampler(models, torch.Generator(dev).manual_seed(4),
                             B_MAIN), 5)

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
                   "fused_gn_silu_conv": 0}
    details["exp1_path"] = run_main_path(
        "experiment-1 path", e1_sampler, e1_models, e1_expected, 2, E1_SHAPE,
        E1_SHAPE, args.steps, smi)
    details["exp1_path"]["gn_sites"] = e1_sites
    e1_prof = make_sampler(dict(num_steps=5, mc_batch_size=N_MC), E1_SHAPE,
                           E1_SHAPE)
    details["exp1_profile"] = profile_call(
        lambda: e1_prof(e1_models, torch.Generator(dev).manual_seed(4),
                        B_MAIN), 5)

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
        q = torch.cat([xt_.reshape(B_MAIN, -1), yt_.reshape(B_MAIN, -1)],
                      1)[None, None]
        kv = torch.cat([X1_.reshape(N_MC, -1), Y1_.reshape(N_MC, -1)],
                       1)[None, None]
        mask = (lr_ - float(t32 * t32 * inv_2s2)
                * (kv[0, 0] * kv[0, 0]).sum(1))[None, None, None, :]
        scale = float(t32 / (sigma * sigma))

        def sdpa():
            return F.scaled_dot_product_attention(q, kv, kv, attn_mask=mask,
                                                  scale=scale)

        gx, gy, _, _ = flash_guidance(*inputs, t_mid)
        err = max_abs((sdpa()[0, 0] - q[0, 0]) * float(inv_sigma),
                      torch.cat([gx.reshape(B_MAIN, -1),
                                 gy.reshape(B_MAIN, -1)], 1))
        return sdpa, err

    # flash_guidance at both widths: the four times of core/card.py:
    # call_times, the plain version, the library call and the bound
    capacity = card_capacity(dev.index or 0)
    fg_times = {}
    for tag, inputs in (("D4096", main_in), ("D1568", e1_in)):
        Dx, Dy = inputs[0][0].numel(), inputs[1][0].numel()
        D = Dx + Dy
        fl = 2.0 * 2 * B_MAIN * N_MC * D             # two GEMMs, 2 flop/FMA
        by = 4.0 * (2 * B_MAIN * D + N_MC * D + N_MC + 2 * B_MAIN)
        row = call_times(lambda: flash_guidance(*inputs, t_mid), dev,
                         ("scores_kernel", "weighted_sum_kernel"),
                         strict=False)
        sdpa, sdpa_err = sdpa_for(inputs)
        row.update(
            D=D, plain_ms=time_ms(
                lambda: flash_guidance_reference(*inputs, t_mid), dev),
            library_ms=time_ms(sdpa, dev), library_max_abs_err_g=sdpa_err,
            bound_ms=max(fl / peak_f32, by / peak_bw) * 1e3,
            bound_by="operations" if fl / peak_f32 > by / peak_bw else "bytes",
            plan=vars(guidance_plan(B_MAIN, N_MC, Dx, Dy, True, capacity)))
        fg_times[tag] = row
        print(f"  flash_guidance B={B_MAIN} N={N_MC} D={D} f32: device "
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
        library_ms=sdpa_ms, ms_is=fg_ms_is))
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
                                 "gn_silu_kernel")
        except ProfilerSilent as e:
            print(f"  not measured: {e}")
            k_dev = None
        k_bound = (2 * x.numel() * 2 + 2 * C * 4) / peak_bw * 1e3
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
        ms_is="CUDA events around 20 back-to-back calls"))
    details["gn_per_shape_bf16"] = per_shape
    details["gn_kernel_ms_per_sampler_call"] = gn_call_ms
    details["gn_device_ms_per_sampler_call"] = gn_call_dev_ms
    details["gn_bound_ms_per_sampler_call"] = gn_call_bound_ms

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
        "fused_gn_silu_conv": f"{row0['shape']} bf16 NHWC groups=8"}
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

    # 7. the CLIs on random-init reference-layout .pth files
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        sample,
        sample_mnist_svhn,
    )

    def run_cli(name, cli, nets, files, argv, trace):
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
                sx, sy, _ = cli.main(argv)
                cli_s = time.perf_counter() - h0
                with open(trace) as f:
                    rows = json.load(f)
            finally:
                os.chdir(cwd)
        if (len(rows) != 20 or not bool(torch.isfinite(sx).all())
                or not bool(torch.isfinite(sy).all())):
            fail(f"CLI {name}: bad trace or non-finite samples")
        print(f"CLI {name} (mc_feng, 64 pairs, 20 steps, bf16): "
              f"{cli_s:.1f} s wall, {len(rows)} diagnostic rows")
        return cli_s

    cli_argv = ["--guidance_method", "mc_feng", "--num_samples", "64",
                "--num_steps", "20", "--dtype", "bf16"]
    details["cli_s"] = {
        "sample_mnist_svhn": run_cli(
            "sample_mnist_svhn", sample_mnist_svhn, models,
            ("flow_mnist32_best.pth", "flow_svhn_best.pth",
             "ratio_disc_mnist_svhn_best.pth"), cli_argv,
            os.path.join("outputs", "mnist_svhn",
                         f"diagnostics_mc_feng_gamma{GAMMA}.json")),
        "sample": run_cli(
            "sample", sample, e1_models,
            ("flow_x_best.pth", "flow_y_rotate90_best.pth",
             "ratio_disc_rotate90_best.pth"), cli_argv,
            os.path.join("outputs",
                         f"diagnostics_mc_feng_gamma{GAMMA}_rotate90.json"))}

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
