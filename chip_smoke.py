#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--steps N]

Run from the repository root. Imports nothing of JAX. Phases, each of
which fails the script (non-zero exit) on error:

1. versions, the card and its power limit (nvidia-smi);
2. builds the CUDA C++ kernels from csrc/ (all nvcc runs in parallel);
3. holds every hand-written kernel against its plain PyTorch version on
   the card: flash_guidance at the main-path shape for t in {0.05, 0.5,
   0.95} plus a ragged shape (rtol 1e-3, atol 1e-4); group_norm_silu at
   every (B, C, H) shape the two U-Nets run, in bfloat16 (0.05) and
   float32 (1e-4), plus an odd batch;
4. checks the full-width sampler on the card against the same sampler on
   the CPU (plain versions) on a small input;
5. drives the main path once with the launch counters set to 0: random-init
   FlowMatchingUNetMNIST(32) + FlowMatchingUNetSVHN + RatioEstimatorMNISTSVHN,
   bf16 activations, B=512 pairs, N_mc=256, --steps Euler steps (default
   100), mc_feng at γ=0.5; asserts finite outputs, 1 <= ESS <= N_mc and the
   launch counts derived from the code;
6. times each kernel, its plain version and the library call where one
   exists, beside the kernel's bound at the card's published peak rates;
7. runs the port's sampler CLI on random-init reference-layout .pth files.

The line before the last is the `kernels` JSON; the card's name and power
limit are printed before it, and before that a `details` JSON line (GN
shapes and per-shape times, the profile, the main-path record); the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

B_MAIN, N_MC, GAMMA = 512, 256, 0.5
X_SHAPE, Y_SHAPE = (32, 32, 1), (32, 32, 3)
TOL_GUIDANCE = dict(rtol=1e-3, atol=1e-4)
TOL_GN = {"bf16": 0.05, "f32": 1e-4}

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# (float32 non-tensor FLOP/s, memory bytes/s) by the name nvidia-smi gives.
PEAKS = {"H100 PCIe": (51e12, 2.0e12), "H100 NVL": (60e12, 3.9e12),
         "H100": (67e12, 3.35e12), "H200": (67e12, 4.8e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks_for(name: str):
    for key, val in PEAKS.items():      # most specific names first
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` runs."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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


def gn_shapes(models, device):
    """(B, C, H) of every GroupNormSiLU call of both U-Nets on the main
    path (B=N_MC in phase A, B=B_MAIN in phase B), by forward hooks."""
    import torch

    from ratio_guided_multimodal_fm_tpu_torch.cli.common import velocity_fn
    from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
        GroupNormSiLU,
    )

    shapes = {}
    hooks = []

    def hook(mod, args):
        B, C, H, _ = args[0].shape
        shapes[(B, C, H)] = shapes.get((B, C, H), 0) + 1

    for net in models:
        hooks += [m.register_forward_pre_hook(hook) for m in net.modules()
                  if isinstance(m, GroupNormSiLU)]
    with torch.no_grad():
        for B in (N_MC, B_MAIN):
            t = torch.full((B,), 0.5, device=device)
            for net, shp in zip(models, (X_SHAPE, Y_SHAPE)):
                velocity_fn(net)(torch.zeros((B,) + shp, device=device), t)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    return shapes     # {(B, C, H): calls per forward pair at that B}


def make_sampler(cfg_kw):
    from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
        ratio_log_fn,
        velocity_fn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
        GuidedSamplerConfig,
        make_guided_sampler_p,
    )

    cfg = GuidedSamplerConfig(guidance_method="mc_feng",
                              guidance_strength=GAMMA, x_shape=X_SHAPE,
                              y_shape=Y_SHAPE, **cfg_kw)
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
        from ratio_guided_multimodal_fm_tpu_torch.core.device import (
            resolve_device,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops import _build
        from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
            group_norm_silu,
            group_norm_silu_reference,
        )
        from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
            flash_guidance,
            flash_guidance_reference,
        )
        from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
            GroupNormSiLU,
        )
    except ImportError as e:
        fail(f"the port package is not importable ({e}); run from the "
             "repository root")
    t_start = time.perf_counter()
    details = {}

    # 1. versions and the card
    dev = resolve_device("cuda")       # pins float32 (no TF32)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    peak_key, (peak_f32, peak_bw) = peaks_for(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {kind} x{torch.cuda.device_count()}; peaks used "
          f"({peak_key}): {peak_f32 / 1e12:.0f} TFLOP/s f32, "
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

    def guidance_inputs(B, N, H, images, lr_scale=1.0):
        return (images(B, H, H, 1), images(B, H, H, 3), images(N, H, H, 1),
                images(N, H, H, 3), rnd(N) * lr_scale)

    def quarter_ints(*shape):
        # Quarter-integers in [-2, 2]: at D=4096 every product and partial
        # sum is exact in float32, so the kernel's and the plain version's
        # summation orders cannot move the scores. With N(0,1) images the
        # scores are ~2000 in magnitude and float32 rounding alone shifts
        # near-tied weights by more than atol (see PERF.md).
        return torch.randint(-8, 9, shape, generator=gen, device=dev) / 4.0

    fg_err = 0.0
    main_in = guidance_inputs(B_MAIN, N_MC, 32, quarter_ints)
    cases = [(main_in, t) for t in (0.05, 0.5, 0.95)]
    cases.append((guidance_inputs(5, 300, 5, rnd, lr_scale=5.0), 0.7))
    for inputs, t in cases:
        got = flash_guidance(*inputs, t)
        torch.cuda.synchronize()
        want = flash_guidance_reference(*inputs, t)
        for nm, a, b in zip(("g_x", "g_y", "ess", "l"), got, want):
            err = check_close(f"flash_guidance {nm} B={inputs[0].shape[0]} "
                              f"t={t}", a, b, **TOL_GUIDANCE)
            if inputs is main_in:
                fg_err = max(fg_err, err)
    # the same comparison on N(0,1) images at the main shape, reported only
    # (float32 rounding of ~2000-sized scores, see quarter_ints)
    normal_in = guidance_inputs(B_MAIN, N_MC, 32, rnd)
    normal_err = max(max_abs(a, b) for a, b in zip(
        flash_guidance(*normal_in, 0.5),
        flash_guidance_reference(*normal_in, 0.5)))
    print(f"flash_guidance == plain: main shape (quarter-integer images) t in "
          f"(0.05, 0.5, 0.95) and B=5,N=300 ragged (N(0,1)); max |err| "
          f"{fg_err:.3g}; N(0,1) images at the main shape, t=0.5: max |err| "
          f"{normal_err:.3g} (not held to atol)")
    details["flash_guidance_normal_inputs_max_abs_err"] = normal_err

    models = build_models(torch.bfloat16, dev)
    shapes = gn_shapes(models, dev)
    gn_err = {"bf16": 0.0, "f32": 0.0}
    odd = (5, 96, 16)
    for (B, C, H) in sorted(shapes) + [odd]:
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x = (rnd(B, C, H, H) * 2.0 + 0.5).to(dt).contiguous(
                memory_format=torch.channels_last)
            w, b = torch.rand(C, generator=gen, device=dev) + 0.5, rnd(C) * 0.1
            got = group_norm_silu(x, w, b, 8)
            torch.cuda.synchronize()
            err = check_close(f"group_norm_silu {tag} B={B} C={C} H={H}", got,
                              group_norm_silu_reference(x, w, b, 8),
                              TOL_GN[tag], TOL_GN[tag])
            gn_err[tag] = max(gn_err[tag], err)
    print(f"group_norm_silu == plain at {len(shapes)} main-path (B,C,H) "
          f"shapes + odd B=5; max |err| bf16 {gn_err['bf16']:.3g}, "
          f"f32 {gn_err['f32']:.3g}")
    details["gn_shapes"] = {f"B{B}_C{C}_H{H}": n
                            for (B, C, H), n in sorted(shapes.items())}

    # 4. the sampler on the card against the sampler on the CPU (plain
    #    versions): the same seeded weights in float32, injected noise and
    #    MC set
    g_cpu = torch.Generator().manual_seed(3)
    inj = [torch.randn((8,) + X_SHAPE, generator=g_cpu),
           torch.randn((8,) + Y_SHAPE, generator=g_cpu),
           torch.randn((16,) + X_SHAPE, generator=g_cpu),
           torch.randn((16,) + Y_SHAPE, generator=g_cpu),
           torch.exp(torch.randn(16, generator=g_cpu))]
    outs = {}
    for d in (dev, torch.device("cpu")):
        x1, y1, diags = make_sampler(dict(num_steps=4, mc_batch_size=16))(
            build_models(torch.float32, d), torch.Generator(d).manual_seed(0),
            8, mc_set=tuple(a.to(d) for a in inj[2:]),
            init_noise=(inj[0].to(d), inj[1].to(d)))
        outs[d.type] = (x1.cpu(), y1.cpu(), diags["ess"].cpu())
    for nm, a, b in zip(("x1", "y1", "ess"), outs["cuda"], outs["cpu"]):
        try:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        except AssertionError as e:
            fail(f"sampler on the card != sampler on the CPU ({nm})\n{e}")
    print("sampler (f32, B=8, N_mc=16, 4 steps): card == CPU within 1e-3")

    # 5. the main path, counted
    from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import k_split

    sampler = make_sampler(dict(num_steps=args.steps, mc_batch_size=N_MC))
    warm = make_sampler(dict(num_steps=2, mc_batch_size=N_MC))
    warm(models, torch.Generator(dev).manual_seed(1), B_MAIN)
    torch.cuda.synchronize()
    gn_sites = [sum(isinstance(m, GroupNormSiLU) for m in net.modules())
                for net in models[:2]]
    expected = {"flash_guidance": args.steps,
                "group_norm_silu": 2 * args.steps * sum(gn_sites)}
    torch.cuda.reset_peak_memory_stats()
    flash_guidance.launches = 0
    group_norm_silu.launches = 0
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    ev0.record()
    x1, y1, diags = sampler(models, torch.Generator(dev).manual_seed(2),
                            B_MAIN)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - h0
    counts = {"flash_guidance": flash_guidance.launches,
              "group_norm_silu": group_norm_silu.launches}
    dev_s = ev0.elapsed_time(ev1) / 1e3
    if counts != expected:
        fail(f"launch counts {counts} != derived {expected} "
             f"(GN sites per forward {gn_sites})")
    if (tuple(x1.shape) != (B_MAIN,) + X_SHAPE
            or tuple(y1.shape) != (B_MAIN,) + Y_SHAPE
            or not bool(torch.isfinite(x1).all())
            or not bool(torch.isfinite(y1).all())):
        fail("main path produced non-finite or mis-shaped samples")
    ess = diags["ess"]
    if not (float(ess.min()) >= 1.0 - 1e-4
            and float(ess.max()) <= N_MC * (1 + 1e-4)):
        fail(f"ESS outside [1, {N_MC}]: [{float(ess.min())}, "
             f"{float(ess.max())}]")
    sps = B_MAIN / dev_s
    print(f"main path: B={B_MAIN} N_mc={N_MC} steps={args.steps} bf16 "
          f"mc_feng γ={GAMMA}: {dev_s:.3f} s on the card (CUDA events), "
          f"{wall_s:.3f} s wall -> {sps:.1f} samples/s; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts} (GN sites {gn_sites}); ESS [{float(ess.min()):.3f}, "
          f"{float(ess.max()):.3f}]  [{smi}]")
    details["main_path"] = dict(batch=B_MAIN, n_mc=N_MC, steps=args.steps,
                                seconds_device=dev_s, seconds_wall=wall_s,
                                samples_per_s=sps, launches=counts,
                                gn_sites=gn_sites)

    # 5b. where the time goes: device time by kernel over a short profiled
    #     run of the same sampler (outside the counted run)
    from torch.profiler import ProfilerActivity, profile

    prof_steps = 5
    prof_sampler = make_sampler(dict(num_steps=prof_steps, mc_batch_size=N_MC))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        prof_sampler(models, torch.Generator(dev).manual_seed(4), B_MAIN)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - h0
    by_kernel = sorted(
        ((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
         for e in prof.key_averages()
         if getattr(e, "device_type", None) is not None
         and str(e.device_type).endswith("CUDA")),
        key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    details["profile"] = dict(
        steps=prof_steps, wall_ms=prof_wall * 1e3, device_busy_ms=busy_ms,
        top=[dict(kernel=k[:120], ms=ms, calls=n)
             for k, ms, n in by_kernel[:25]])
    print(f"profile ({prof_steps} steps, profiler on): wall "
          f"{prof_wall * 1e3:.1f} ms, kernels {busy_ms:.1f} ms "
          f"({100 * busy_ms / max(prof_wall * 1e3, 1e-9):.0f}% busy)")
    for k, ms_k, n in by_kernel[:8]:
        print(f"  {ms_k:9.2f} ms {n:6d}x  {k[:90]}")

    # 6. kernel times beside their bounds
    kernels = []
    t_mid = 0.5
    ms = time_ms(lambda: flash_guidance(*main_in, t_mid))
    plain_ms = time_ms(lambda: flash_guidance_reference(*main_in, t_mid))
    D = X_SHAPE[0] * X_SHAPE[1] * (X_SHAPE[2] + Y_SHAPE[2])
    fl = 2.0 * 2 * B_MAIN * N_MC * D                 # two GEMMs, 2 flop/FMA
    by = 4.0 * (2 * B_MAIN * D + N_MC * D + N_MC + 2 * B_MAIN)
    bound = max(fl / peak_f32, by / peak_bw) * 1e3
    kernels.append(dict(
        name="flash_guidance", route="cuda",
        source="ratio_guided_multimodal_fm_tpu_torch/csrc/flash_guidance.cu",
        replaces="ratio_guided_multimodal_fm_tpu/ops/guidance_pallas.py:172",
        launches=counts["flash_guidance"], max_abs_err=fg_err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if fl / peak_f32 > by / peak_bw else "bytes",
        library_ms=None))
    details["flash_guidance_k_split"] = k_split(B_MAIN, N_MC, D)

    import torch.nn.functional as F

    per_shape = {}
    gn_call_ms = 0.0
    for (B, C, H), n in sorted(shapes.items()):
        x = rnd(B, C, H, H).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = torch.rand(C, generator=gen, device=dev) + 0.5, rnd(C) * 0.1
        k_ms = time_ms(lambda: group_norm_silu(x, w, b, 8))
        per_shape[f"B{B}_C{C}_H{H}"] = dict(
            ms=k_ms, bound_ms=2 * x.numel() * 2 / peak_bw * 1e3,
            calls_per_step=n)
        gn_call_ms += n * k_ms * args.steps
    # representative shape: the SVHN level-0 map at B=512, 64 channels
    x = rnd(B_MAIN, 64, 32, 32).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.rand(64, generator=gen, device=dev) + 0.5, rnd(64) * 0.1
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    by = 2.0 * x.numel() * x.element_size() + 2 * 64 * 4
    kernels.append(dict(
        name="group_norm_silu", route="triton",
        source="ratio_guided_multimodal_fm_tpu_torch/ops/groupnorm.py",
        replaces="ratio_guided_multimodal_fm_tpu/ops/groupnorm_pallas.py:68",
        launches=counts["group_norm_silu"], max_abs_err=gn_err["bf16"],
        ms=time_ms(lambda: group_norm_silu(x, w, b, 8)),
        plain_ms=time_ms(lambda: group_norm_silu_reference(x, w, b, 8)),
        bound_ms=by / peak_bw * 1e3, bound_by="bytes",
        library_ms=time_ms(
            lambda: F.silu(F.group_norm(x, 8, wb, bb, 1e-6)))))
    details["gn_per_shape_bf16"] = per_shape
    details["gn_kernel_ms_per_sampler_call"] = gn_call_ms
    details["kernel_shapes"] = {
        "flash_guidance": f"B={B_MAIN} N={N_MC} D={D} f32 t={t_mid}",
        "group_norm_silu": f"B={B_MAIN} C=64 H=W=32 bf16 channels_last"}
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms/launch (plain "
              f"{k['plain_ms']:.4f}, library {k['library_ms']}), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}, "
              f"{k['launches']} launches  [{smi}]")
    print(f"  group_norm_silu summed over one sampler call's shapes: "
          f"{gn_call_ms:.1f} ms  [{smi}]")

    # 7. the CLI on random-init reference-layout .pth files
    from ratio_guided_multimodal_fm_tpu_torch.cli import sample_mnist_svhn

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "checkpoints"))
        for net, fname in zip(models, ("flow_mnist32_best.pth",
                                       "flow_svhn_best.pth",
                                       "ratio_disc_mnist_svhn_best.pth")):
            torch.save({k: v.detach().cpu().contiguous()
                        for k, v in net.state_dict().items()},
                       os.path.join(tmp, "checkpoints", fname))
        os.chdir(tmp)
        try:
            h0 = time.perf_counter()
            sx, sy, cd = sample_mnist_svhn.main([
                "--guidance_method", "mc_feng", "--num_samples", "64",
                "--num_steps", "20", "--dtype", "bf16"])
            cli_s = time.perf_counter() - h0
            trace = os.path.join("outputs", "mnist_svhn",
                                 f"diagnostics_mc_feng_gamma{GAMMA}.json")
            with open(trace) as f:
                rows = json.load(f)
        finally:
            os.chdir(cwd)
    if (len(rows) != 20 or not bool(torch.isfinite(sx).all())
            or not bool(torch.isfinite(sy).all())):
        fail("CLI run produced a bad trace or non-finite samples")
    print(f"CLI sample_mnist_svhn (mc_feng, 64 pairs, 20 steps, bf16): "
          f"{cli_s:.1f} s wall, {len(rows)} diagnostic rows")

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
