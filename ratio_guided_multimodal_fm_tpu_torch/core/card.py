"""The card's published peak rates, its name and power limit, and the
timers (CUDA events, device time by torch.profiler with the L2 warm or
cold, host time per call): the one source that the kernel benches
(cli/resblock_kernel_bench.py, cli/guidance_kernel_bench.py) and
chip_smoke.py compute bounds and times from."""
from __future__ import annotations

import subprocess
import time

import torch

# Published dense peaks at the full power limit (NVIDIA data sheets):
# (float32 non-tensor FLOP/s, memory bytes/s, bf16 tensor-core FLOP/s) by
# the name the card reports, most specific names first.
PEAKS = {"H100 PCIe": (51e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 3.9e12, 835e12),
         "H100": (67e12, 3.35e12, 989e12), "H200": (67e12, 4.8e12, 989e12)}


def peaks_for(name: str):
    """(key, (f32 FLOP/s, bytes/s, bf16 FLOP/s)) for a card name; an
    unknown name gets the H100 SXM's."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def card_info() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def time_ms(fn, device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Mean time of fn() in ms over `iters` back-to-back calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


class ProfilerSilent(RuntimeError):
    """torch.profiler recorded none of the kernels asked for."""


def device_ms(fn, names, n: int = 20, between=None, sessions: int = 3):
    """(device ms per call, {kernel name: ms per call}) of the kernels whose
    name contains one of `names`, by torch.profiler over n calls of fn();
    `between()` runs before each call and is not counted. The first number
    is the time during which at least one of those kernels ran, from the
    profiler's timeline. A session in which the profiler recorded no such
    kernel (its device tracing sometimes delivers nothing) is run again, up
    to `sessions` in all; then it raises ProfilerSilent."""
    from torch.profiler import ProfilerActivity, profile

    if isinstance(names, str):
        names = (names,)
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if str(e.device_type).endswith("CUDA")
                       and any(k in e.name for k in names))
        if spans:
            break
    else:
        raise ProfilerSilent(f"device_ms: the profiler recorded no kernel "
                             f"named like {names} in {sessions} sessions")
    by = {e.key: e.device_time_total / 1e3 / n for e in prof.key_averages()
          if any(k in e.key for k in names)}
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    return (busy + hi - lo) / 1e3 / n, by


def host_ms(fn, n: int = 200) -> float:
    """Host time per call of fn(): n enqueues on the host clock with no
    synchronise in between (the card drains afterwards)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def l2_flusher(device):
    """A call that writes 64 MiB, more than the card's 50 MB L2."""
    buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    return buf.zero_


def call_times(fn, device, names, strict: bool = True) -> dict:
    """Four times of one call fn() whose kernels are named like `names`:
    `event_ms` (CUDA events around 20 back-to-back calls), `device_ms`
    (profiler, L2 warm), `device_cold_ms` (the L2 flushed before each call),
    `host_ms`, and `kernels`, the device time by kernel name. Where the
    profiler stays silent it raises ProfilerSilent, or with strict=False
    says so and leaves that time None."""
    def profiled(between=None):
        try:
            return device_ms(fn, names, between=between)
        except ProfilerSilent as e:
            if strict:
                raise
            print(f"not measured: {e}", flush=True)
            return None, {}

    warm, by = profiled()
    cold, _ = profiled(l2_flusher(device))
    return dict(event_ms=time_ms(fn, device), device_ms=warm,
                device_cold_ms=cold, host_ms=host_ms(fn), kernels=by)
