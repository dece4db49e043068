"""The card's published peak rates, its name and power limit, and the
timers (CUDA events, device time by torch.profiler with the L2 warm or
cold, host time per call): the one source that the kernel benches
(cli/resblock_kernel_bench.py, cli/guidance_kernel_bench.py) and
chip_smoke.py compute bounds and times from."""
from __future__ import annotations

import contextlib
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


# Late in a long process torch.profiler loses the first ~10-70 device
# events of a session, so a session opens with this many tiny kernels and a
# marker kernel (torch.cuda._sleep's), and only what starts after the marker
# counts.
PROFILE_WARM_KERNELS = 1000
MARKER_KERNEL = "spin_kernel"


class ProfilerSilent(RuntimeError):
    """torch.profiler kept fewer of the kernels asked for than were
    launched, in every session tried."""


@contextlib.contextmanager
def marked_profile(cpu: bool = False):
    """A torch.profiler session of the card (and the host with `cpu`) that
    opens with PROFILE_WARM_KERNELS tiny kernels and the marker kernel; read
    it with `after_marker(device_events(prof))`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        z = torch.zeros(1, device="cuda")
        for _ in range(PROFILE_WARM_KERNELS):
            z.add_(1)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof


def device_events(prof):
    """(name, start µs, end µs) of each device event of a finished session;
    a user annotation's range on the device (e.g. Optimizer.step#Adam.step)
    overlaps the kernels it encloses and is left out."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def after_marker(events):
    """The events that start after the last marker kernel ends, or None
    where the session lost its marker."""
    ends = [end for name, _, end in events if MARKER_KERNEL in name]
    if not ends:
        return None
    start = max(ends)
    return [e for e in events if e[1] >= start]


def session_time(events, names, n: int, launches: int):
    """(device ms per call, {kernel name: ms per call}) of one session's
    `events` (`device_events`) in which fn() ran n times and launched
    `launches` kernels named like one of `names` each time, or None where
    the session kept fewer than n × launches of them after its marker. The
    first number is the time during which at least one of those kernels ran
    (the union of their spans), divided by n. Raises ValueError where it
    kept more: then `launches` is wrong."""
    kept = after_marker(events) or []
    spans = sorted((s, e, k) for k, s, e in kept
                   if any(name in k for name in names))
    want = n * launches
    if len(spans) > want:
        raise ValueError(f"{len(spans)} kernels named like {names} in a "
                         f"session of {n} calls, more than {launches} a call")
    if len(spans) < want:
        return None
    by = {}
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for s, e, k in spans:
        by[k] = by.get(k, 0.0) + (e - s) / 1e3 / n
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / 1e3 / n, by


def timed_sessions(sessions, names, n: int, launches: int, want: int = 3):
    """The median of the first `want` of `sessions` (an iterable of event
    lists, profiled as it is walked) that kept every launch, as
    `session_time`'s pair of the session it picks (the upper median where
    fewer kept every launch). Late in a long process a session may also
    read a kernel at half its time (seen in full chip_smoke.py runs), so
    no one session decides. Raises ProfilerSilent, naming what each
    session kept, where none kept every launch."""
    kept, full = [], []
    for events in sessions:
        got = session_time(events, names, n, launches)
        if got is not None:
            full.append(got)
            if len(full) == want:
                break
            continue
        after = after_marker(events)
        kept.append(None if after is None else sum(
            any(name in k for name in names) for k, _, _ in after))
    if full:
        return sorted(full, key=lambda g: g[0])[len(full) // 2]
    raise ProfilerSilent(
        f"the profiler kept {kept} of the {n * launches} kernels named like "
        f"{tuple(names)} ({n} calls x {launches}) in {len(kept)} sessions "
        f"(None: the marker was lost)")


def device_ms(fn, names, launches: int, n: int = 20, between=None,
              sessions: int = 5):
    """(device ms per call, {kernel name: ms per call}) of the `launches`
    kernels a call of fn() launches whose names contain one of `names`, by
    torch.profiler over n calls; `between()` runs before each call and is
    not counted. Each session opens with warm-up kernels and a marker
    (`marked_profile`) and must keep all n × launches kernels after it
    (`session_time`); sessions run until three kept them all, up to
    `sessions` in all, and the median of those counts (`timed_sessions`);
    where none did, ProfilerSilent is raised."""
    if isinstance(names, str):
        names = (names,)
    fn()
    torch.cuda.synchronize()

    def profiled():
        for _ in range(sessions):
            with marked_profile() as prof:
                for _ in range(n):
                    if between is not None:
                        between()
                    fn()
                torch.cuda.synchronize()
            yield device_events(prof)

    return timed_sessions(profiled(), names, n, launches)


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


def call_times(fn, device, names, launches: int,
               strict: bool = True) -> dict:
    """Four times of one call fn() that launches `launches` kernels named
    like `names`:
    `event_ms` (CUDA events around 20 back-to-back calls), `device_ms`
    (profiler, L2 warm), `device_cold_ms` (the L2 flushed before each call),
    `host_ms`, and `kernels`, the device time by kernel name. Where no
    profiler session keeps every launch it raises ProfilerSilent, or with
    strict=False says so and leaves that time None."""
    def profiled(between=None):
        try:
            return device_ms(fn, names, launches, between=between)
        except ProfilerSilent as e:
            if strict:
                raise
            print(f"not measured: {e}", flush=True)
            return None, {}

    warm, by = profiled()
    cold, _ = profiled(l2_flusher(device))
    return dict(event_ms=time_ms(fn, device), device_ms=warm,
                device_cold_ms=cold, host_ms=host_ms(fn), kernels=by)
