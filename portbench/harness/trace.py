"""A torch.profiler session over a steady stretch, and its arithmetic.

`profile_stretch(fn, host_ops)` runs fn() once inside a profiler session
of the card. The session opens with WARM_KERNELS tiny kernels, because
late in a long process the profiler loses the first device events of a
session; then a marker kernel, fn(), a synchronise and a second marker.
The stretch is the time between the two markers: every device operation
of fn() lies inside it, and so does the host's time before fn()'s first
kernel and after its last.

The arithmetic works on plain (name, start, end) tuples in nanoseconds of
one clock, so the CPU tests can feed it synthetic traces:
* busy time is the union of the device intervals, never their sum (two
  overlapping kernels count their overlap once), so the idle share stays
  within [0, 100] %;
* idle gaps are the stretches of the window that no device interval
  covers, each named by the innermost host event (an operation, or a
  CUDA runtime call) running at its midpoint on the thread that recorded
  the most host events.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

Span = Tuple[str, int, int]

WARM_KERNELS = 1000
MARKER = "spin_kernel"
NO_OP = "host outside any recorded call"


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]


def clip(spans: List[Span], window: Tuple[int, int]) -> List[Span]:
    lo, hi = window
    return [(n, max(s, lo), min(e, hi)) for n, s, e in spans
            if e > lo and s < hi]


def merged(spans: List[Span]) -> List[Tuple[int, int]]:
    """The union of the spans' intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: Trace) -> int:
    return sum(e - s for s, e in merged(clip(trace.device, trace.window)))


def idle_share(trace: Trace) -> float:
    """Percent of the window in which no device operation ran."""
    return 100.0 * (1.0 - busy_ns(trace) / trace.window_ns)


def gaps(trace: Trace) -> List[Tuple[int, int]]:
    lo, hi = trace.window
    out, cur = [], lo
    for s, e in merged(clip(trace.device, trace.window)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def name_points(host: List[Span], points: List[int]) -> List[str]:
    """The innermost host span holding each point (points sorted), or
    NO_OP. Host spans of one thread nest, so a stack sweep finds it."""
    spans = sorted(host, key=lambda x: (x[1], -x[2]))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][1] <= p:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        names.append(stack[-1][0] if stack else NO_OP)
    return names


def gap_names(trace: Trace) -> Dict[str, float]:
    """Idle seconds by the host operation that ran during each gap."""
    gs = gaps(trace)
    names = name_points(trace.host, [(s + e) // 2 for s, e in gs])
    out: Dict[str, float] = {}
    for (s, e), n in zip(gs, names):
        out[n] = out.get(n, 0.0) + (e - s) / 1e9
    return out


def device_time(trace: Trace, match: Optional[Callable[[str], bool]] = None
                ) -> Tuple[float, int]:
    """(summed device seconds, count) of the device operations whose name
    `match` accepts (all of them without `match`)."""
    t, n = 0.0, 0
    for name, s, e in clip(trace.device, trace.window):
        if match is None or match(name):
            t += (e - s) / 1e9
            n += 1
    return t, n


def by_name(trace: Trace) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in clip(trace.device, trace.window):
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace, named: Optional[Trace] = None) -> dict:
    """The ten device operations that took most time in `trace`, and the
    ten host operations that the longest idle time fell in, from `named`
    (a session that recorded the host's operations) where given."""
    return {"device_ops": top(by_name(trace)),
            "idle_gaps": top(gap_names(named or trace))}


# ----------------------------------------------------------- the session

def _raw_events(prof):
    """(name, is_device, start ns, end ns, thread) of every event of a
    finished session, user annotations left out."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None and hasattr(res, "events"):
        for e in res.events():
            if not e.is_user_annotation():
                yield (e.name(), str(e.device_type()).endswith("CUDA"),
                       e.start_ns(), e.end_ns(), e.start_thread_id())
        return
    for e in prof.events():
        if not getattr(e, "is_user_annotation", False):
            yield (e.name, str(e.device_type).endswith("CUDA"),
                   int(e.time_range.start * 1000),
                   int(e.time_range.end * 1000), getattr(e, "thread", 0))


def parse(prof) -> Optional[Trace]:
    """The stretch's Trace: the device operations between the end of the
    first marker kernel after the warm-up and the start of the last, and
    the host events of the thread that recorded the most, or None where
    the session lost a marker."""
    device, host, marks = [], {}, []
    for name, is_dev, s, e, tid in _raw_events(prof):
        if is_dev:
            if name.startswith("Optimizer."):
                continue
            if MARKER in name:
                marks.append((s, e))
            else:
                device.append((name, s, e))
        else:
            host.setdefault(tid, []).append((name, s, e))
    if len(marks) < 2:
        return None
    marks.sort()
    window = (marks[0][1], marks[-1][0])
    device = [d for d in device if d[1] >= window[0] and d[2] <= window[1]]
    main = max(host.values(), key=len) if host else []
    return Trace(window, device, clip(main, window))


def profile_stretch(fn: Callable[[], object], host_ops: bool):
    """(fn()'s result, Trace or None) of fn() run once under the profiler:
    the card's activity and the CUDA runtime calls, and with `host_ops`
    every host operation too (which slows the host, so the metrics come
    from a session without them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if host_ops else [])
    with profile(activities=acts) as prof:
        z = torch.zeros(1, device="cuda")
        for _ in range(WARM_KERNELS):
            z.add_(1)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        out = fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return out, parse(prof)
