"""Spans, tracing and metrics (port of core/observability.py).

* `span(name)` — the program's own spans: a context manager that records
  (name, start_ns, end_ns, parent, call_id) on `time.time_ns()`, the clock
  of torch.profiler's events, so the spans line up with a profiler trace
  without entering it (no `record_function`, no NVTX range: the profiler
  would turn such a range into a device-side annotation as long as the
  call). `parent` is the enclosing span's name on this thread, `call_id`
  the id of the outermost enclosing span, shared by every span of one
  trainer call. Always on: two clock reads and an append to a bounded ring
  (`RING` spans), plus per-name totals of duration and self time
  (duration minus the part its child spans cover), which outlive the ring.
  Read with `spans(window)`, `span_totals()`; `reset()` clears both.
  Placed at: `ops.build`, `ops.load` (ops/_build.py), `train.graph.warmup`,
  `train.graph.capture`, `train.graph.replay` (train/graphs.py),
  `train.fm.call`, `train.ratio.call` (train/steps.py).
* `profile_trace` — context manager around `torch.profiler`: CPU and CUDA
  activity of the enclosed code, written as a Chrome trace into a
  directory (chrome://tracing or Perfetto read it), with the session's
  spans beside it in a Chrome trace of their own on the same clock.
* `MetricsLogger` — JSONL records {"step", "time", metrics...}, the JAX
  keys; TensorBoard scalars too where asked and installed.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

RING = 4096


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call_id: int


class _Stack(threading.local):
    def __init__(self):
        self.open: list = []


class SpanRecorder:
    """A ring of the newest `capacity` spans and every name's totals:
    {"count", "total_ns", "self_ns"}."""

    def __init__(self, capacity: int = RING):
        self._ring = collections.deque(maxlen=capacity)   # plain tuples
        self._totals: Dict[str, List[int]] = {}
        self._lock = threading.Lock()
        self._local = _Stack()
        self._calls = itertools.count(1)

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def _add(self, rec: tuple, dur: int, self_ns: int) -> None:
        with self._lock:
            self._ring.append(rec)
            t = self._totals.get(rec[0])
            if t is None:
                t = self._totals[rec[0]] = [0, 0, 0]
            t[0] += 1
            t[1] += dur
            t[2] += self_ns

    def spans(self, window: Optional[Tuple[int, int]] = None
              ) -> List[SpanRecord]:
        """The spans still in the ring, oldest first; with a (lo, hi)
        window in ns, those that overlap it."""
        with self._lock:
            out = list(self._ring)
        if window is not None:
            lo, hi = window
            out = [s for s in out if s[2] > lo and s[1] < hi]
        return [SpanRecord._make(s) for s in out]

    def span_totals(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {n: {"count": c, "total_ns": t, "self_ns": s}
                    for n, (c, t, s) in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()


class _Span:
    __slots__ = ("rec", "name", "parent", "call_id", "child_ns", "start_ns")

    def __init__(self, rec: SpanRecorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Span":
        stack = self.rec._local.open
        if stack:
            top = stack[-1]
            self.parent, self.call_id = top.name, top.call_id
        else:
            self.parent, self.call_id = None, next(self.rec._calls)
        self.child_ns = 0
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        stack = self.rec._local.open
        stack.pop()
        dur = end - self.start_ns
        if stack:
            stack[-1].child_ns += dur
        self.rec._add((self.name, self.start_ns, end, self.parent,
                       self.call_id), dur, dur - self.child_ns)


RECORDER = SpanRecorder()
span = RECORDER.span
spans = RECORDER.spans
span_totals = RECORDER.span_totals
reset = RECORDER.reset


def _write_spans(path: str, records: List[SpanRecord]) -> None:
    """`records` as a Chrome trace (complete events, µs of time.time_ns's
    epoch, the clock of torch.profiler's events), parent and call_id under
    each event's args."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}}]
    events += [{"name": s.name, "cat": "span", "ph": "X", "pid": pid,
                "tid": 0, "ts": s.start_ns / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"parent": s.parent, "call_id": s.call_id}}
               for s in records]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"clock": "time.time_ns"}}, f)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Trace the enclosed computation with torch.profiler when `logdir` is
    set: CUDA activity too where a card is present; each trace is a new
    file <logdir>/trace_<pid>_<ns>.json, and the spans recorded during it
    (those still in the ring) <logdir>/spans_<pid>_<ns>.json."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        yield
        t1 = time.time_ns()
    tag = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{tag}.json"))
    _write_spans(os.path.join(logdir, f"spans_{tag}.json"), spans((t0, t1)))


class MetricsLogger:
    """Structured metrics: <out_dir>/<name>.jsonl always (appended), and
    TensorBoard scalars under <out_dir>/tb when `tensorboard` is set and
    torch's SummaryWriter imports."""

    def __init__(self, out_dir: str, name: str = "metrics",
                 tensorboard: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
