"""Tracing, throughput and metrics (port of core/observability.py).

* `profile_trace` — context manager around `torch.profiler`: CPU and CUDA
  activity of the enclosed code, written as a Chrome trace into a
  directory (chrome://tracing or Perfetto read it).
* `StepTimer` — wall-clock steps/s, samples/s and samples/s per device.
* `MetricsLogger` — JSONL records {"step", "time", metrics...}, the JAX
  keys; TensorBoard scalars too where asked and installed.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Trace the enclosed computation with torch.profiler when `logdir` is
    set: CUDA activity too where a card is present; each trace is a new
    file <logdir>/trace_<pid>_<ns>.json."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Throughput counters; call tick() once per step (after the step's
    work has synchronised, for a device rate)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size
        self.n_steps = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        self.n_steps = 0

    def tick(self):
        if self._t0 is None:
            self.start()
        self.n_steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0 if self._t0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        return self.n_steps / max(self.elapsed, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size

    def summary(self) -> Dict[str, float]:
        """Rates, with samples/s per card over the visible CUDA devices (1
        without any)."""
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return {
            "steps_per_sec": self.steps_per_sec,
            "samples_per_sec": self.samples_per_sec,
            "samples_per_sec_per_chip": self.samples_per_sec / max(n_dev, 1),
        }


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
