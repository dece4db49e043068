"""One run of one cell, driven by the files that BENCHMARK.json names.

* the cell: its `workloads` entry (configuration, traffic, chips);
* the configuration: the file its `configs` entry names;
* the traffic: `portbench/traffic/<traffic>.json`, whose `driver` key
  names the general generator in `portbench/drivers/`;
* the limits of `correct`: `portbench/limits/<cell>.json` (`limits`: a
  limit for each number the driver compares; `leaf_stat`, where given,
  which leaf a training cell's leaf numbers read: "worst" or "median");
* every metric: `portbench/metrics/<metric>.py`, whose `read(ctx)` returns
  its value or None where it finds nothing to read (then the metric is
  left out of the line).

A run: set-up (the driver builds the program's kernels, nets and state
from the seed and warms up the cell's shapes), the window
(`window.measure`), device memory's peak; with --trace 1 two profiled
stretches after the window: the metrics, `busy_s`, `window_s` and the
top device operations come from a session of the card and the CUDA
runtime alone, the names of the idle gaps from a second one that also
records every host operation (and so runs slower). Then the program's
state is freed and the driver compares what the window's path produced
with the reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch

from portbench.harness import trace as tr
from portbench.harness.compare import verdict
from portbench.harness.peaks import peaks_for
from portbench.harness.window import Window, measure

FORBIDDEN = ("jax", "jaxlib", "flax", "ratio_guided_multimodal_fm_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) in e2e_names or "moves" not in metric


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, names)]
    return Cell(
        name, int(w["chips"]), json.loads((root / conf["file"]).read_text()),
        json.loads((root / "portbench" / "traffic"
                    / f"{w['traffic']}.json").read_text()),
        json.loads((root / "portbench" / "limits"
                    / f"{name}.json").read_text()),
        e2e, per_layer)


def reader(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a metric's reader may read."""
    unit: str
    setup_s: float
    window: Window
    work: dict = field(default_factory=dict)
    trace: Optional[tr.Trace] = None
    peaks: Optional[dict] = None


def card_line() -> str:
    """`name, power.limit` of the card, as nvidia-smi gives them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, sizes: dict = None,
        control: bool = False) -> dict:
    """The result line of one run (and, with `control`, the control's
    readings under "control")."""
    cell = load_cell(root, name)
    drv_cls = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    drv = drv_cls(cell.config, cell.traffic, seed, device, sizes)
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t0
    win = measure(drv.call, seconds, drv.sync_each, sync)
    mem = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    ctx = Context(drv.unit, setup_s, win, peaks=peaks_for(kind))
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": mem}
    out = {"correct": False, "attempted": win.calls, "failed": 0,
           "window": {"seconds": win.seconds, "calls": win.calls,
                      "call_s": win.call_s}}
    named = None
    if trace:
        ctx.work = drv.work(win)
        if cuda:
            _, ctx.trace = tr.profile_stretch(drv.traced, host_ops=False)
            _, named = tr.profile_stretch(drv.traced, host_ops=True)
        if ctx.trace is not None:
            dev["busy_s"] = tr.busy_ns(ctx.trace) / 1e9
            dev["window_s"] = ctx.trace.window_ns / 1e9
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out.update(metrics=metrics, device=dev)
    if ctx.trace is not None:
        out["breakdown"] = tr.breakdown(ctx.trace, named)
    out["card"] = card_line() if cuda else "cpu"
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = drv.check(cell.limits)
    if control:
        out["detail"] = {r["name"]: r["detail"] for r in readings
                         if "detail" in r}
        out["control"] = {}
        for subject in drv.subjects:
            got = drv.check(cell.limits, subject)
            out["control"][subject] = {r["name"]: r["value"] for r in got}
            out["detail"][subject] = {r["name"]: r["detail"] for r in got
                                      if "detail" in r}
    out["correct"] = verdict(readings)
    out["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                     for r in readings}
    return out
