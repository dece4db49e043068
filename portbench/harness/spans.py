"""The program's own spans, for the set-up and idle-owner metrics.

The port records spans on `time.time_ns()`, the clock of torch.profiler's
events, in `core/observability.py` (`spans(window)`, `span_totals()`),
without entering the profiler. A program without that recorder (an older
checkout) gives None here, so every metric that reads it is left out of
the line.
"""
from __future__ import annotations

import importlib

from portbench.harness import trace as tr

RECORDER = "ratio_guided_multimodal_fm_tpu_torch.core.observability"


def recorder():
    """The program's span recorder module, or None where it has none."""
    try:
        mod = importlib.import_module(RECORDER)
    except ImportError:
        return None
    return mod if hasattr(mod, "span_totals") else None


def setup_seconds(ctx, names, part: str):
    """Seconds of the spans `names` summed over the run (`part`: "total_ns"
    for their whole durations, "self_ns" for their self time), 0 where the
    run recorded spans but none of these; None outside a traced run's
    context (no `work`), or where the program has no recorder or recorded
    no span."""
    obs = recorder()
    if obs is None or not ctx.work:
        return None
    totals = obs.span_totals()
    if not totals:
        return None
    return sum(totals[n][part] for n in names if n in totals) / 1e9


def idle_in_program(ctx):
    """Percent of the traced stretch idle while the host was inside a
    program span: the trace's idle gaps whose midpoint a span recorded in
    the stretch holds. None without a training trace, a recorder or a span
    in the stretch."""
    if ctx.trace is None or ctx.work.get("kind") != "train":
        return None
    obs = recorder()
    if obs is None:
        return None
    own = [(s.name, s.start_ns, s.end_ns)
           for s in obs.spans(ctx.trace.window)]
    if not own:
        return None
    gaps = tr.gaps(ctx.trace)
    names = tr.name_points(own, [(s + e) // 2 for s, e in gaps])
    idle = sum(e - s for (s, e), n in zip(gaps, names) if n != tr.NO_OP)
    return 100.0 * idle / ctx.trace.window_ns
