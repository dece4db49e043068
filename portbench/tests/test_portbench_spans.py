"""The readers of the program's spans (harness/spans.py) on synthetic
traces and spans: an idle gap under a program span counts toward
idle_in_program.*, one outside every span does not; the set-up metrics'
arithmetic (durations of the kernel spans, self time of the warm-up and
the capture); and every reader's silence where the program has no span
recorder (an older checkout), where it recorded no span, and outside a
traced run."""
import types

import pytest

from conftest import ROOT
from portbench.harness import runner
from portbench.harness import spans as ps
from portbench.harness import trace as tr
from portbench.harness.window import Window

FLOW, RATIO = "idle_in_program.train", "idle_in_program.ratio_train"
SETUP = ("setup.kernels_s", "setup.warmup_s", "setup.capture_s")
READERS = (FLOW, RATIO) + SETUP
TRAIN = {"kind": "train", "units_per_s": 1.0, "flops_per_unit": 1.0}


def _ctx(trace=None, work=TRAIN):
    return runner.Context("samples", 20.0, Window(1, 1, 1.0),
                          work=dict(work), trace=trace)


def _read(name, ctx):
    return runner.reader(ROOT, name)(ctx)


def _span(name, s, e, parent=None, call_id=1):
    return types.SimpleNamespace(name=name, start_ns=s, end_ns=e,
                                 parent=parent, call_id=call_id)


def _fake(monkeypatch, records=(), totals=None):
    """The program's recorder, holding `records` and `totals`."""
    records = list(records)

    def spans(window=None):
        lo, hi = window if window else (float("-inf"), float("inf"))
        return [r for r in records if r.end_ns > lo and r.start_ns < hi]
    mod = types.SimpleNamespace(spans=spans,
                                span_totals=lambda: dict(totals or {}))
    monkeypatch.setattr(ps, "recorder", lambda: mod)


def _totals(**ns):
    return {name.replace("_", "."): {"count": 1, "total_ns": t, "self_ns": s}
            for name, (t, s) in ns.items()}


# the stretch (0, 1000): kernels leave gaps (100, 200), (400, 450) and
# (900, 1000)
TRACE = tr.Trace((0, 1000), [("k", 0, 100), ("k", 200, 400),
                             ("k", 450, 900)])


@pytest.mark.parametrize("name", [FLOW, RATIO])
@pytest.mark.parametrize("records,want", [
    # a call span over the first two gaps; the last gap is the harness's
    ([_span("train.fm.call", 50, 500)], 15.0),
    # the replay inside the call holds the second gap's midpoint too
    ([_span("train.fm.call", 50, 500),
      _span("train.graph.replay", 420, 440, "train.fm.call")], 15.0),
    # a span that ends before the gap's midpoint does not own it
    ([_span("train.fm.call", 120, 140)], 0.0),
    # two calls, one each side of a harness gap
    ([_span("train.ratio.call", 90, 210, call_id=1),
      _span("train.ratio.call", 890, 990, call_id=2)], 20.0),
], ids=["call", "replay", "edge", "two_calls"])
def test_idle_in_program_counts_gaps_under_a_span(monkeypatch, name,
                                                  records, want):
    _fake(monkeypatch, records, _totals(train_fm_call=(1, 1)))
    got = _read(name, _ctx(TRACE))
    assert got == pytest.approx(want)
    assert 0.0 <= got <= tr.idle_share(TRACE)


def test_idle_in_program_ignores_spans_outside_the_stretch(monkeypatch):
    _fake(monkeypatch, [_span("train.fm.call", 2000, 3000)])
    assert _read(FLOW, _ctx(TRACE)) is None
    _fake(monkeypatch, [_span("train.fm.call", -500, 10),
                        _span("train.fm.call", 2000, 3000)])
    assert _read(FLOW, _ctx(TRACE)) == 0.0


def test_setup_arithmetic(monkeypatch):
    totals = {
        "ops.build": {"count": 1, "total_ns": 19_000_000_000,
                      "self_ns": 19_000_000_000},
        "ops.load": {"count": 3, "total_ns": 30_000_000,
                     "self_ns": 30_000_000},
        # the loads ran inside the warm-up: its self time leaves them out
        "train.graph.warmup": {"count": 1, "total_ns": 2_530_000_000,
                               "self_ns": 2_500_000_000},
        "train.graph.capture": {"count": 1, "total_ns": 800_000_000,
                                "self_ns": 800_000_000},
        "train.fm.call": {"count": 400, "total_ns": 5 * 10**10,
                          "self_ns": 10**9},
    }
    _fake(monkeypatch, totals=totals)
    ctx = _ctx()
    got = {n: _read(n, ctx) for n in SETUP}
    assert got == {"setup.kernels_s": pytest.approx(19.03),
                   "setup.warmup_s": pytest.approx(2.5),
                   "setup.capture_s": pytest.approx(0.8)}
    # disjoint parts of set-up: never more than the whole
    assert sum(got.values()) <= 22.33 + 1e-9


def test_setup_reads_zero_for_a_phase_that_did_not_run(monkeypatch):
    """A run whose kernels were built and that loads none (the ratio
    net's cell) records no kernel span: 0 s, not silence."""
    _fake(monkeypatch, totals={
        "train.graph.warmup": {"count": 1, "total_ns": 5, "self_ns": 5},
        "train.graph.capture": {"count": 1, "total_ns": 2, "self_ns": 2}})
    assert _read("setup.kernels_s", _ctx()) == 0.0
    assert _read("setup.warmup_s", _ctx()) == pytest.approx(5e-9)


@pytest.mark.parametrize("name", READERS)
def test_silent_without_a_recorder(monkeypatch, name):
    """A program from before the span recorder has none: the metric is
    left out of the line, nothing raises."""
    monkeypatch.setattr(ps, "recorder", lambda: None)
    assert _read(name, _ctx(TRACE)) is None


def test_recorder_is_found_only_where_the_program_has_one(monkeypatch):
    assert hasattr(ps.recorder(), "spans")
    # a module without the recorder's functions, and no module at all
    for name in ("json", "ratio_guided_multimodal_fm_tpu_torch.no_such"):
        monkeypatch.setattr(ps, "RECORDER", name)
        assert ps.recorder() is None


@pytest.mark.parametrize("name", READERS)
def test_silent_where_nothing_was_recorded_or_traced(monkeypatch, name):
    _fake(monkeypatch)                       # a recorder, no span
    assert _read(name, _ctx(TRACE)) is None
    _fake(monkeypatch, [_span("train.fm.call", 0, 1000)],
          _totals(train_fm_call=(1000, 1000)))
    # outside a traced run: no work, no trace
    assert _read(name, _ctx(None, work={})) is None
