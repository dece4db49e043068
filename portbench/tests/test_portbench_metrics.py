"""The metric arithmetic on synthetic traces and clocks: the idle share
from the union of kernel intervals, launches per step, roofline shares
from the frozen bytes, the window rate over completed calls, and every
reader's silence where it has nothing to read."""
import json
import math

import pytest

from conftest import ROOT
from portbench.harness import runner, trace as tr
from portbench.harness.window import Window, measure

PEAKS = {"card": "H100", "fp32": 67e12, "bf16": 989e12, "bytes": 3.35e12}


def _ctx(work=None, trace=None, unit="pairs", rate=(512, 1, 2.0)):
    units, calls, secs = rate
    return runner.Context(unit, 12.5, Window(units, calls, secs),
                          work=work or {}, trace=trace, peaks=PEAKS)


def _read(name, ctx):
    return runner.reader(ROOT, name)(ctx)


def test_idle_share_is_the_union_never_the_sum():
    # two kernels overlap fully: their sum is 150% of the window
    t = tr.Trace((0, 100), [("a", 0, 100), ("b", 0, 50)])
    assert tr.busy_ns(t) == 100
    assert tr.idle_share(t) == 0.0
    # overlap in part, a gap of 30 at the end
    t = tr.Trace((0, 100), [("a", 0, 40), ("b", 30, 70), ("c", 65, 70)])
    assert tr.busy_ns(t) == 70
    assert tr.idle_share(t) == pytest.approx(30.0)
    assert tr.gaps(t) == [(70, 100)]


def test_idle_share_stays_in_range_on_dense_overlaps():
    spans = [(f"k{i}", i, i + 50) for i in range(0, 1000, 7)]
    t = tr.Trace((0, 1000), spans)
    assert 0.0 <= tr.idle_share(t) <= 100.0
    assert tr.busy_ns(t) <= t.window_ns


def test_spans_outside_the_window_are_clipped():
    t = tr.Trace((10, 20), [("a", 0, 15), ("b", 18, 40), ("c", 30, 40)])
    assert tr.busy_ns(t) == 5 + 2
    assert tr.device_time(t) == (pytest.approx(7e-9), 2)


def test_gaps_are_named_by_the_innermost_host_op():
    dev = [("k", 0, 10), ("k", 40, 50), ("k", 90, 100)]
    host = [("step", 0, 100), ("aten::conv", 15, 35), ("cudnn", 20, 30),
            ("aten::add", 55, 60)]
    t = tr.Trace((0, 100), dev, host)
    names = tr.gap_names(t)
    assert names == {"cudnn": pytest.approx(30e-9),
                     "step": pytest.approx(40e-9)}
    assert tr.name_points([], [5]) == [tr.NO_OP]
    bd = tr.breakdown(t)
    assert bd["device_ops"] == [["k", pytest.approx(30e-9)]]
    assert bd["idle_gaps"][0][0] == "step"


def test_window_counts_completed_calls_and_a_stall_lowers_the_rate():
    def run(stall_at=None):
        clock = [0.0]

        def call(i):
            clock[0] += 1.0 + (3.0 if i == stall_at else 0.0)
            return 10
        return measure(call, 10.0, True, lambda: None, lambda: clock[0])

    steady = run()
    assert steady.calls == 10 and steady.seconds == 10.0
    assert steady.rate == 10.0
    stalled = run(stall_at=2)
    # the stall costs three calls' time; every started call counts
    assert stalled.calls == 7 and stalled.seconds == 10.0
    assert stalled.rate == 7.0 < steady.rate
    assert stalled.call_s[2] == 4.0


def test_window_without_sync_drains_at_the_end():
    clock, synced = [0.0], []

    def call(i):
        clock[0] += 0.25
        return 128

    def sync():
        synced.append(clock[0])
        clock[0] += 0.5 if synced[1:] else 0.0
    w = measure(call, 2.0, False, sync, lambda: clock[0])
    assert w.calls == 8 and w.units == 8 * 128
    assert w.seconds == 2.5          # the drain counts
    assert len(synced) == 2


def test_end_to_end_readers():
    ctx = _ctx(rate=(1024, 2, 4.0))
    assert _read("pairs_per_s", ctx) == 256.0
    assert _read("setup_s", ctx) == 12.5
    for name in ("train_samples_per_s", "ratio_train_samples_per_s"):
        assert _read(name, ctx) is None
        assert _read(name, _ctx(unit="samples")) == 256.0


def test_sample_readers():
    dev = [("gn_silu_kernel<bf16>", 0, 100), ("conv", 100, 400),
           ("add", 500, 600)]
    t = tr.Trace((0, 1000), dev)
    work = {"kind": "sample", "units_per_s": 100.0, "flops_per_unit": 1e9,
            "euler_steps": 2, "gn_fwd_bytes": 3.35e12 * 50e-9}
    ctx = _ctx(work, t)
    assert _read("mfu.sample", ctx) == pytest.approx(100 * 1e11 / 989e12)
    assert _read("launches_per_step.sample", ctx) == 1.5
    assert _read("idle_share.sample", ctx) == pytest.approx(50.0)
    # 50 ns of bound against 100 ns of kernel time
    assert _read("gn_silu_roofline", ctx) == pytest.approx(50.0)
    for name in ("mfu.train", "idle_share.train", "gn_silu_bwd_roofline",
                 "mfu.ratio_train", "idle_share.ratio_train"):
        assert _read(name, ctx) is None


def test_train_readers():
    dev = [("void gn_silu_bwd_kernel<float>", 0, 200),
           ("gn_wb_reduce_kernel", 200, 250), ("wgrad", 250, 900)]
    t = tr.Trace((0, 1000), dev)
    work = {"kind": "train", "units_per_s": 1000.0, "flops_per_unit": 3e9,
            "gn_bwd_bytes": 3.35e12 * 100e-9}
    ctx = _ctx(work, t, unit="samples")
    for suffix in ("train", "ratio_train"):
        assert _read(f"mfu.{suffix}", ctx) == pytest.approx(100 * 3e12
                                                            / 67e12)
        assert _read(f"idle_share.{suffix}", ctx) == pytest.approx(10.0)
    assert _read("gn_silu_bwd_roofline", ctx) == pytest.approx(40.0)
    assert _read("idle_share.sample", ctx) is None


def test_readers_are_silent_without_a_trace_or_a_kernel():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert _read(m["name"], _ctx()) is None
    t = tr.Trace((0, 100), [("conv", 0, 50)])
    work = {"kind": "sample", "units_per_s": 1.0, "flops_per_unit": 1.0,
            "euler_steps": 1, "gn_fwd_bytes": 1.0}
    assert _read("gn_silu_roofline", _ctx(work, t)) is None
    assert _read("launches_per_step.sample",
                 _ctx(work, tr.Trace((0, 100), []))) is None


def test_shares_stay_below_100_percent_when_the_time_covers_the_work():
    """A kernel that runs at exactly its bound reads 100%, never more."""
    t = tr.Trace((0, 1000), [("gn_silu_kernel", 0, 1000)])
    work = {"kind": "sample", "units_per_s": 1.0, "flops_per_unit": 1.0,
            "euler_steps": 1, "gn_fwd_bytes": 3.35e12 * 1e-6}
    assert _read("gn_silu_roofline", _ctx(work, t)) == pytest.approx(100.0)
    assert math.isfinite(_read("idle_share.sample", _ctx(work, t)))
