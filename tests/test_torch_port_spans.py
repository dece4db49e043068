"""The port's span recorder (core/observability.py) and where its spans
are placed, on the CPU.

* spans nest: each records its enclosing span's name as `parent` and the
  outermost span's `call_id`; a span's self time is its duration minus
  its children's; the per-name totals outlive the ring's evictions; a
  window selects the spans that overlap it; each thread keeps its own
  stack; a span whose body raises is still recorded;
* one clock: a span's start lies between a `time.time_ns()` read before it
  and the Kineto start of the first event it encloses in a CPU
  torch.profiler session, and no event of that session bears the span's
  name (the spans stay invisible to the profiler);
* placement: each call of the fused trainers (graph=False) and of the
  single train steps is one `train.fm.call` / `train.ratio.call`;
  ops/_build.py records `ops.build` only when it compiles and `ops.load`
  only at a library's first load.
(The card's part, TrainGraph's warm-up, capture and replay spans and a
kernel's device interval inside its span: tests/test_torch_port_cuda.py.)
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.core import observability as obs
from ratio_guided_multimodal_fm_tpu_torch.ops import _build
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_recorder():
    obs.reset()
    yield
    obs.reset()


def _named(name):
    return [s for s in obs.spans() if s.name == name]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_spans_nest_with_parent_and_a_shared_call_id(depth):
    def nest(d):
        with obs.span(f"level{d}"):
            if d + 1 < depth:
                nest(d + 1)
    nest(0)
    nest(0)
    recs = obs.spans()
    assert len(recs) == 2 * depth
    first, second = recs[:depth], recs[depth:]
    for run in (first, second):
        # children close first: the innermost span is recorded first
        assert [s.name for s in run] == [f"level{d}"
                                         for d in reversed(range(depth))]
        assert [s.parent for s in run] == [f"level{d - 1}" if d else None
                                           for d in reversed(range(depth))]
        assert len({s.call_id for s in run}) == 1
        for inner, outer in zip(run, run[1:]):
            assert outer.start_ns <= inner.start_ns <= inner.end_ns \
                <= outer.end_ns
    assert first[0].call_id != second[0].call_id


@pytest.mark.parametrize("children", [0, 1, 3])
def test_self_time_subtracts_the_child_spans(children):
    with obs.span("parent"):
        time.sleep(0.002)
        for _ in range(children):
            with obs.span("child"):
                time.sleep(0.002)
    (parent,) = _named("parent")
    kids = _named("child")
    assert len(kids) == children
    covered = sum(k.end_ns - k.start_ns for k in kids)
    totals = obs.span_totals()
    assert totals["parent"]["count"] == 1
    assert totals["parent"]["total_ns"] == parent.end_ns - parent.start_ns
    assert totals["parent"]["self_ns"] == totals["parent"]["total_ns"] \
        - covered
    assert totals["parent"]["self_ns"] >= 2_000_000
    if children:
        assert totals["child"]["self_ns"] == totals["child"]["total_ns"] \
            == covered


@pytest.mark.parametrize("capacity", [1, 4])
def test_totals_survive_ring_eviction(capacity):
    rec = obs.SpanRecorder(capacity)
    with rec.span("setup"):
        pass
    for _ in range(10):
        with rec.span("call"):
            pass
    kept = rec.spans()
    assert len(kept) == capacity
    assert {s.name for s in kept} == {"call"}
    totals = rec.span_totals()
    assert totals["setup"]["count"] == 1 and totals["call"]["count"] == 10
    assert totals["call"]["total_ns"] >= sum(s.end_ns - s.start_ns
                                             for s in kept)
    rec.reset()
    assert rec.spans() == [] and rec.span_totals() == {}


def test_a_window_selects_the_spans_that_overlap_it():
    for name in ("a", "b", "c"):
        with obs.span(name):
            time.sleep(0.001)
    a, b, c = obs.spans()
    assert obs.spans((a.end_ns, c.start_ns)) == [b]
    assert obs.spans((a.start_ns, a.start_ns + 1)) == [a]
    assert obs.spans((c.end_ns, c.end_ns + 10**9)) == []
    assert obs.spans((a.start_ns, c.end_ns)) == [a, b, c]


def test_each_thread_keeps_its_own_stack():
    started, release = threading.Event(), threading.Event()

    def worker():
        with obs.span("worker"):
            started.set()
            release.wait(10)

    th = threading.Thread(target=worker)
    with obs.span("main"):
        th.start()
        assert started.wait(10)
        with obs.span("main.child"):
            pass
        release.set()
        th.join(10)
    assert not th.is_alive()
    (w,) = _named("worker")
    (m,) = _named("main")
    (c,) = _named("main.child")
    assert w.parent is None and w.call_id != m.call_id
    assert c.parent == "main" and c.call_id == m.call_id


def test_a_span_whose_body_raises_is_recorded():
    with pytest.raises(ValueError):
        with obs.span("outer"):
            with obs.span("inner"):
                raise ValueError("boom")
    assert [s.name for s in obs.spans()] == ["inner", "outer"]
    with obs.span("next"):
        pass
    assert _named("next")[0].parent is None


def _events(prof):
    """(name, Kineto start ns, end ns) of every event of the session,
    user annotations included."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def test_a_span_is_on_the_profilers_clock():
    """The span opens after a time.time_ns() read and 1 ms before the
    first operation it encloses, and closes 1 ms after it: on another
    clock (perf_counter, monotonic) the Kineto times would lie ~1e18 ns
    away, and an offset over 1 ms would break the order."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = time.time_ns()
        with obs.span("test.clock"):
            time.sleep(0.001)
            a.mm(a)
            time.sleep(0.001)
    (s,) = _named("test.clock")
    inside = sorted(e for e in _events(prof) if e[0] == "aten::mm")
    assert inside
    first = inside[0]
    assert before <= s.start_ns <= first[1]
    assert first[1] - s.start_ns >= 1_000_000
    assert first[2] <= s.end_ns
    assert s.end_ns - s.start_ns < 10**9


def test_the_profiler_sees_no_span():
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("train.fm.call"):
            with obs.span("train.graph.replay"):
                a.mm(a)
    names = {e[0] for e in _events(prof)} | {e.name for e in prof.events()}
    assert "aten::mm" in names
    assert not names & {"train.fm.call", "train.graph.replay"}
    assert len(obs.spans()) == 2


class _TinyVelocity(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 1, 3, padding=1)

    def forward(self, x, t):
        return self.conv(x) * t.view(-1, 1, 1, 1)


class _TinyRatio(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(2 * 16, 1)

    def forward(self, x, y):
        return self.lin(torch.cat([x.flatten(1), y.flatten(1)], 1))[:, 0]


def _data(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, 4, 4, 1).astype(np.float32))


def _idx(k, b, n, seed):
    return np.random.RandomState(seed).randint(0, n, (k, b)).astype(np.int32)


def _fused_fm(calls):
    torch.manual_seed(0)
    state = S.create_fm_state(_TinyVelocity(), "cpu", ema_decay=0.9)
    step = S.make_fm_train_multistep(0.9, graph=False)
    data = _data(12, 1)
    for c in range(calls):
        step(state, data, _idx(3, 2, 12, c), torch.Generator().manual_seed(c))


def _fused_ratio(calls):
    torch.manual_seed(0)
    state = S.create_ratio_state(_TinyRatio(), "cpu", ema_decay=0.9)
    step = S.make_ratio_train_multistep("disc", 0.9, graph=False)
    x, y = _data(12, 1), _data(12, 2)
    real = np.array([[1.0, 0.0]] * 3, np.float32)
    for c in range(calls):
        step(state, x, y, _idx(3, 2, 12, c), _idx(3, 2, 12, c + 50), real,
             torch.Generator().manual_seed(c))


def _single_fm(calls):
    torch.manual_seed(0)
    state = S.create_fm_state(_TinyVelocity(), "cpu")
    step = S.make_fm_train_step()
    for c in range(calls):
        step(state, _data(2, c), torch.Generator().manual_seed(c))


def _single_ratio(calls):
    torch.manual_seed(0)
    state = S.create_ratio_state(_TinyRatio(), "cpu")
    step = S.make_ratio_train_step("disc")
    for c in range(calls):
        step(state, _data(2, c), _data(2, c + 50), np.array([1.0, 0.0]),
             torch.Generator().manual_seed(c))


@pytest.mark.parametrize("run,name", [
    (_fused_fm, "train.fm.call"), (_fused_ratio, "train.ratio.call"),
    (_single_fm, "train.fm.call"), (_single_ratio, "train.ratio.call")],
    ids=["fused_fm", "fused_ratio", "single_fm", "single_ratio"])
def test_each_trainer_call_is_one_call_span(run, name):
    run(3)
    recs = obs.spans()
    assert [s.name for s in recs] == [name] * 3
    assert all(s.parent is None for s in recs)
    assert len({s.call_id for s in recs}) == 3
    assert obs.span_totals()[name]["count"] == 3


def test_build_all_records_a_span_only_when_it_compiles(monkeypatch,
                                                        tmp_path):
    built = []
    monkeypatch.setattr(_build, "_build",
                        lambda srcs: built.append(srcs) or {})
    monkeypatch.setattr(_build, "_lib_path",
                        lambda src: tmp_path / f"{src.stem}.so")
    _build.build_all()                   # nothing built yet: compiles all
    assert len(built) == 1 and built[0]
    assert len(_named("ops.build")) == 1
    for src in built[0]:
        (tmp_path / f"{src.stem}.so").touch()
    assert _build.build_all() == {}      # all built: no span
    assert len(built) == 1 and len(_named("ops.build")) == 1


def test_load_records_a_span_at_the_first_load_only(monkeypatch, tmp_path):
    lib = tmp_path / "flash_guidance.so"
    lib.touch()
    loaded = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_lib_path", lambda src: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())
    first = _build.load("flash_guidance")
    assert _build.load("flash_guidance") is first
    assert loaded == [str(lib)]
    (s,) = _named("ops.load")
    assert s.parent is None
