"""The one launch seam of the port's kernels (ops/_capi.py) and the one
graph tail of its fused trainers (train/graphs.py:fused_macro_step), on
the CPU.

* a launch through a fake library (`_build.load` and the stream lookup
  replaced): the device index and the stream go last; a zero return code
  bumps exactly the named counter by one, and none while a capture is
  faked; a non-zero code raises RuntimeError naming the kernel, the CUDA
  error string and the plan; each entry point is bound once;
* `ops.launch_counts()` has the wrappers' counters, every one declared
  through the seam;
* the fused trainers' graph path, with TrainGraph replaced by one that
  runs its body eagerly (the first run as the warm-up, then as a replay):
  three macro steps equal the eager loop's bit for bit, on one cached
  graph whose static inputs are refilled each call.
"""
import numpy as np
import pytest
import torch
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch import ops
from ratio_guided_multimodal_fm_tpu_torch.ops import _capi
from ratio_guided_multimodal_fm_tpu_torch.train import graphs as G
from ratio_guided_multimodal_fm_tpu_torch.train import steps as S

torch.set_num_threads(2)

DEVICE, STREAM = 3, 0xABC


class _FakeFn:
    """A ctypes function: records its calls, returns `rc`."""

    def __init__(self, rc=0, result=None):
        self.rc, self.result, self.calls = rc, result, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.result if self.result is not None else self.rc


class _FakeLib:
    def __init__(self, rc):
        self.rgmf_k = _FakeFn(rc)
        self.rgmf_cuda_error_string = _FakeFn(result=b"an illegal thing")
        self.lookups = []

    def __getattribute__(self, name):
        if name.startswith("rgmf_"):
            object.__getattribute__(self, "lookups").append(name)
        return object.__getattribute__(self, name)


@pytest.fixture
def seam(monkeypatch):
    """(the fake library, loads) behind the seam, a fresh binding cache,
    the stream lookup fixed and a counted function."""
    libs, loads = {}, []

    def load(name):
        loads.append(name)
        return libs[name]

    monkeypatch.setattr(_capi._build, "load", load)
    monkeypatch.setattr(_capi, "_bound", {})
    monkeypatch.setattr(_capi, "device_and_stream",
                        lambda t: (DEVICE, STREAM))
    monkeypatch.setattr(_capi, "COUNTERS", [])

    def counted():
        pass

    _capi.counters(counted, "launches", "other_launches")

    def make(rc=0):
        libs["fake"] = _FakeLib(rc)
        return libs["fake"], loads, counted
    return make


def _launch(kernel, counted, plan="plan(1, 2)"):
    kernel(7, 8, on=torch.zeros(1), plan=plan, counter=(counted, "launches"))


def test_a_launch_appends_device_and_stream_and_counts_once(seam):
    lib, _, counted = seam()
    kernel = _capi.Kernel("fake", "k", [_capi.PTR, _capi.INT])
    _launch(kernel, counted)
    assert lib.rgmf_k.calls == [(7, 8, DEVICE, STREAM)]
    assert lib.rgmf_k.argtypes == [_capi.PTR, _capi.INT, _capi.INT,
                                   _capi.PTR]
    assert lib.rgmf_k.restype is _capi.INT
    assert (counted.launches, counted.other_launches) == (1, 0)
    assert [(f.__name__, a) for f, a in _capi.COUNTERS] == [
        ("counted", "launches"), ("counted", "other_launches")]


class _OnCard:
    device = torch.device("cuda", 0)


def test_a_launch_under_capture_does_not_count(seam, monkeypatch):
    lib, _, counted = seam()
    kernel = _capi.Kernel("fake", "k", [_capi.PTR, _capi.INT])
    for capturing in (True, False, True):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: capturing)
        kernel(7, 8, on=_OnCard(), plan="p", counter=(counted, "launches"))
    assert len(lib.rgmf_k.calls) == 3
    assert (counted.launches, counted.other_launches) == (1, 0)
    # work on the CPU always runs when it is issued
    assert _capi.eager(torch.device("cpu"))


def test_a_failed_launch_raises_with_kernel_error_and_plan(seam):
    lib, _, counted = seam(rc=700)
    kernel = _capi.Kernel("fake", "k", [_capi.PTR, _capi.INT])
    with pytest.raises(RuntimeError) as err:
        _launch(kernel, counted, plan="GNPlan(vec=4, cluster=8)")
    msg = str(err.value)
    assert msg.startswith("k kernel launch failed: CUDA error 700 ")
    assert "(an illegal thing)" in msg and "GNPlan(vec=4, cluster=8)" in msg
    assert lib.rgmf_cuda_error_string.calls == [(700,)]
    assert counted.launches == 0


def test_an_entry_point_is_bound_once(seam):
    lib, loads, counted = seam()
    kernel = _capi.Kernel("fake", "k", [_capi.PTR, _capi.INT])
    for _ in range(3):
        _launch(kernel, counted)
    again = _capi.Kernel("fake", "k", [_capi.PTR, _capi.INT])
    _launch(again, counted)
    assert loads == ["fake"] and lib.lookups == ["rgmf_k"]
    assert counted.launches == 4 and len(lib.rgmf_k.calls) == 4


def test_the_launch_counters_are_the_seams():
    assert sorted(ops.launch_counts()) == [
        "batch_norm_silu.launches", "batch_norm_silu_backward.launches",
        "flash_guidance.launches", "fused_gn_silu_conv.launches",
        "group_norm_silu.launches", "group_norm_silu_backward.launches",
        "group_norm_silu_backward.weight_grad_launches",
        "linear_tf32x3.launches", "linear_tf32x3.split_launches",
        "sdpa.efficient_launches", "sdpa.math_launches"]
    before = ops.launch_counts()["sdpa.math_launches"]
    q = torch.randn(1, 2, 4, 8)
    ops.sdpa(q, q, q)
    assert ops.launch_counts()["sdpa.math_launches"] == before + 1


class _EagerGraph:
    """TrainGraph's contract without a card: the first run is the eager
    warm-up (checks on), every later one a replay of the body (checks
    off) on the static tensors."""

    def __init__(self, fn, static):
        self.fn, self.static, self.replays = fn, static, 0
        self.warm = False

    def run(self):
        if not self.warm:
            self.warm = True
            return self.fn(self.static, True)
        self.replays += 1
        return self.fn(self.static, False)


class _TinyVelocity(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 1, 3, padding=1)
        self.drop = nn.Dropout(0.1)

    def forward(self, x, t):
        return self.drop(self.conv(x)) * t.view(-1, 1, 1, 1)


class _TinyRatio(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(2 * 16, 1)
        self.drop = nn.Dropout(0.1)

    def forward(self, x, y):
        return self.lin(self.drop(torch.cat([x.flatten(1), y.flatten(1)],
                                            1)))[:, 0]


def _data(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, 4, 4, 1).astype(np.float32))


def _idx(seed):
    return np.random.RandomState(seed).randint(0, 12, (3, 2)).astype(
        np.int32)


def _real(seed):
    """A fresh mask a call (on the CPU the trainer's tensors may share the
    caller's numpy memory, which a graph's refill then writes)."""
    return (np.random.RandomState(seed).rand(3, 2) < 0.5).astype(np.float32)


def _fm(step):
    torch.manual_seed(0)
    state = S.create_fm_state(_TinyVelocity(), "cpu", ema_decay=0.9)
    data = _data(12, 1)
    return state, [step(state, data, _idx(c),
                        torch.Generator().manual_seed(c)) for c in range(3)]


def _ratio(step):
    torch.manual_seed(0)
    state = S.create_ratio_state(_TinyRatio(), "cpu", ema_decay=0.9)
    x, y = _data(12, 1), _data(12, 2)
    return state, [step(state, x, y, _idx(c), _idx(c + 50),
                        _real(c), torch.Generator().manual_seed(c))
                   for c in range(3)]


@pytest.mark.parametrize("trainer", ["fm", "ratio"])
def test_the_graph_tail_equals_the_eager_loop(trainer, monkeypatch):
    monkeypatch.setattr(G, "TrainGraph", _EagerGraph)
    if trainer == "fm":
        graphed, eager = (S.make_fm_train_multistep(0.9, graph=g)
                          for g in (True, False))
        run = _fm
    else:
        graphed, eager = (S.make_ratio_train_multistep("disc", 0.9, graph=g)
                          for g in (True, False))
        run = _ratio
    sg, outs_g = run(graphed)
    se, outs_e = run(eager)
    for og, oe in zip(outs_g, outs_e):
        if trainer == "ratio":
            assert og.keys() == oe.keys()
            og, oe = torch.stack(list(og.values())), \
                torch.stack(list(oe.values()))
        assert torch.equal(og, oe)
    for k, v in se.model.state_dict().items():
        assert torch.equal(sg.model.state_dict()[k], v), k
    for k, v in se.ema.items():
        assert torch.equal(sg.ema[k], v), k
    (g,) = graphed.graphs.values()
    assert g.replays == 2 and not eager.graphs
    assert next(iter(graphed.graphs))[0] == id(sg.model)
