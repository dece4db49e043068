"""Every cell driven end to end on the CPU at a tiny size (the kernels'
plain versions stand in for the card's), with the sampler cells that
BENCHMARK.json leaves out for now (`latent_cells.json`): the program
passes its check,
the control (the reference one precision below the configuration's) and
the stand-ins for the faults fail it, and with the timed path broken
underneath `correct` comes out false."""
import json
import time

import pytest
import torch

from conftest import ROOT, with_latent_cells
from portbench.harness import runner
from portbench.harness.compare import verdict

CPU = torch.device("cpu")
TINY = {"exp2.sample.mcfeng.b512": {"batch": 4, "mc_batch": 6,
                                    "num_steps": 5},
        "exp1.sample.mcfeng.b512": {"batch": 4, "mc_batch": 6,
                                    "num_steps": 5},
        "exp2.train.flow_svhn.b128_k8": {"batch": 4, "data": 200,
                                         "fused_steps": 3},
        "exp2.train.ratio.b128_k8": {"batch": 4, "data": 200,
                                     "fused_steps": 3}}
SEED = 3_000_000_017


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark with the sampler cells it leaves out for now."""
    return with_latent_cells(tmp_path_factory.mktemp("latent"))


def _run(root, cell, control=False):
    return runner.run(root, cell, SEED, 0.2, False, CPU,
                      time.perf_counter(), sizes=TINY[cell],
                      control=control)


def test_every_cell_is_driven():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {w["name"] for w in bench["workloads"]} <= set(TINY)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_is_correct_and_its_control_is_not(root, cell):
    out = _run(root, cell, control=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in runner.load_cell(root, cell).end_to_end}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    limits = runner.load_cell(root, cell).limits["limits"]
    lower = [{"name": k, "value": v, "limit": limits[k]}
             for k, v in out["control"]["lower"].items()]
    assert not verdict(lower), out["control"]["lower"]
    if "half_batch" in out["control"]:
        half = [{"name": k, "value": v, "limit": limits[k]}
                for k, v in out["control"]["half_batch"].items()]
        assert not verdict(half), out["control"]["half_batch"]


def _unchanged_step(monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.sample import guided
    real = guided._make_guided_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(x_t, y_t, t, dt):
            _, _, diag = step(x_t, y_t, t, dt)
            return x_t, y_t, diag
        return frozen
    monkeypatch.setattr(guided, "_make_guided_step", make)


def _altered_answer(monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.sample import guided
    real = guided.make_guided_sampler_p

    def make(*a, **k):
        sampler = real(*a, **k)

        def altered(*aa, **kk):
            x1, y1, d = sampler(*aa, **kk)
            x1 = x1.clone()
            x1[1] += 0.5
            return x1, y1, d
        return altered
    monkeypatch.setattr(guided, "make_guided_sampler_p", make)


def _no_update(monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.train import steps
    monkeypatch.setattr(steps, "_apply_update", lambda *a, **k: None)


def _half_batch_fm(monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.train import steps
    real = steps.cfm_loss

    def half(vf, x1, t=None, x0=None, generator=None):
        h = x1.shape[0] // 2
        if t is None:
            t = torch.rand((x1.shape[0],), generator=generator,
                           dtype=x1.dtype, device=x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                             device=x1.device)
        return real(vf, x1[:h], t[:h], x0[:h])
    monkeypatch.setattr(steps, "cfm_loss", half)


def _half_batch_ratio(monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.train import steps
    real = steps.get_ratio_loss

    def get(loss_type="disc", **kw):
        fn = real(loss_type, **kw)

        def half(scores, is_real):
            h = scores.shape[0] // 2
            return fn(scores[:h], is_real[:h])
        return half
    monkeypatch.setattr(steps, "get_ratio_loss", get)


FAULTS = [("exp2.sample.mcfeng.b512", _unchanged_step),
          ("exp1.sample.mcfeng.b512", _unchanged_step),
          ("exp2.sample.mcfeng.b512", _altered_answer),
          ("exp1.sample.mcfeng.b512", _altered_answer),
          ("exp2.train.flow_svhn.b128_k8", _no_update),
          ("exp2.train.flow_svhn.b128_k8", _half_batch_fm),
          ("exp2.train.ratio.b128_k8", _no_update),
          ("exp2.train.ratio.b128_k8", _half_batch_ratio)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root, cell)
    assert not out["correct"], out["checks"]
