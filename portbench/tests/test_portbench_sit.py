"""The SiT-XL/2 cell on the CPU. `test_cell_files` and `test_metrics`
check its files and entries as they do every cell's; here, on a copy of
the benchmark with the configuration cut to a tiny SiT (depth 2, hidden 96,
4 heads, 8×8×4 latents, 10 classes): the `train_flow_cond` driver gives
`correct` true and half the batch false; and the kind's FLOP counts at
SiT-XL/2; the `attn_roofline` reader's arithmetic and its silences.
`test_portbench_cells.py` cannot drive this cell: its `TINY` map cuts
batch, data and steps but no width."""
import json
import shutil
import time

import pytest
import torch

from conftest import ROOT
from portbench.harness import runner
from portbench.harness import trace as tr
from portbench.harness.compare import verdict
from portbench.harness.window import Window
from portbench.reference.kinds import sit_transformer as kind

CELL = "sitxl2.train.flow.b32_k2"
CONF = "sit_xl2_in256"
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=96,
            depth=2, num_heads=4, mlp_ratio=4.0, class_dropout_prob=0.1,
            num_classes=10, learn_sigma=True)
PEAKS = {"card": "H100", "fp32": 67e12, "bf16": 989e12, "bytes": 3.35e12}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the SiT cell's configuration cut to TINY
    (the port's `SiT` class with TINY's arguments)."""
    root = tmp_path_factory.mktemp("sit")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "portbench" / "configs" / f"{CONF}.json"
    conf = json.loads(path.read_text())
    conf["nets"]["flow"].update(port="SiT", port_kwargs=TINY, arch=TINY,
                                shape=[8, 8, 4])
    path.write_text(json.dumps(conf))
    return root


def test_the_cell_is_correct_and_half_the_batch_is_not(tiny_root):
    out = runner.run(tiny_root, CELL, 3_000_000_019, 0.1, True,
                     torch.device("cpu"), time.perf_counter(),
                     sizes={"batch": 4, "data": 64, "fused_steps": 2},
                     control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    # on the CPU: no trace, so only the readers of spans and rates speak
    assert "attn_roofline" not in out["metrics"]
    limits = runner.load_cell(tiny_root, CELL).limits["limits"]
    half = [{"name": k, "value": v, "limit": limits[k]}
            for k, v in out["control"]["half_batch"].items()]
    assert not verdict(half), out["control"]["half_batch"]


def test_the_driver_passes_the_labels_and_counts_the_attention(tiny_root):
    from portbench.drivers.train_flow_cond import Driver

    cell = runner.load_cell(tiny_root, CELL)
    drv = Driver(cell.config, cell.traffic, 7, torch.device("cpu"),
                 {"batch": 4, "data": 64, "fused_steps": 2})
    drv.setup()
    assert drv.labels.shape == (64,) and int(drv.labels.max()) < 10
    # 2 check calls of 2 sub-steps, 2 blocks each, on the CPU's math path
    assert drv.attn_calls == {"sdpa.efficient_launches": 0,
                              "sdpa.math_launches": 8}
    w = drv.work(Window(8, 1, 1.0))
    # 3 × the forward's attention products of 6 calls of 2 steps of 4
    assert w["attn_flops"] == 3 * kind.attn_flops(TINY, 6 * 2 * 4)


def test_flops_at_sit_xl_2():
    conf = json.loads((ROOT / "portbench" / "configs"
                       / f"{CONF}.json").read_text())
    arch = conf["nets"]["flow"]["arch"]
    assert kind.flops(arch, 1) == 237_242_843_136
    assert kind.attn_flops(arch, 1) == 8_455_716_864
    assert kind.flops(arch, 32) == 32 * 237_242_843_136


def _ctx(calls, trace):
    work = {"kind": "train", "units_per_s": 50.0,
            "flops_per_unit": 3 * 237e9, "attn_flops": 3e11,
            "attn_calls": calls}
    return runner.Context("samples", 1.0, Window(50, 1, 1.0), work=work,
                          trace=trace, peaks=PEAKS)


def test_attn_roofline_reads_the_attention_kernels():
    """3e11 FLOP (3 × 1e9 × 100 examples) in 2 ms of cutlass kernels, against
    989/6 TFLOP/s: 3e11 / 164.83e12 / 2e-3 = 91.0%."""
    t = tr.Trace((0, 10_000_000), [
        ("fmha_cutlassF_f32_aligned_64x64_rf_sm80", 0, 500_000),
        ("fmha_cutlassB_f32_aligned_64x64_k128_sm80", 500_000, 2_000_000),
        ("sm90_xmma_gemm_f32f32", 2_000_000, 9_000_000)])
    read = runner.reader(ROOT, "attn_roofline")
    ok = {"sdpa.efficient_launches": 56, "sdpa.math_launches": 0}
    assert read(_ctx(ok, t)) == pytest.approx(
        100 * 3e11 / (989e12 / 6) / 2e-3)
    assert read(_ctx(dict(ok, **{"sdpa.math_launches": 1}), t)) is None
    assert read(_ctx({}, t)) is None
    assert read(_ctx(ok, tr.Trace((0, 10), [("gemm", 0, 10)]))) is None
    assert read(_ctx(ok, None)) is None
