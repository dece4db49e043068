"""BENCHMARK.json against the benchmark's contract, and the harness found
by name: every cell's configuration, traffic and limits, every metric's
reader; a new cell, traffic mix and per-layer metric added as new files
and entries alone."""
import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import runner

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for key, want in KEYS.items():
        for e in BENCH[key]:
            extra = set(e) - want
            assert extra <= ({"workloads"} if key in ("end_to_end",
                                                      "per_layer") else set())
            assert want <= set(e)
            assert NAME.match(e["name"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        got = [m for m in BENCH["end_to_end"] if c in m.get("workloads",
                                                             cells)]
        assert len(got) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    c = runner.load_cell(ROOT, cell)
    assert c.chips == 1
    assert set(c.config["reduced"]) == set()
    assert c.traffic["driver"] in ("sample", "train_flow", "train_ratio")
    assert c.limits["limits"]
    conf = {x["name"]: x for x in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[cell]["config"]]
    assert conf["file"].startswith("portbench/configs/")
    assert c.config["source"] == conf["source"]


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """The worked example of PERF.md: the users' evaluation batch as a
    cell, with its limits, its end-to-end metric and a new per-layer
    metric, and no existing file edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    latent = json.loads((pb / "tests" / "latent_cells.json").read_text())
    name = "exp2.sample.mcfeng.b512"
    (pb / "limits" / f"{name}.json").write_text(
        json.dumps(latent["limits"][name]))
    (pb / "metrics" / "device_s_per_call.py").write_text(
        "def read(ctx):\n    t = ctx.trace\n"
        "    return None if t is None else t.window_ns / 1e9\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "exp2_mnist32_svhn",
                               "traffic": "sample.mcfeng.b512", "chips": 1,
                               "why": "one evaluation batch"})
    bench["end_to_end"].append(dict(latent["end_to_end"][0],
                                    workloads=[name]))
    bench["per_layer"].append({"name": "device_s_per_call", "unit": "s",
                               "better": "lower", "source": "device_trace",
                               "layer": "sampler call",
                               "moves": "pairs_per_s",
                               "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = runner.load_cell(tmp_path, name)
    assert cell.traffic["batch"] == 512
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "pairs_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["device_s_per_call"]
    assert runner.reader(tmp_path, "device_s_per_call")(
        runner.Context("pairs", 1.0, None)) is None
    for p, data in before.items():
        assert p.read_bytes() == data
