"""BENCHMARK.json against the benchmark's contract, and the harness found
by name: every cell's configuration, traffic, driver and limits, every
metric's reader; a new cell, traffic mix and per-layer metric, and a new
kind of net, added as new files and entries alone."""
import importlib.util
import json
import re
import shutil
import sys
import time

import pytest
import torch

import kind_encdec
from conftest import ROOT
from portbench.harness import runner
from portbench.harness.compare import verdict

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


def _held(tree, key):
    """Every value of `key` in the configuration, its `published` map
    left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key:
                yield v
            elif k != "published":
                yield from _held(v, key)
    elif isinstance(tree, list):
        for v in tree:
            yield from _held(v, key)


def check_cell_files(root, cell):
    """The files a cell is found by: its configuration (whose `reduced`
    is its entry's, each key with its `published` value and a value of its
    own held in the file), its traffic's driver (`portbench/drivers/
    <driver>.py`, defining `Driver`) and its limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    c = runner.load_cell(root, cell)
    assert c.chips == 1
    conf = {x["name"]: x for x in bench["configs"]}[
        {w["name"]: w for w in bench["workloads"]}[cell]["config"]]
    assert conf["file"].startswith("portbench/configs/")
    assert c.config["source"] == conf["source"]
    assert c.config["reduced"] == conf["reduced"], (
        f"{conf['file']}: reduced {c.config['reduced']} is not "
        f"BENCHMARK.json's {conf['reduced']}")
    published = c.config.get("published", {})
    for key in conf["reduced"]:
        assert key in published, (
            f"{conf['file']}: reduced key {key!r} has no published value")
        held = list(_held(c.config, key))
        assert any(v != published[key] for v in held), (
            f"{conf['file']}: reduced key {key!r} holds {held}, not cut "
            f"from the published {published[key]!r}")
    path = root / "portbench" / "drivers" / f"{c.traffic['driver']}.py"
    assert path.is_file(), f"no driver {path}"
    spec = importlib.util.spec_from_file_location(
        f"portbench_driver_{c.traffic['driver']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert isinstance(getattr(mod, "Driver", None), type), (
        f"{path} defines no Driver")
    assert c.limits["limits"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    check_cell_files(ROOT, cell)


def _copy(root):
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root, root / "portbench"


def _edit_json(path, **changes):
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


FLOW = "exp2.train.flow_svhn.b128_k8"
CONF = "exp2_mnist32_svhn"


def _driver_missing(root, pb):
    _edit_json(pb / "traffic" / "train.flow_y.b128_k8.json",
               driver="train_sit")
    return str(pb / "drivers" / "train_sit.py")


def _driver_without_class(root, pb):
    (pb / "drivers" / "train_sit.py").write_text("UNIT = 'samples'\n")
    _edit_json(pb / "traffic" / "train.flow_y.b128_k8.json",
               driver="train_sit")
    return "defines no Driver"


def _reduced_not_the_entrys(root, pb):
    _edit_json(pb / "configs" / f"{CONF}.json", reduced=["num_res_blocks"],
               published={"num_res_blocks": 3})
    return "is not BENCHMARK.json's"


def _reduced(root, published):
    """`num_res_blocks` listed as reduced in the file and its entry."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"][0]["reduced"] = ["num_res_blocks"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _edit_json(root / "portbench" / "configs" / f"{CONF}.json",
               reduced=["num_res_blocks"], published=published)


def _reduced_unpublished(root, pb):
    _reduced(root, {})
    return "has no published value"


def _reduced_uncut(root, pb):
    _reduced(root, {"num_res_blocks": 2})
    return "not cut"


BROKEN = [_driver_missing, _driver_without_class, _reduced_not_the_entrys,
          _reduced_unpublished, _reduced_uncut]


@pytest.mark.parametrize("fault", BROKEN, ids=[f.__name__[1:]
                                               for f in BROKEN])
def test_cell_files_refuse(tmp_path, fault):
    """A driver that is not there or defines no `Driver`, and a `reduced`
    that is not the entry's, has no published value or cuts nothing,
    fail `check_cell_files`, which names what it missed."""
    root, pb = _copy(tmp_path)
    check_cell_files(root, FLOW)
    said = fault(root, pb)
    with pytest.raises(AssertionError, match=re.escape(said)):
        check_cell_files(root, FLOW)


def test_cell_files_take_any_driver_and_a_stated_cut(tmp_path):
    """A new driver file defining `Driver`, and a cut with its published
    value, pass."""
    root, pb = _copy(tmp_path)
    (pb / "drivers" / "train_sit.py").write_text(
        "from portbench.drivers.train_flow import Driver  # noqa: F401\n")
    _edit_json(pb / "traffic" / "train.flow_y.b128_k8.json",
               driver="train_sit")
    _reduced(root, {"num_res_blocks": 3})
    check_cell_files(root, FLOW)


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


ENCDEC = {"kind": "encdec", "port": "FlowMatchingModel", "port_kwargs": {},
          "params": 9104513, "shape": [28, 28, 1],
          "arch": {"img_channels": 1, "img_size": 28, "feature_dim": 256,
                   "time_emb_dim": 128, "norm_eps": 1e-6}}


def test_a_new_kind_is_new_files_and_entries_only(tmp_path, monkeypatch):
    """The worked example of PERF.md §4: the port's encoder-decoder
    `FlowMatchingModel` (`--model original`) as a kind of net of its own,
    one file (`kind_encdec.py`, registered as
    `portbench.reference.kinds.encdec`), trained by the unchanged
    `train_flow` driver in a cell of its own, and no existing file
    edited."""
    from portbench.harness import counts
    from portbench.harness.weights import make_params
    from portbench.reference import nets
    from ratio_guided_multimodal_fm_tpu_torch.models import FlowMatchingModel

    root, pb = _copy(tmp_path)
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    shutil.copy(ROOT / "portbench" / "tests" / "kind_encdec.py",
                pb / "reference" / "kinds" / "encdec.py")
    monkeypatch.setitem(sys.modules, "portbench.reference.kinds.encdec",
                        kind_encdec)

    arch = ENCDEC["arch"]
    P = make_params("encdec", arch, 5, torch.device("cpu"))
    assert [k for k, _ in nets.layout("encdec", arch)] == list(P)
    assert nets.param_count("encdec", arch) == ENCDEC["params"] == sum(
        p.numel() for p in FlowMatchingModel().parameters())
    assert nets.Net("encdec", arch, P)(
        torch.zeros(2, 1, 28, 28), torch.zeros(2)).shape == (2, 1, 28, 28)
    assert counts.net_flops("encdec", arch, 2) == kind_encdec.flops(arch, 2)
    assert counts.net_gn_sites("encdec", arch) == kind_encdec.gn_sites(arch)

    name, conf = "exp0.train.flow_encdec.b128_k8", "exp0_encdec_mnist28"
    config = {"name": conf, "source": "https://github.com/foubari/"
              "ratio_guided_Multimodal_FM (src/models/flow_matching.py)",
              "reduced": [], "nets": {"flow_x": ENCDEC},
              "train_dtype": "float32", "data": {"flow_x": 60000}}
    (pb / "configs" / f"{conf}.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "train.flow_y.b128_k8.json")
                         .read_text())
    (pb / "traffic" / "train.flow_x.b128_k8.json").write_text(
        json.dumps(dict(traffic, net="flow_x")))
    shutil.copy(pb / "limits" / f"{FLOW}.json", pb / "limits" / f"{name}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": conf, "source": config["source"],
                             "file": f"portbench/configs/{conf}.json",
                             "reduced": [], "why": "encoder-decoder"})
    bench["workloads"].append({"name": name, "config": conf,
                               "traffic": "train.flow_x.b128_k8",
                               "chips": 1, "why": "encoder-decoder CFM"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if FLOW in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    check_cell_files(root, name)

    out = runner.run(root, name, 3_000_000_019, 0.1, False,
                     torch.device("cpu"), time.perf_counter(),
                     sizes={"batch": 2, "data": 40, "fused_steps": 2},
                     control=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s"}
    limits = runner.load_cell(root, name).limits["limits"]
    half = [{"name": k, "value": v, "limit": limits[k]}
            for k, v in out["control"]["half_batch"].items()]
    assert not verdict(half), out["control"]["half_batch"]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_an_unknown_kind_names_its_file():
    from portbench.harness import counts
    from portbench.harness.weights import make_params
    from portbench.reference import nets

    want = re.escape(str(ROOT / "portbench" / "reference" / "kinds"
                         / "sit.py"))
    for call in (lambda: nets.layout("sit", {}),
                 lambda: nets.param_count("sit", {}),
                 lambda: nets.Net("sit", {}, {}),
                 lambda: counts.net_flops("sit", {}, 1),
                 lambda: counts.net_gn_sites("sit", {}),
                 lambda: make_params("sit", {}, 0, torch.device("cpu"))):
        with pytest.raises(ValueError, match=want):
            call()
