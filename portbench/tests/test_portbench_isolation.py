"""What the benchmark loads, judged by whole top-level module names: the
harness and the reference never load JAX, its libraries or the JAX
package (whose name the port's own begins with); the reference loads
nothing of the program either; a whole run loads none of the forbidden
ones; and run.py refuses where it has no card or no program beside it."""
import json
import shutil
import subprocess
import sys

from conftest import ROOT
from portbench.harness import runner

PORT = "ratio_guided_multimodal_fm_tpu_torch"


def _loaded(code: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    fake = {PORT + ".models": object(), "ratio_guided_multimodal_fm_tpux":
            object(), "jaxtyping": object()}
    for k, v in fake.items():
        monkeypatch.setitem(sys.modules, k, v)
    assert all(m.split(".")[0] not in runner.FORBIDDEN
               for m in runner.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ratio_guided_multimodal_fm_tpu.core",
                        object())
    assert runner.forbidden_modules() == ["ratio_guided_multimodal_fm_tpu.core"]


def test_reference_loads_neither_jax_nor_the_program():
    """The reference, every kind of net under `reference/kinds/` and the
    kind fixture that PERF.md's worked example copies."""
    kinds = sorted(p.stem for p in (ROOT / "portbench" / "reference"
                                    / "kinds").glob("*.py")
                   if p.stem != "__init__")
    top = _loaded("import portbench.reference.nets, "
                  "portbench.reference.sampler, portbench.reference.train, "
                  "portbench.reference.kinds, portbench.tests.kind_encdec"
                  + "".join(f", portbench.reference.kinds.{k}"
                            for k in kinds))
    assert not top & set(runner.FORBIDDEN)
    assert PORT not in top


def test_harness_loads_no_jax():
    top = _loaded("from portbench.harness import compare, counts, peaks, "
                  "runner, seeds, trace, weights, window\n"
                  "from portbench.drivers import common, sample, train_flow,"
                  " train_ratio")
    assert not top & set(runner.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    code = ("import time, torch\nfrom pathlib import Path\n"
            "from portbench.harness import runner\n"
            "runner.run(Path('.'), 'exp2.train.flow_svhn.b128_k8', 7, 0.1,"
            " False, torch.device('cpu'), time.perf_counter(), sizes={"
            "'batch': 2, 'data': 40, 'fused_steps': 2})")
    top = _loaded(code)
    assert not top & set(runner.FORBIDDEN)
    assert PORT in top


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "exp2.train.ratio.b128_k8", "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_beside_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "exp2.train.ratio.b128_k8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
