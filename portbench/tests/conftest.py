"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from the
repository root. Tests marked `cuda` need the card and skip without one
(the decision is made inside the test, never at import)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def with_latent_cells(root: Path) -> Path:
    """A copy of the benchmark in `root` with the entries of
    `latent_cells.json` added, and their limits under portbench/limits:
    the sampler cells that BENCHMARK.json leaves out for now, so that their
    driver and metrics stay driven end to end."""
    import json
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    latent = json.loads((ROOT / "portbench" / "tests"
                         / "latent_cells.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += latent[key]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, limits in latent["limits"].items():
        (root / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    return root
