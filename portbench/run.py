"""Run one cell of the port's benchmark once, on the card of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
ones), `device` (with --trace 1 also `busy_s` and `window_s`), with
--trace 1 `breakdown`, the card's name and power limit under `card`, and
last `checks`, each number compared with its limit; the same numbers are
the last lines of standard error.

It refuses (exit 2, no result) where there is no CUDA card, fewer cards
than the cell asks for, no program beside it, or where the window loaded
JAX or the JAX package. Everything it builds goes under `build/` inside the
checkout, at fixed paths.

`--control 1` also prints the readings of the control (the reference one
precision below the configuration's, in the program's place) under
`control`: it is how the limits were measured and is not part of a run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = "ratio_guided_multimodal_fm_tpu_torch"


def refuse(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "BENCHMARK.json").is_file():
        refuse(f"no BENCHMARK.json in {ROOT}")
    if not (ROOT / PORT / "__init__.py").is_file():
        refuse(f"the program under test ({PORT}) is not in {ROOT}")
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import runner

    cell = runner.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        refuse("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        refuse(f"{args.workload} needs {cell.chips} cards, this machine "
               f"has {torch.cuda.device_count()}")
    from portbench.drivers.common import resolve
    device = resolve("cuda")
    out = runner.run(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), device, T0,
                     control=bool(args.control))
    loaded = runner.forbidden_modules()
    if loaded:
        refuse(f"the run loaded {', '.join(loaded)}")
    for name, r in out["checks"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
