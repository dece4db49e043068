"""Isolation and device rules of the PyTorch port, and its sampler CLI.

* Importing every module of the port pulls in neither `jax` nor the JAX
  package (checked in a fresh interpreter), and no source of the port nor
  chip_smoke.py imports them (AST scan). The port's name starts with the
  JAX package's, so module names are matched exactly or by the prefix
  'ratio_guided_multimodal_fm_tpu.'.
* Entry points default to CUDA and fail clearly without it.
* The sampler, evaluation, bench, train, reflow, serve and 64-px demo
  CLIs refuse to run without one unless asked for the CPU.
* Each module of slice 9 (the encoder-decoder, merged-pair evaluation,
  FLOP counts, observability, natural-image data, the 64-px demo), of
  slice 10 (parallel/, the training CUDA graph, the stretch demo) and of
  slice 12 (the packages that re-export the JAX package's names)
  imports without JAX on its own.
* The CLI runs end to end on the CPU from the reference-layout .pth files
  that the JAX package's exporter writes.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ratio_guided_multimodal_fm_tpu_torch"
FORBIDDEN = ("jax", "ratio_guided_multimodal_fm_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exactly():
    assert _forbidden("jax.numpy") and _forbidden("ratio_guided_multimodal_fm_tpu")
    assert _forbidden("ratio_guided_multimodal_fm_tpu.sample.guided")
    assert not _forbidden("ratio_guided_multimodal_fm_tpu_torch.ops")
    assert not _forbidden("jaxlib_free") and not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ratio_guided_multimodal_fm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', "
        "'ratio_guided_multimodal_fm_tpu') or m.startswith(('jax.', "
        "'ratio_guided_multimodal_fm_tpu.'))]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 25 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


SLICE9_MODULES = ("models.flow_matching", "models.merged", "core.flops",
                  "core.observability", "data.natural", "cli.config5_demo")


@pytest.mark.parametrize("module", SLICE9_MODULES)
def test_slice9_module_imports_no_jax(module):
    """Each module of the encoder-decoder, merged-pair, support and 64-px
    slice imports in a fresh interpreter without jax or the JAX package."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('ratio_guided_multimodal_fm_tpu_torch."
        f"{module}')\n"
        "bad = [m for m in sys.modules if m in ('jax', "
        "'ratio_guided_multimodal_fm_tpu') or m.startswith(('jax.', "
        "'ratio_guided_multimodal_fm_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (PORT / (module.replace(".", "/") + ".py")).exists()


SLICE10_MODULES = ("parallel", "parallel.mesh", "parallel.multihost",
                   "parallel.sharded_guidance", "train.graphs",
                   "cli.stretch64_demo")


@pytest.mark.parametrize("module", SLICE10_MODULES)
def test_slice10_module_imports_no_jax(module):
    """Each module of the multi-process, fused-training and stretch-demo
    slice imports in a fresh interpreter without jax or the JAX package
    (and without importing triton or building a kernel)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('ratio_guided_multimodal_fm_tpu_torch."
        f"{module}')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton', "
        "'ratio_guided_multimodal_fm_tpu') or m.startswith(('jax.', "
        "'ratio_guided_multimodal_fm_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    path = PORT / module.replace(".", "/")
    assert path.with_suffix(".py").exists() or (path / "__init__.py").exists()


# slice 12: the packages whose __init__ gained re-exports, each first in a
# fresh interpreter (importing one of their modules runs the __init__ first)
SLICE12_PACKAGES = ("", "core", "train", "flow", "data", "eval", "sample")


@pytest.mark.parametrize("module", SLICE12_PACKAGES)
def test_slice12_exports_import_no_jax(module):
    """Each package that re-exports the JAX package's names imports first
    in a fresh interpreter without jax, the JAX package or triton, and
    without an import cycle."""
    name = "ratio_guided_multimodal_fm_tpu_torch" + (f".{module}" if module
                                                     else "")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('{name}')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton', "
        "'ratio_guided_multimodal_fm_tpu') or m.startswith(('jax.', "
        "'ratio_guided_multimodal_fm_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(map(_forbidden, names)), (f, names)


def test_entry_points_require_a_gpu_by_default(tmp_path, monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        evaluate,
        evaluate_mnist_svhn,
        reflow,
        resblock_kernel_bench,
        sample,
        sample_mnist_svhn,
        serve,
        train_classifier,
        train_classifiers_mnist_svhn,
        train_flow,
        train_flow_mnist32,
        train_flow_svhn,
        train_ratio,
        train_ratio_mnist_svhn,
    )
    from ratio_guided_multimodal_fm_tpu_torch.cli import (
        config5_demo,
        stretch64_demo,
    )
    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        resolve_device,
    )
    from ratio_guided_multimodal_fm_tpu_torch.sample import (
        sample_bimodal_guided,
        sample_bimodal_smc,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path is valid")
    monkeypatch.chdir(tmp_path)
    for call in (lambda: resolve_device(),
                 lambda: sample_mnist_svhn.main(["--num_steps", "1"]),
                 lambda: sample.main(["--num_steps", "1"]),
                 lambda: evaluate.main(["--num_steps", "1"]),
                 lambda: evaluate_mnist_svhn.main(["--num_steps", "1"]),
                 lambda: resblock_kernel_bench.main([]),
                 lambda: train_flow.main(["--modality", "x"]),
                 lambda: train_flow_mnist32.main([]),
                 lambda: train_flow_svhn.main([]),
                 lambda: train_ratio.main([]),
                 lambda: train_ratio_mnist_svhn.main([]),
                 lambda: train_classifier.main([]),
                 lambda: train_classifiers_mnist_svhn.main([]),
                 lambda: reflow.main([]),
                 lambda: serve.main(["--port", "0"]),
                 lambda: config5_demo.main([]),
                 lambda: stretch64_demo.main([]),
                 lambda: sample_bimodal_guided(lambda x, t: x,
                                               lambda y, t: y),
                 lambda: sample_bimodal_smc(lambda x, t: x, lambda y, t: y,
                                            lambda x, y: x[:, 0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _write_exported_checkpoints(root: pathlib.Path):
    """Random-init JAX models exported to reference-layout .pth files, as
    `rgmf-export-torch --out` writes them."""
    import jax.numpy as jnp

    from ratio_guided_multimodal_fm_tpu.interop.torch_export import (
        export_state_dict,
    )
    from ratio_guided_multimodal_fm_tpu.models import (
        FlowMatchingUNetMNIST,
        FlowMatchingUNetSVHN,
        RatioEstimatorMNISTSVHN,
    )

    k = jax.random.PRNGKey(0)
    x, y, t = jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 3)), \
        jnp.zeros((1,))
    specs = [("flow_mnist32_best.pth", "unet_mnist",
              FlowMatchingUNetMNIST(img_size=32).init(k, x, t)),
             ("flow_svhn_best.pth", "unet_svhn",
              FlowMatchingUNetSVHN().init(k, y, t)),
             ("ratio_disc_mnist_svhn_best.pth", "ratio_mnist_svhn",
              RatioEstimatorMNISTSVHN().init(k, x, y))]
    (root / "checkpoints").mkdir()
    for fname, kind, variables in specs:
        sd = export_state_dict(dict(variables), kind)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   root / "checkpoints" / fname)


def test_cli_runs_on_cpu_from_exported_checkpoints(tmp_path, monkeypatch):
    from ratio_guided_multimodal_fm_tpu_torch.cli import sample_mnist_svhn

    torch.set_num_threads(2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="checkpoint not found"):
        sample_mnist_svhn.main(["--device", "cpu", "--num_steps", "1"])
    _write_exported_checkpoints(tmp_path)
    x1, y1, diags = sample_mnist_svhn.main([
        "--device", "cpu", "--guidance_method", "mc_feng",
        "--num_samples", "2", "--num_steps", "2", "--mc_batch_size", "3"])
    assert x1.shape == (2, 32, 32, 1) and y1.shape == (2, 32, 32, 3)
    assert torch.isfinite(x1).all() and torch.isfinite(y1).all()
    trace = tmp_path / "outputs" / "mnist_svhn" / \
        "diagnostics_mc_feng_gamma0.5.json"
    rows = json.loads(trace.read_text())
    assert len(rows) == 2 and "ess_mean" in rows[1]
    assert os.path.exists(tmp_path / "outputs" / "mnist_svhn" /
                          "samples_mc_feng_gamma0.5.png") or \
        _no_matplotlib()


def _no_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return True
    return False
