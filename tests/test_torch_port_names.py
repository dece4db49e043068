"""Every public name of the JAX package has a counterpart in the port.

The JAX sources are parsed (ast), not imported: a module's public names are
its top-level functions, classes and assignments not starting with '_',
and for an `__init__.py` also what it imports from the package. Each must
be defined or exported by the port's module at the same path (the Pallas
modules map to the port's kernel modules), or stand in NOT_PORTED with
its reason. NOT_PORTED holds ROADMAP's "Not to port" entries and the
Pallas-only names, no more: an entry the port defines, or one the JAX
package no longer has, fails too.
"""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "ratio_guided_multimodal_fm_tpu"
PORT = "ratio_guided_multimodal_fm_tpu_torch"

# JAX module -> the port module that replaces it, where the path differs
COUNTERPART = {"ops/groupnorm_pallas.py": "ops/groupnorm.py",
               "ops/guidance_pallas.py": "ops/guidance.py",
               "ops/resblock_pallas.py": "ops/resblock.py"}

BRIDGE = ("the JAX side of the weight bridge: the port reads and writes "
          "the reference torch layout natively")
ON_CARD = ("every port loader keeps its dataset on the card: there is no "
           "host-to-device stream to cache or prefetch")
SHARDING = ("jax.sharding plumbing: the port's shard_batch, "
            "globalize_batch and DataParallel do this work")
GN_BACKEND = ("selects the JAX GroupNorm backend; the port routes by device "
              "(ops/groupnorm.py)")
PALLAS = "Pallas-only: csrc/flash_guidance.cu replaces the Pallas kernel"

# (JAX module, name) -> reason; name "*" stands for the whole module
NOT_PORTED = {
    ("interop/torch_export.py", "*"): BRIDGE,
    ("interop/torch_import.py", "*"): BRIDGE,
    ("cli/export_torch.py", "*"): BRIDGE,
    ("cli/import_torch.py", "*"): BRIDGE,
    ("interop/__init__.py", "TORCH_EXPORTERS"): BRIDGE,
    ("interop/__init__.py", "TORCH_IMPORTERS"): BRIDGE,
    ("interop/__init__.py", "export_state_dict"): BRIDGE,
    ("interop/__init__.py", "import_state_dict"): BRIDGE,
    ("data/device_data.py", "*"): ON_CARD,
    ("data/prefetch.py", "*"): ON_CARD,
    ("cli/common.py", "wrap_loader"): ON_CARD + " (--no_prefetch is "
                                                "accepted and changes nothing)",
    ("cli/common.py", "batch_to_jnp"): "a host batch to jax arrays: the "
                                       "port's batches are tensors on the "
                                       "card already",
    ("cli/common.py", "load_params_or_exit"): (
        "cli/common.py:load_state_dict does its work: a missing checkpoint "
        "exits (SystemExit) naming the file and how to write it"),
    ("parallel/mesh.py", "batch_sharding"): SHARDING,
    ("parallel/mesh.py", "replicate"): SHARDING,
    ("parallel/mesh.py", "replicated_sharding"): SHARDING,
    ("parallel/__init__.py", "batch_sharding"): SHARDING,
    ("parallel/__init__.py", "replicate"): SHARDING,
    ("parallel/__init__.py", "replicated_sharding"): SHARDING,
    ("parallel/multihost.py", "make_global_array"): SHARDING,
    ("parallel/multihost.py", "replicate_tree"): SHARDING,
    ("models/layers.py", "FusedGroupNorm"): GN_BACKEND,
    ("models/layers.py", "set_gn_impl"): GN_BACKEND,
    ("ops/__init__.py", "fused_guidance_pallas"): PALLAS,
    ("ops/__init__.py", "pallas_available"): PALLAS,
    ("ops/guidance_pallas.py", "fused_guidance_pallas"): PALLAS,
    ("ops/guidance_pallas.py", "pallas_available"): PALLAS,
    ("ops/guidance_pallas.py", "flash_guidance_fits"): (
        "the Pallas kernel's VMEM-fit gate: the CUDA kernels stream the MC "
        "set through shared memory at any N"),
    ("ops/guidance_pallas.py", "NEG_INF"): (
        "the Pallas kernel's -1e30 padding of log r: the CUDA kernels mask "
        "the ragged edges"),
}


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def public_names(rel: str) -> set:
    """Top-level public names of a JAX module, from its source."""
    path = JAX_PKG / rel
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.module or "").startswith(JAX_PKG.name)):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def port_module_name(rel: str) -> str:
    parts = pathlib.PurePosixPath(COUNTERPART.get(rel, rel)).with_suffix(
        "").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join((PORT,) + parts)


def port_path(rel: str) -> pathlib.Path:
    return ROOT / PORT / COUNTERPART.get(rel, rel)


def test_the_scan_sees_the_jax_package():
    mods = jax_modules()
    assert len(mods) > 60 and "sample/guided.py" in mods
    assert {"make_guided_sampler", "make_guided_sampler_p"} <= public_names(
        "sample/guided.py")
    assert "set_seed" in public_names("__init__.py")
    assert "jax" not in public_names("flow/cfm.py")


@pytest.mark.parametrize("rel", jax_modules())
def test_every_public_name_is_ported_or_listed(rel):
    names = public_names(rel)
    if (rel, "*") in NOT_PORTED:
        assert not port_path(rel).exists(), (
            f"{rel} is listed as not ported, but the port has "
            f"{port_path(rel)}")
        return
    assert port_path(rel).exists(), f"no port module for {rel}"
    mod = importlib.import_module(port_module_name(rel))
    missing = sorted(n for n in names if not hasattr(mod, n)
                     and (rel, n) not in NOT_PORTED)
    assert not missing, f"{rel}: not in {mod.__name__} nor NOT_PORTED: " \
                        f"{missing}"
    stale = sorted(n for (r, n) in NOT_PORTED if r == rel and n != "*"
                   and (n not in names or hasattr(mod, n)))
    assert not stale, f"{rel}: NOT_PORTED entries that are stale: {stale}"


def test_not_ported_names_only_jax_modules():
    mods = set(jax_modules())
    assert {r for r, _ in NOT_PORTED} <= mods
    assert all(reason for reason in NOT_PORTED.values())
