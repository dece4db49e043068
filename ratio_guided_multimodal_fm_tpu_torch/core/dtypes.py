"""Mixed-precision policy (port of core/dtypes.py).

Params stay float32; model activations run in the compute dtype (float32
or bfloat16, each module's `dtype`); the time embedding, normalisation
statistics, the sampler state and the guidance-weight math are float32.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def dtype_from_name(name: str) -> torch.dtype:
    """'f32' | 'bf16' -> torch dtype (the CLIs' --dtype values)."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # dtype of the guidance-weight math and the loss reductions: float32
    reduce_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating tensors of a tree of dicts (state dicts included),
    lists and tuples to `dtype`; integer and bool tensors and every other
    leaf are returned as they are. Containers keep their type."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floating(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree
