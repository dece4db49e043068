"""Mixed-precision policy (port of core/dtypes.py).

Params stay float32; model activations run in the compute dtype (float32
or bfloat16, each module's `dtype`); the time embedding, normalisation
statistics, the sampler state and the guidance-weight math are float32.
"""
from __future__ import annotations

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def dtype_from_name(name: str) -> torch.dtype:
    """'f32' | 'bf16' -> torch dtype (the CLIs' --dtype values)."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]
