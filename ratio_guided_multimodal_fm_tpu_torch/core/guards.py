"""Optional NaN/Inf guards (port of core/guards.py).

Enabled with RGMF_NAN_CHECKS=1, as in the JAX package. Off by default:
a check reads a flag back from the device, which synchronises the stream.
"""
from __future__ import annotations

import os

import torch


def nan_checks_enabled() -> bool:
    return os.environ.get("RGMF_NAN_CHECKS", "0").lower() not in (
        "0", "", "false")


def check_finite(x: torch.Tensor, name: str) -> None:
    """Raise FloatingPointError if `x` holds NaN/Inf (only when enabled)."""
    if not nan_checks_enabled():
        return
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            f"non-finite values detected in '{name}' (RGMF_NAN_CHECKS=1)")
