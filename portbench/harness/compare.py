"""The numbers that decide `correct`, each against its limit.

* `row_gap`: for a step x_k -> x_{k+1}, the widest row's
  ||x_{k+1} - ref_{k+1}|| / ||ref_{k+1} - x_k||: the error of the step's
  update relative to the update itself, per row (answer).
* `leaf_gap`: over the leaves of a training state, the worst (or the
  median) | ||a|| - ||b|| | / max(||b||, median leaf's ||b||): the gap
  between the program's norm and the reference's, not the norm of their
  difference, because Adam moves an element with a gradient near zero by
  ±lr on rounding alone.
* `rel_gap`: |a - b| / |b| of scalars.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch


def row_gap(prog: torch.Tensor, ref: torch.Tensor,
            prev: torch.Tensor) -> float:
    p = prog.reshape(prog.shape[0], -1).to(torch.float64)
    r = ref.reshape(ref.shape[0], -1).to(torch.float64)
    x = prev.reshape(prev.shape[0], -1).to(torch.float64)
    num = torch.linalg.vector_norm(p - r, dim=1)
    den = torch.linalg.vector_norm(r - x, dim=1).clamp_min(1e-30)
    return float((num / den).max())


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64)))
            for k, v in tensors.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Optional[Iterable[str]] = None, stat: str = "worst"):
    """(the worst leaf's gap, or the median leaf's with stat="median";
    detail {worst, worst_leaf, median})."""
    keys = list(ref if keys is None else keys)
    if not keys:
        return 0.0, {}
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    gaps = {}
    for k in keys:
        a = prog.get(k, math.nan)
        gaps[k] = (abs(a - ref[k]) / max(ref[k], med, 1e-30)
                   if math.isfinite(a) else math.inf)
    worst = max(gaps, key=gaps.get)
    median = sorted(gaps.values())[len(gaps) // 2]
    detail = {"worst": gaps[worst], "worst_leaf": worst, "median": median}
    return (median if stat == "median" else gaps[worst]), detail


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def moving_leaves(grad_norms: Dict[str, float], share: float = 1e-3
                  ) -> List[str]:
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    vals = sorted(grad_norms.values())
    med = vals[len(vals) // 2]
    return [k for k, v in grad_norms.items() if v >= share * med]


def reading(name: str, value: float, limit: float,
            detail: Optional[dict] = None) -> dict:
    out = {"name": name, "value": value, "limit": limit}
    if detail:
        out["detail"] = detail
    return out


def verdict(readings: List[dict]) -> bool:
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
               for r in readings)
