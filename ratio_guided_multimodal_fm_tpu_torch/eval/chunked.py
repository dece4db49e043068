"""Chunked sampling with a fresh MC set per chunk, the evaluate CLIs'
default (port of eval/chunked.py; the JAX module explains why the policy is
unconditional: the number of MC candidates each trajectory chooses from
controls the guided quality of a saturated ratio net, and the reference
regenerates its MC set in every sampling call).

Seeding: JAX's fold_in(key, ci) becomes a `torch.Generator` per chunk,
seeded from the run's seed and the chunk index, `chunk_seed(seed, ci)`;
the chunk's MC set draws from its own generator, `chunk_seed(seed, ci, 7)`
(JAX: fold_in(chunk_key, 7)). One chunk is chunk 0. The seeds come from
numpy's SeedSequence, so the streams of two chunks, or of a chunk and its
MC set, do not overlap.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed

DEFAULT_AUTO_CHUNKS = 4


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# A 63-bit seed derived from the run's seed and `path` (chunk index, then 7
# for the chunk's MC set).
chunk_seed = derive_seed


def mc_set_ess(mc_ratios) -> float:
    """ESS of the normalised ratio weights over the MC set (N for a flat
    ratio net, → 1 for a saturated one), in float64 on the host."""
    r = _np(mc_ratios).astype(np.float64)
    r = np.maximum(r, 0.0)
    s = r.sum()
    if not np.isfinite(s) or s <= 0.0:
        return 1.0
    w = r / s
    return float(1.0 / np.maximum((w * w).sum(), 1e-300))


def resolve_chunk_policy(
    eval_chunks,                      # "auto" | int | None
    has_mc_set: bool,
    auto_chunks: int = DEFAULT_AUTO_CHUNKS,
    no_mc_reason: str = "no MC set (method has no candidate pool)",
) -> Tuple[int, str]:
    """(n_chunks, reason): `eval_chunks` "auto" or None (a fresh MC set per
    chunk whenever the method uses one), or an int (forced). `no_mc_reason`
    labels the one-chunk decision of a method without an MC set."""
    if eval_chunks is not None and eval_chunks != "auto":
        n = max(1, int(eval_chunks))
        return n, f"forced (--eval_chunks {eval_chunks})"
    if not has_mc_set:
        return 1, no_mc_reason
    return (max(1, auto_chunks),
            "default: fresh MC candidates per chunk (candidates-per-"
            "trajectory controls guided quality; reference protocol — "
            "ROUND2.md, chunk_trigger_calibration.json)")


def _merge_diags(chunk_diags: list) -> dict:
    """Merge per-chunk diagnostics (dicts of [T] or [T, B] arrays) into one
    covering all samples: [T, B] arrays concatenate on the batch axis;
    per-step scalars by max / min for *_max / *_min keys and by unweighted
    mean otherwise (chunk sizes differ by at most 1). numpy out."""
    chunk_diags = [d for d in chunk_diags if d]
    if not chunk_diags:
        return {}
    out = {}
    for k in chunk_diags[0]:
        vs = [_np(d[k]) for d in chunk_diags]
        if vs[0].ndim >= 2:
            out[k] = np.concatenate(vs, axis=1)
        elif k.endswith("_max"):
            out[k] = np.max(vs, axis=0)
        elif k.endswith("_min"):
            out[k] = np.min(vs, axis=0)
        else:
            out[k] = np.mean(vs, axis=0)
    return out


def sample_in_chunks(
    sample_fn: Callable,     # (generator, n, mc_set) -> (x, y, diags)
    make_mc_set: Optional[Callable],  # (generator) -> mc_set, or None
    num_samples: int,
    seed: int,
    device,
    eval_chunks="auto",
    auto_chunks: int = DEFAULT_AUTO_CHUNKS,
    mc_cache: Optional[dict] = None,
    log_fn: Callable = print,
    no_mc_reason: str = "no MC set (method has no candidate pool)",
) -> Tuple[torch.Tensor, torch.Tensor, dict, Dict]:
    """Chunked sampling with a fresh MC set per chunk (the default policy),
    generators seeded as the module docstring says.

    Returns (samples_x, samples_y, merged_diags, info): info records the
    policy decision, the per-chunk MC-set ESS and the ESS summaries.
    `mc_cache` keeps the MC sets across calls (an evaluation sweep reuses
    them across guidance strengths, which they do not depend on), keyed by
    chunk index, or "single" for one chunk.
    """
    mc_cache = {} if mc_cache is None else mc_cache
    info: Dict = {}

    n_chunks, reason = resolve_chunk_policy(
        eval_chunks, make_mc_set is not None, auto_chunks,
        no_mc_reason=no_mc_reason)
    n_chunks = min(n_chunks, max(1, num_samples))
    info["n_chunks"] = n_chunks
    info["chunk_policy"] = reason
    log_fn(f"  [chunks] {reason} -> {n_chunks} chunk(s)")

    def generator(*path):
        return torch.Generator(device).manual_seed(chunk_seed(seed, *path))

    base, extra = divmod(num_samples, n_chunks)
    xs, ys, diags_per_chunk, ess_list = [], [], [], []
    for ci in range(n_chunks):
        n_i = base + (1 if ci < extra else 0)
        if n_i == 0:
            continue
        mc_ci = None
        if make_mc_set is not None:
            slot = "single" if n_chunks == 1 else ci
            if slot not in mc_cache:
                mc_cache[slot] = make_mc_set(generator(ci, 7))
            mc_ci = mc_cache[slot]
            ess_list.append(mc_set_ess(mc_ci[2]))
        sx, sy, d = sample_fn(generator(ci), n_i, mc_ci)
        xs.append(sx)
        ys.append(sy)
        diags_per_chunk.append(d)

    samples_x = torch.cat(xs) if len(xs) > 1 else xs[0]
    samples_y = torch.cat(ys) if len(ys) > 1 else ys[0]
    merged = _merge_diags(diags_per_chunk)

    if ess_list:
        info["mc_set_ess"] = [round(e, 3) for e in ess_list]
    if "ess" in merged:
        ess = merged["ess"]            # [T, num_samples], all chunks
        # step 0 is excluded: the guidance gate (t > EPS_T) is closed there
        # and its ESS is a constant N
        traj = ess[1:] if ess.shape[0] > 1 else ess
        info["ess_final_mean"] = float(ess[-1].mean())
        info["ess_final_min"] = float(ess[-1].min())
        info["ess_trajectory_min"] = float(traj.min())
        info["ess_trajectory_mean"] = float(traj.mean())
    return samples_x, samples_y, merged, info
