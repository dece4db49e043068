"""mc_feng guidance kernel (port of ops/guidance_pallas.py:flash_guidance).

The normalised importance weights of Feng et al. Alg. 2 reduce exactly to
a softmax over the MC set (see the JAX module's docstring):

    w_i = softmax_i(log r_i - (|x_t - t X1_i|^2 + |y_t - t Y1_i|^2) / 2σ²),
    σ = 1 - t + 1e-3,

and the guidance term is g = (Σ_i w_i X1_i - x_t)/σ (likewise for y).
`flash_guidance` returns (g_x, g_y, ess, l): ESS = l²/q of the weights and
the softmax normaliser l (the largest weight is 1/l).

On a CUDA tensor the wrapper launches the hand-written kernels in
csrc/flash_guidance.cu: a float64 score kernel on the FP64 tensor cores
whose split over the feature axis is reduced inside a thread-block cluster,
and a float32 weighted-sum kernel that forms the softmax weights on the
fly. The float64 scores S [B, N], with the softmax partials of every 32
columns behind them, are the only workspace; the launch plan
(`guidance_plan`) is pure Python. Both versions leave the row constant
|x_t|² + |y_t|² out of the scores (`scores_reference`): it cancels in the
softmax.
On a CPU tensor it runs `flash_guidance_reference`, the plain PyTorch
version of the same function. Any other device raises.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops._capi import (
    FLOAT,
    INT,
    PTR,
    Kernel,
    bind,
    counters,
    device_index,
    error_string,
)

EPS_T = 1e-3  # sigma floor, matches ref flow_utils.py:279

# Mirrors of the constants of csrc/flash_guidance.cu
THREADS = 256
BK = 32                  # reduction depth of a shared-memory stage (kBK)
LD = BK + 4              # row stride of a row-major stage, floats (kLd)
STAGES = 4               # ring depth (kStages)
BM1, BN1 = 64, 128       # score tile: trajectories b x MC rows n
BM2, BD2 = 64, 128       # weighted-sum tile: trajectories b x features d
SMEM_MAX = 232_448       # dynamic shared memory one block can use
MAX_CLUSTER = 8          # largest portable cluster
# Clusters of 1..8 score-kernel CTAs that the card holds at once, as
# cudaOccupancyMaxActiveClusters reported them on an NVIDIA H100 80GB HBM3
# (its GPCs do not all hold two clusters of 7 or 8). The wrapper asks the
# card it runs on.
CAPACITY = (132, 66, 39, 30, 22, 17, 15, 15)


def _scalars(t: float):
    """(t, σ, 1/(2σ²), 1/σ) rounded to float32 as the reference computes
    them (the JAX kernel's scalars are float32 values)."""
    t32 = np.float32(t)
    sigma = np.float32(1.0) - t32 + np.float32(EPS_T)
    return (t32, sigma, np.float32(0.5) / (sigma * sigma),
            np.float32(1.0) / sigma)


def scores_reference(x_t, y_t, mc_x1, mc_y1, mc_log_r, t: float,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The scores S [B, N] = log r - (t²|v_n|² - 2t <a_b, v_n>)/(2σ²) of the
    plain version, all in `dtype` with the float32 scalars: |a_b - t v_n|²
    without the row constant |a_b|², which cancels in the softmax (see the
    kernel's note). float64 is the exact yardstick of the score kernel."""
    B, N = x_t.shape[0], mc_x1.shape[0]
    xt = x_t.reshape(B, -1).to(dtype)
    yt = y_t.reshape(B, -1).to(dtype)
    X1 = mc_x1.reshape(N, -1).to(dtype)
    Y1 = mc_y1.reshape(N, -1).to(dtype)
    lr = mc_log_r.to(dtype)
    t32, _, inv_2s2, _ = _scalars(t)
    X12 = (X1 * X1).sum(1)[None, :]
    Y12 = (Y1 * Y1).sum(1)[None, :]
    cross = torch.matmul(xt, X1.T) + torch.matmul(yt, Y1.T)       # [B, N]
    sq = (float(t32 * t32) * (X12 + Y12)
          - float(np.float32(2.0) * t32) * cross)
    return lr[None, :] - sq * float(inv_2s2)


def flash_guidance_reference(x_t, y_t, mc_x1, mc_y1, mc_log_r, t: float,
                             dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the kernel: softmax form, torch.matmul for
    both products. Same signature and outputs. `dtype` is the working type:
    float32 is the function; float64 (same float32 scalars, outputs in
    float64) is the accuracy yardstick of the tests and chip_smoke.py."""
    B, N = x_t.shape[0], mc_x1.shape[0]
    xt = x_t.reshape(B, -1).to(dtype)
    yt = y_t.reshape(B, -1).to(dtype)
    X1 = mc_x1.reshape(N, -1).to(dtype)
    Y1 = mc_y1.reshape(N, -1).to(dtype)
    inv_sigma = _scalars(t)[3]
    s = scores_reference(x_t, y_t, mc_x1, mc_y1, mc_log_r, t, dtype)
    e = torch.exp(s - s.max(dim=1, keepdim=True).values)
    l = e.sum(1, keepdim=True)
    q = (e * e).sum(1, keepdim=True)
    w = e * (1.0 / (l + 1e-30))
    g_x = (torch.matmul(w, X1) - xt) * float(inv_sigma)
    g_y = (torch.matmul(w, Y1) - yt) * float(inv_sigma)
    ess = (l * l) / (q + 1e-30)
    return (g_x.reshape(x_t.shape), g_y.reshape(y_t.shape), ess[:, 0],
            l[:, 0])


_GUIDANCE = Kernel("flash_guidance", "flash_guidance",
                   [PTR] * 5 + [INT] * 4 + [FLOAT] + [INT] * 4 + [PTR] * 5)


def last_error() -> str:
    """cudaGetLastError of the kernels' library (which clears it), as
    'code (name)'."""
    err = bind("flash_guidance", "last_error", [])()
    return f"{err} ({error_string('flash_guidance', err)})"


def max_active_clusters(cluster: int, aligned: bool, index: int = 0) -> int:
    """Clusters of `cluster` score-kernel CTAs that card `index` holds at
    once (cudaOccupancyMaxActiveClusters); builds the kernel if needed."""
    n = bind("flash_guidance", "flash_guidance_max_clusters", [INT] * 3)(
        cluster, int(aligned), index)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {-n}")
    return n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GuidancePlan:
    """Launch plan of both kernels (see csrc/flash_guidance.cu)."""
    aligned: bool        # 16-byte cp.async loader, else the generic one
    k_stages: int        # ceil(D / BK) stages of the feature axis
    cluster: int         # CTAs that split those stages for one score tile
    tiles_b1: int        # score tiles along b (BM1 rows) ...
    tiles_n1: int        # ... and along n (BN1 columns)
    grid1: int
    smem1: int           # bytes
    tiles_b2: int        # weighted-sum tiles along b (BM2 rows) ...
    tiles_d2: int        # ... and along d (BD2 features)
    grid2: int
    smem2: int           # bytes
    stages: int = STAGES
    threads: int = THREADS


@functools.lru_cache(maxsize=256)
def guidance_plan(B: int, N: int, Dx: int, Dy: int, aligned_ptrs: bool = True,
                  capacity: Tuple[int, ...] = CAPACITY) -> GuidancePlan:
    """Plan for x_t|y_t [B, Dx|Dy] against X1|Y1 [N, Dx|Dy].

    The aligned loader needs every row of the four inputs (and of g_x, g_y)
    to start on a 16-byte boundary: Dx and Dy multiples of 4 and aligned
    base pointers (`aligned_ptrs`). The score kernel's cluster size K
    (at most 8, at most one rank per stage) is the one with the fewest
    stages in sequence, waves x ceil(stages / K), where a wave is the
    `capacity[K - 1]` clusters of K CTAs that the card holds at once; the
    smaller K wins a tie. The weighted sum takes BM2 x BD2 tiles, two CTAs
    to an SM: 256 CTAs at D = 4096 and 104 at D = 1568 (B = 512)."""
    if min(B, N, Dx, Dy) < 1:
        raise ValueError(f"guidance_plan: empty shape {(B, N, Dx, Dy)}")
    D = Dx + Dy
    aligned = bool(aligned_ptrs) and Dx % 4 == 0 and Dy % 4 == 0
    k_stages = _cdiv(D, BK)
    tiles_b1, tiles_n1 = _cdiv(B, BM1), _cdiv(N, BN1)
    tiles1 = tiles_b1 * tiles_n1
    cluster = min(
        range(1, min(MAX_CLUSTER, k_stages, len(capacity)) + 1),
        key=lambda k: (_cdiv(tiles1, max(1, capacity[k - 1]))
                       * _cdiv(k_stages, k), k))
    smem1 = 4 * (STAGES * (BM1 + BN1) * LD + 3 * BN1)
    tiles_b2, tiles_d2 = _cdiv(B, BM2), _cdiv(D, BD2)
    smem2 = 4 * (STAGES * BK * BD2 + 2 * BM2 * LD + 3 * BM2)
    assert max(smem1, smem2) <= SMEM_MAX
    return GuidancePlan(aligned, k_stages, cluster, tiles_b1, tiles_n1,
                        cluster * tiles1, smem1, tiles_b2, tiles_d2,
                        tiles_b2 * tiles_d2, smem2)


def workspace_floats(B: int, N: int) -> int:
    """Floats of the one workspace: the float64 scores S [B, N], then the
    softmax partials of every 32 columns, the maxima in float64
    [B, ceil(N/32)] and the sums e and e² in float32 [2, B, ceil(N/32)]."""
    return 2 * B * N + 4 * B * _cdiv(N, 32)


def score_slices(plan: GuidancePlan, D: int) -> List[Tuple[int, int]]:
    """[k_lo, k_hi) of the feature axis that each cluster rank multiplies
    over, as the score kernel computes it."""
    K, T = plan.cluster, plan.k_stages
    return [(r * T // K * BK, min(D, (r + 1) * T // K * BK))
            for r in range(K)]


def score_tiles(plan: GuidancePlan, B: int,
                N: int) -> Iterator[Tuple[int, range, range]]:
    """(first CTA, rows b, columns n) of every score tile; the tile's CTAs
    are first CTA + rank."""
    for tile in range(plan.tiles_b1 * plan.tiles_n1):
        n0 = tile % plan.tiles_n1 * BN1
        b0 = tile // plan.tiles_n1 * BM1
        yield (tile * plan.cluster, range(b0, min(B, b0 + BM1)),
               range(n0, min(N, n0 + BN1)))


def sum_tiles(plan: GuidancePlan, B: int,
              D: int) -> Iterator[Tuple[int, range, range]]:
    """(CTA, rows b, features d) of every weighted-sum tile."""
    for cta in range(plan.grid2):
        d0 = cta % plan.tiles_d2 * BD2
        b0 = cta // plan.tiles_d2 * BM2
        yield (cta, range(b0, min(B, b0 + BM2)), range(d0, min(D, d0 + BD2)))


@functools.lru_cache(maxsize=None)
def card_capacity(index: int) -> Tuple[int, ...]:
    """Clusters of 1..8 score-kernel CTAs that a card holds at once."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (sms,) + tuple(max_active_clusters(k, True, index)
                          for k in range(2, MAX_CLUSTER + 1))


def _launch(xt, yt, X1, Y1, lr, t: float, cluster: int = 0):
    """Both kernels on [B, D] rows; `cluster` > 0 forces the score kernel's
    cluster size in place of the plan's (for checks of every size on one
    card), else the plan picks it from the card's capacity. Returns
    (g_x, g_y, ess, l, workspace, plan)."""
    B, Dx = xt.shape
    N, Dy = Y1.shape
    dev = xt.device
    f32 = torch.float32
    capacity = card_capacity(device_index(dev))
    ws = torch.empty((workspace_floats(B, N),), dtype=f32, device=dev)
    gx = torch.empty_like(xt)
    gy = torch.empty_like(yt)
    ess = torch.empty((B,), dtype=f32, device=dev)
    l = torch.empty((B,), dtype=f32, device=dev)
    ptrs = [a.data_ptr() for a in (xt, yt, X1, Y1, lr, ws, gx, gy, ess, l)]
    # the rows the 16-byte loader and the vector stores touch
    aligned = all(p % 16 == 0 for p in ptrs[:4] + ptrs[5:8])
    plan = guidance_plan(B, N, Dx, Dy, aligned, capacity)
    if cluster:
        plan = dataclasses.replace(
            plan, cluster=cluster,
            grid1=cluster * plan.tiles_b1 * plan.tiles_n1)
    _GUIDANCE(*ptrs[:5], B, N, Dx, Dy, float(np.float32(t)), plan.cluster,
              int(plan.aligned), plan.smem1, plan.smem2, *ptrs[5:], on=xt,
              plan=plan, counter=(flash_guidance, "launches"))
    return gx, gy, ess, l, ws, plan


def flash_guidance(x_t: torch.Tensor, y_t: torch.Tensor,
                   mc_x1: torch.Tensor, mc_y1: torch.Tensor,
                   mc_log_r: torch.Tensor, t: float):
    """Fused mc_feng guidance (g_x, g_y, ess[B], l[B]).

    x_t [B, ...], y_t [B, ...], mc_x1 [N, ...], mc_y1 [N, ...] and
    mc_log_r [N] are contiguous float32 tensors on one device; t is a
    Python float. CUDA tensors go to the kernel, CPU tensors to
    `flash_guidance_reference`; anything else raises.
    """
    return _checked_call(x_t, y_t, mc_x1, mc_y1, mc_log_r, t)


def flash_guidance_scores(x_t, y_t, mc_x1, mc_y1, mc_log_r, t: float,
                          cluster: int = 0):
    """Test hook: one call of `flash_guidance` that also returns the float64
    scores S [B, N] kernel 2 read, and the plan (None on the CPU), as
    ((g_x, g_y, ess, l), S, plan). On a CUDA tensor S is the score kernel's
    output (the head of the workspace); on a CPU tensor the plain version's
    float32 scores (`scores_reference`) in float64. `cluster` > 0 forces
    the score kernel's cluster size. The samplers never call it."""
    return _checked_call(x_t, y_t, mc_x1, mc_y1, mc_log_r, t, cluster,
                         scores=True)


def _checked_call(x_t, y_t, mc_x1, mc_y1, mc_log_r, t, cluster=0,
                  scores=False):
    tensors = (x_t, y_t, mc_x1, mc_y1, mc_log_r)
    dev = x_t.device
    for name, a in zip(("x_t", "y_t", "mc_x1", "mc_y1", "mc_log_r"), tensors):
        if a.dtype != torch.float32:
            raise TypeError(f"flash_guidance: {name} must be float32, "
                            f"got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"flash_guidance: {name} is on {a.device}, "
                             f"x_t on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"flash_guidance: {name} must be contiguous")
    B, N = x_t.shape[0], mc_x1.shape[0]
    if (y_t.shape[0] != B or mc_y1.shape[0] != N
            or tuple(mc_log_r.shape) != (N,)
            or x_t.shape[1:] != mc_x1.shape[1:]
            or y_t.shape[1:] != mc_y1.shape[1:] or B == 0 or N == 0):
        raise ValueError(
            "flash_guidance: shapes do not agree: x_t "
            f"{tuple(x_t.shape)}, y_t {tuple(y_t.shape)}, mc_x1 "
            f"{tuple(mc_x1.shape)}, mc_y1 {tuple(mc_y1.shape)}, mc_log_r "
            f"{tuple(mc_log_r.shape)}")
    if dev.type == "cpu":
        out = flash_guidance_reference(*tensors, t)
        if not scores:
            return out
        return out, scores_reference(*tensors, t).double(), None
    if dev.type != "cuda":
        raise ValueError(f"flash_guidance: unsupported device {dev}")
    gx, gy, ess, l, ws, plan = _launch(
        x_t.reshape(B, -1), y_t.reshape(B, -1), mc_x1.reshape(N, -1),
        mc_y1.reshape(N, -1), mc_log_r, t, cluster)
    out = (gx.reshape(x_t.shape), gy.reshape(y_t.shape), ess, l)
    if not scores:
        return out
    return out, ws[:2 * B * N].view(torch.float64).view(B, N), plan


counters(flash_guidance, "launches")


# ---- yardsticks that a correct kernel meets by construction --------------
#
# No float32 version holds g within twice another's error against float64
# on every draw: near-tied weights amplify the scores' rounding, and which
# version rounds a near tie the other way is a matter of the draw. So the
# two kernels are also held separately, each to what its own arithmetic
# allows, every float32 rounding counted at u = 2^-24, expf at CUDA's
# documented 2 ulp (4u relative), to first order and then widened by 1% for
# the terms of order u².

U32 = 2.0 ** -24


def _gamma(n: int, u: float = U32) -> float:
    return n * u / (1.0 - n * u)


def score_chains(plan: "GuidancePlan | None", D: int) -> Tuple[int, int]:
    """Float32 roundings of the scores: (the longest chain of <a_b, v_n> and
    of |v_n|², the roundings after them). None in the score kernel (`plan`
    given), whose products and sums are float64; in the plain version (no
    plan: cuBLAS or the CPU, float32) any order of D terms, then five: the
    two scalar products, their difference, the product by 1/(2σ²) and the
    difference from log r."""
    return (0, 0) if plan is not None else (D, 5)


def score_error_bound(x_t, y_t, mc_x1, mc_y1, mc_log_r, t: float,
                      chains: Tuple[int, int]) -> torch.Tensor:
    """float64 [B, N] a-priori bound on |Ŝ - S| for scores Ŝ made as
    `scores_reference` makes them, with the float32 roundings `chains`
    = (L, F) (`score_chains`). With c_v = t²/(2σ²), c_x = 2t/(2σ²) (float32
    scalars) and the terms of S, T = |log r| + c_v |v_n|² +
    c_x Σ|a_k v_nk|:

        γ_L (c_x Σ|a_k v_nk| + c_v |v_n|²) + γ_F T + γ64(2D + 64) T,

    the float32 roundings at u = 2^-24 and every float64 step of either
    side (the kernel's and the float64 yardstick's, fewer than 2D + 64 on
    any term) at 2^-53; widened by 1% for the terms of order u²."""
    B, N = x_t.shape[0], mc_x1.shape[0]
    f64 = torch.float64
    A = torch.cat([x_t.reshape(B, -1), y_t.reshape(B, -1)], 1).to(f64)
    V = torch.cat([mc_x1.reshape(N, -1), mc_y1.reshape(N, -1)], 1).to(f64)
    t32, _, inv_2s2, _ = _scalars(t)
    c_v = float(t32 * t32) * float(inv_2s2)
    c_x = float(np.float32(2.0) * t32) * float(inv_2s2)
    v2 = (V * V).sum(1)[None, :]
    cross = c_x * (A.abs() @ V.abs().T)
    terms = mc_log_r.to(f64).abs()[None, :] + c_v * v2 + cross
    L, F = chains
    D = A.shape[1]
    return 1.01 * (_gamma(L) * (cross + c_v * v2)
                   + (_gamma(F) + _gamma(2 * D + 64, 2.0 ** -53)) * terms)


def weighted_sum_reference(S, x_t, y_t, mc_x1, mc_y1, t: float):
    """Kernel 2's function of the scores S [B, N], in float64:
    ((g_x, g_y, ess, l), (tol_g_x, tol_g_y, rtol_ess, rtol_l)), the
    tolerances being what kernel 2's float32 rounding allows (N <= 1024:
    one partial of 32 columns a lane). With d_n = S_n - max S <= 0,
    e_n = exp(d_n), l = Σe, q = Σe², w = e / l, u = 2^-24:

    * l̂: each term passes s - max (kernel 1's 32-column max, then the
      row's: u|d_n| in all), two expf (8u), kernel 1's 5-level warp sum,
      the rescale product and kernel 2's 5-level sum: ε_l = 19u + u A,
      A = Σ e_n |d_n| / l; q̂ likewise with every factor squared:
      ε_q = 29u + 2u Σ e_n² |d_n| / q. ESS = l²/(q + 1e-30): 2ε_l + ε_q + 3u.
    * ŵ_n = expf(S_n - m) · rcp(l̂ + 1e-30): |η_n| <= u|d_n| + 5u + ε_l + 2u.
    * ĝ = (Σ_n ŵ_n V_n - a) / σ with the sum one FMA chain over N (γ_N)
      and two roundings after it: |ĝ - g| <= (1/σ) Σ_n w_n |V_n|
      (|η_n| + γ_N) + 2u|g|.
    * Below float32's normal range (2^-126) a weight, a product or the
      difference may round to a denormal or to zero (on the CPU, flushed):
      (1/σ) 2^-126 (Σ_n |V_n| + 4) more, and N 2^-126 more in ε_l, ε_q
      (l, q >= 1).
    """
    B, N = S.shape
    if N > 1024:
        raise ValueError("weighted_sum_reference: the tolerance assumes "
                         f"N <= 1024, got {N}")
    f64 = torch.float64
    Dx = x_t[0].numel()
    A = torch.cat([x_t.reshape(B, -1), y_t.reshape(B, -1)], 1).to(f64)
    V = torch.cat([mc_x1.reshape(N, -1), mc_y1.reshape(N, -1)], 1).to(f64)
    inv_sigma = float(_scalars(t)[3])
    S = S.to(f64)
    d = S - S.max(1, keepdim=True).values
    e = torch.exp(d)
    l = e.sum(1)
    q = (e * e).sum(1)
    w = e / l[:, None]
    g = (w @ V - A) * inv_sigma
    u, tiny = U32, 2.0 ** -126
    eps_l = 19 * u + u * (e * -d).sum(1) / l + N * tiny
    eps_q = 29 * u + 2 * u * (e * e * -d).sum(1) / q + N * tiny
    eta = u * -d + (7 * u + eps_l)[:, None] + _gamma(N)
    tol_g = 1.01 * inv_sigma * ((w * eta) @ V.abs() + tiny * (
        V.abs().sum(0)[None, :] + 4)) + 2.02 * u * g.abs()
    out = (g[:, :Dx].reshape(x_t.shape), g[:, Dx:].reshape(y_t.shape),
           l * l / q, l)
    tol = (tol_g[:, :Dx].reshape(x_t.shape), tol_g[:, Dx:].reshape(y_t.shape),
           1.01 * (2 * eps_l + eps_q + 3 * u), 1.01 * eps_l)
    return out, tol


def bound_ratios(inputs, t: float, cluster: int = 0) -> dict:
    """One `flash_guidance_scores` call held to both bounds: {"S": max of
    |Ŝ - S_float64| / score_error_bound, "g": max |ĝ - g| / tol over g_x and
    g_y, "ess", "l": max relative error / rtol} against
    `weighted_sum_reference` of the same S. Each is <= 1 for a
    correct kernel on any input; also returns the outputs and S."""
    x_t, y_t, mc_x1, mc_y1, mc_log_r = inputs
    out, S, plan = flash_guidance_scores(*inputs, t, cluster)
    D = x_t[0].numel() + y_t[0].numel()
    def worst(err, tol):
        # an exact entry passes at any tolerance, 0 included
        return float(torch.where(err == 0, 0.0, err / tol).max())

    exact_s = scores_reference(*inputs, t, torch.float64)
    bound = score_error_bound(*inputs, t, score_chains(plan, D))
    ratios = {"S": worst((S - exact_s).abs(), bound)}
    ref, tol = weighted_sum_reference(S, x_t, y_t, mc_x1, mc_y1, t)
    ratios["g"] = max(worst((out[i].double() - ref[i]).abs(), tol[i])
                      for i in (0, 1))
    for i, nm in ((2, "ess"), (3, "l")):
        ratios[nm] = worst((out[i].double() - ref[i]).abs(),
                           tol[i] * ref[i].abs())
    return dict(ratios=ratios, out=out, S=S, plan=plan)
