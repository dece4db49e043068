"""mc_feng guidance kernel (port of ops/guidance_pallas.py:flash_guidance).

The normalised importance weights of Feng et al. Alg. 2 reduce exactly to
a softmax over the MC set (see the JAX module's docstring):

    w_i = softmax_i(log r_i - (|x_t - t X1_i|^2 + |y_t - t Y1_i|^2) / 2σ²),
    σ = 1 - t + 1e-3,

and the guidance term is g = (Σ_i w_i X1_i - x_t)/σ (likewise for y).
`flash_guidance` returns (g_x, g_y, ess, l): ESS = l²/q of the weights and
the softmax normaliser l (the largest weight is 1/l).

On a CUDA tensor the wrapper launches the hand-written kernels in
csrc/flash_guidance.cu, all IEEE float32: a score kernel whose split over the
feature axis is reduced inside a thread-block cluster, and a weighted-sum
kernel that forms the softmax weights on the fly. The scores S [B, N], with
the softmax partials of every 32 columns behind them, are the only
workspace; the launch plan (`guidance_plan`) is pure Python.
Both versions leave the row constant |x_t|² + |y_t|² out of the scores: it
cancels in the softmax, and at the main-path width (D = 4096) its float32
rounding alone would move the scores by ~1e-4.
On a CPU tensor it runs `flash_guidance_reference`, the plain PyTorch
version of the same function. Any other device raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops import _build

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
    lr = mc_log_r.to(dtype)
    t32, _, inv_2s2, inv_sigma = _scalars(t)

    # |x_t - t X1_n|² + |y_t - t Y1_n|² without the row constant
    # |x_t|² + |y_t|², which cancels in the softmax (see the kernel's note)
    X12 = (X1 * X1).sum(1)[None, :]
    Y12 = (Y1 * Y1).sum(1)[None, :]
    cross = torch.matmul(xt, X1.T) + torch.matmul(yt, Y1.T)       # [B, N]
    sq = (float(t32 * t32) * (X12 + Y12)
          - float(np.float32(2.0) * t32) * cross)
    s = lr[None, :] - sq * float(inv_2s2)
    e = torch.exp(s - s.max(dim=1, keepdim=True).values)
    l = e.sum(1, keepdim=True)
    q = (e * e).sum(1, keepdim=True)
    w = e * (1.0 / (l + 1e-30))
    g_x = (torch.matmul(w, X1) - xt) * float(inv_sigma)
    g_y = (torch.matmul(w, Y1) - yt) * float(inv_sigma)
    ess = (l * l) / (q + 1e-30)
    return (g_x.reshape(x_t.shape), g_y.reshape(y_t.shape), ess[:, 0],
            l[:, 0])


_c_fn = None


def _kernel_fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.load("flash_guidance")
        fn = lib.rgmf_flash_guidance
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 5 + [i] * 4 + [ctypes.c_float] + [i] * 4
                       + [p] * 5 + [i, p])
        fn.restype = i
        lib.rgmf_flash_guidance_max_clusters.argtypes = [i, i, i]
        lib.rgmf_flash_guidance_max_clusters.restype = i
        lib.rgmf_last_error.argtypes = []
        lib.rgmf_last_error.restype = i
        lib.rgmf_cuda_error_string.argtypes = [i]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fn = (fn, lib.rgmf_cuda_error_string)
    return _c_fn


def last_error() -> str:
    """cudaGetLastError of the kernels' library (which clears it), as
    'code (name)'."""
    _kernel_fn()
    lib = _build.load("flash_guidance")
    err = lib.rgmf_last_error()
    return f"{err} ({lib.rgmf_cuda_error_string(err).decode()})"


def max_active_clusters(cluster: int, aligned: bool, index: int = 0) -> int:
    """Clusters of `cluster` score-kernel CTAs that card `index` holds at
    once (cudaOccupancyMaxActiveClusters); builds the kernel if needed."""
    _kernel_fn()
    n = _build.load("flash_guidance").rgmf_flash_guidance_max_clusters(
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
    smem2 = 4 * (STAGES * BK * BD2 + 2 * BM2 * LD + 2 * BM2)
    assert max(smem1, smem2) <= SMEM_MAX
    return GuidancePlan(aligned, k_stages, cluster, tiles_b1, tiles_n1,
                        cluster * tiles1, smem1, tiles_b2, tiles_d2,
                        tiles_b2 * tiles_d2, smem2)


def workspace_floats(B: int, N: int) -> int:
    """Floats of the one workspace: the scores S [B, N], then the softmax
    partials (max, sum e, sum e²) of every 32 columns, [3, B, ceil(N/32)]."""
    return B * N + 3 * B * _cdiv(N, 32)


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
    card), else the plan picks it from the card's capacity."""
    fn, err_str = _kernel_fn()
    B, Dx = xt.shape
    N, Dy = Y1.shape
    dev = xt.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    f32 = torch.float32
    capacity = card_capacity(index)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*ptrs[:5], B, N, Dx, Dy, float(np.float32(t)), plan.cluster,
             int(plan.aligned), plan.smem1, plan.smem2, *ptrs[5:], index,
             stream)
    if err != 0:
        raise RuntimeError(f"flash_guidance kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()}), {plan}")
    flash_guidance.launches += 1
    return gx, gy, ess, l


def flash_guidance(x_t: torch.Tensor, y_t: torch.Tensor,
                   mc_x1: torch.Tensor, mc_y1: torch.Tensor,
                   mc_log_r: torch.Tensor, t: float):
    """Fused mc_feng guidance (g_x, g_y, ess[B], l[B]).

    x_t [B, ...], y_t [B, ...], mc_x1 [N, ...], mc_y1 [N, ...] and
    mc_log_r [N] are contiguous float32 tensors on one device; t is a
    Python float. CUDA tensors go to the kernel, CPU tensors to
    `flash_guidance_reference`; anything else raises.
    """
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
        return flash_guidance_reference(*tensors, t)
    if dev.type != "cuda":
        raise ValueError(f"flash_guidance: unsupported device {dev}")
    gx, gy, ess, l = _launch(x_t.reshape(B, -1), y_t.reshape(B, -1),
                             mc_x1.reshape(N, -1), mc_y1.reshape(N, -1),
                             mc_log_r, t)
    return gx.reshape(x_t.shape), gy.reshape(y_t.shape), ess, l


flash_guidance.launches = 0
