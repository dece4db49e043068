"""mc_feng guidance kernel (port of ops/guidance_pallas.py:flash_guidance).

The normalised importance weights of Feng et al. Alg. 2 reduce exactly to
a softmax over the MC set (see the JAX module's docstring):

    w_i = softmax_i(log r_i - (|x_t - t X1_i|^2 + |y_t - t Y1_i|^2) / 2σ²),
    σ = 1 - t + 1e-3,

and the guidance term is g = (Σ_i w_i X1_i - x_t)/σ (likewise for y).
`flash_guidance` returns (g_x, g_y, ess, l): ESS = l²/q of the weights and
the softmax normaliser l (the largest weight is 1/l).

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/flash_guidance.cu (three kernels: split-K score GEMM with fused row
norms, per-row softmax statistics, weighted-sum GEMM — all IEEE float32).
Both versions leave the row constant |x_t|² + |y_t|² out of the scores: it
cancels in the softmax, and at the main-path width (D = 4096) its float32
rounding alone would move the scores by ~1e-4.
On a CPU tensor it runs `flash_guidance_reference`, the plain PyTorch
version of the same function. Any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.ops import _build

EPS_T = 1e-3  # sigma floor, matches ref flow_utils.py:279

_BM = _BN = 64           # kernel tile (csrc/flash_guidance.cu kBM/kBN)
_BK = 16                 # kernel reduction stage (kBK)
_TARGET_CTAS = 264       # two CTAs per SM on a 132-SM H100


def _scalars(t: float):
    """(t, σ, 1/(2σ²), 1/σ) rounded to float32 as the reference computes
    them (the JAX kernel's scalars are float32 values)."""
    t32 = np.float32(t)
    sigma = np.float32(1.0) - t32 + np.float32(EPS_T)
    return (t32, sigma, np.float32(0.5) / (sigma * sigma),
            np.float32(1.0) / sigma)


def flash_guidance_reference(x_t, y_t, mc_x1, mc_y1, mc_log_r, t: float):
    """Plain PyTorch version of the kernel: softmax form, float32,
    torch.matmul for both products. Same signature and outputs."""
    f32 = torch.float32
    B, N = x_t.shape[0], mc_x1.shape[0]
    xt = x_t.reshape(B, -1).to(f32)
    yt = y_t.reshape(B, -1).to(f32)
    X1 = mc_x1.reshape(N, -1).to(f32)
    Y1 = mc_y1.reshape(N, -1).to(f32)
    lr = mc_log_r.to(f32)
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
        fn.argtypes = ([p] * 5 + [i] * 4 + [ctypes.c_float] + [i] * 2
                       + [p] * 7 + [i, p])
        fn.restype = i
        lib.rgmf_cuda_error_string.argtypes = [i]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fn = (fn, lib.rgmf_cuda_error_string)
    return _c_fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_split(B: int, N: int, D: int) -> Tuple[int, int]:
    """(slices, k_per_slice) for the score GEMM: enough CTAs to cover the
    card, at least 512 features a slice, slices a multiple of the stage."""
    tiles = _cdiv(B, _BM) * _cdiv(N, _BN)
    slices = max(1, min(_cdiv(_TARGET_CTAS, tiles), _cdiv(D, 512)))
    kps = _cdiv(_cdiv(D, slices), _BK) * _BK
    return _cdiv(D, kps), kps


def _launch(xt, yt, X1, Y1, lr, t: float):
    fn, err_str = _kernel_fn()
    B, Dx = xt.shape
    N, Dy = Y1.shape
    slices, kps = k_split(B, N, Dx + Dy)
    dev = xt.device
    f32 = torch.float32
    cross_ws = torch.empty((slices, B, N), dtype=f32, device=dev)
    vnorm_ws = torch.empty((slices, N), dtype=f32, device=dev)
    w = torch.empty((B, N), dtype=f32, device=dev)
    gx = torch.empty_like(xt)
    gy = torch.empty_like(yt)
    ess = torch.empty((B,), dtype=f32, device=dev)
    l = torch.empty((B,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(xt.data_ptr(), yt.data_ptr(), X1.data_ptr(), Y1.data_ptr(),
             lr.data_ptr(), B, N, Dx, Dy, float(np.float32(t)), slices, kps,
             cross_ws.data_ptr(), vnorm_ws.data_ptr(),
             w.data_ptr(), gx.data_ptr(), gy.data_ptr(), ess.data_ptr(),
             l.data_ptr(), dev.index if dev.index is not None else
             torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"flash_guidance kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
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
