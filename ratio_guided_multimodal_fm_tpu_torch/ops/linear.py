"""A float32 linear layer, out = x Wᵀ + b, as 3×TF32 on the tensor cores
(no TPU kernel: the JAX package leaves its dense layers to XLA).

Each float32 operand is split into a TF32 high part and a low part, and
each product is taken as three TF32 products with float32 accumulation
(csrc/linear_tf32x3.cu says how), which keeps float32's accuracy; no
product is TF32 alone. One kernel serves the three roles of a linear
layer, each a launch of `rgmf_linear_gemm` after one split pre-pass
(`rgmf_linear_split`) that writes the high and low planes of the operand
wgmma reads from shared memory:

* forward  out [M, N] = x [M, K] · Wᵀ + b     planes of W [N, K]
* dgrad    dx [M, K]  = dy [M, N] · W         planes of Wᵀ [K, N]
* wgrad    dW [N, K]  = dyᵀ · x               planes of the narrower of
  dy and x, transposed ([·, M]); the other is read transposed by the
  kernel, and the product lands as dW or dWᵀ

The planes are scratch of one call, never saved for the backward. db is a
PyTorch sum over rows.

`linear_tf32x3(x, weight, bias)` takes x [..., K] and weight [N, K] and
is differentiable in all three. CUDA float32 tensors launch the kernels;
any other dtype on the card raises. Tensors elsewhere (the CPU, `meta`)
run the same autograd Function with the plain versions (`F.linear`, dy·W,
dyᵀ·x). `linear_plan(M, N, K)` gives each role's launch and raises
ValueError for a shape the kernels do not take: MIN_ROWS ≤ M ≤ MAX_ROWS
rows, N and K multiples of 4 from 4 to MAX_WIDTH, every operand under
2**31 elements (the grids' limits: 65,535 tiles of 128 rows, of 32
columns for the pre-pass). The floor of 16 rows: the split keeps each
operand to about 22 bits, so a product summed over a handful of terms
misses float32's accuracy (wgrad sums over M: at M = 1 its max |err|
against float64 read 8.5× the float32 product's on an H100), while SiT's
smallest M is one 8×8 latent's 16 tokens.

Counters, in the `ops` launch-counter scheme: `linear_tf32x3.launches`
counts the product's launches (forward, dgrad and wgrad each one),
`linear_tf32x3.split_launches` the pre-pass's; eager calls only (a CUDA
graph's capture only records, and its replays do not pass through here).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops._capi import (
    INT,
    PTR,
    Kernel,
    counters,
    ptr,
)

MAX_ELEMENTS = 2**31     # every operand, plane and output below this
MIN_ROWS = 16            # rows of a product: see the top
MAX_ROWS = 65535 * 128   # rows of a product: grid.y tiles of 128
MAX_WIDTH = 2**20        # N and K: the pre-pass's grid.y tiles of 32
ROLES = ("forward", "dgrad", "wgrad")


@dataclass(frozen=True)
class GemmPlan:
    """One launch: out (R × C) = A · Bᵀ over K, in tiles of 128 × 128.
    `a_trans`: A(r, k) is read from a [K, R] source; `out_trans`: the
    product is stored as [C, R]. The pre-pass splits `split` ("weight",
    "x" or "dy"), transposed when `split_trans`."""
    R: int
    C: int
    K: int
    a_trans: bool
    out_trans: bool
    split: str
    split_trans: bool


@functools.lru_cache(maxsize=256)
def linear_plan(M: int, N: int, K: int) -> dict:
    """{role: GemmPlan} of a linear layer over M rows, K inputs, N outputs.
    Raises ValueError for a shape the kernels do not take."""
    if (not MIN_ROWS <= M <= MAX_ROWS or not 4 <= min(N, K) <= max(N, K)
            <= MAX_WIDTH or N % 4 or K % 4
            or max(M * N, M * K, N * K) >= MAX_ELEMENTS):
        raise ValueError(f"linear_tf32x3: no plan for M={M}, N={N}, K={K} "
                         f"({MIN_ROWS} <= M <= {MAX_ROWS}, N and K "
                         f"multiples of 4 from 4 to {MAX_WIDTH}, every "
                         f"operand under 2**31 elements)")
    # wgrad: the pre-pass transposes the narrower of dy [M, N] and x [M, K]
    wgrad = (GemmPlan(N, K, M, True, False, "x", True) if K <= N
             else GemmPlan(K, N, M, True, True, "dy", True))
    return {"forward": GemmPlan(M, N, K, False, False, "weight", False),
            "dgrad": GemmPlan(M, K, N, False, False, "weight", True),
            "wgrad": wgrad}


_SPLIT = Kernel("linear_tf32x3", "linear_split", [PTR] * 2 + [INT] * 4)
_GEMM = Kernel("linear_tf32x3", "linear_gemm", [PTR] * 4 + [INT] * 7)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (TMA's requirement)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _split(src: torch.Tensor, trans: bool) -> torch.Tensor:
    """The high and low TF32 planes of src [rows, cols]: [2, rows, cols],
    or [2, cols, ld] of srcᵀ (ld = rows rounded up to 4)."""
    rows, cols = src.shape
    if trans:
        ld = -(-rows // 4) * 4
        planes = torch.empty((2, cols, ld), dtype=torch.float32,
                             device=src.device)
    else:
        ld = cols
        planes = torch.empty((2, rows, cols), dtype=torch.float32,
                             device=src.device)
    _SPLIT(src.data_ptr(), planes.data_ptr(), rows, cols, ld, int(trans),
           on=src, plan=f"{rows}x{cols} trans={trans}",
           counter=(linear_tf32x3, "split_launches"))
    return planes


def _gemm(plan: GemmPlan, a: torch.Tensor, planes: torch.Tensor,
          bias, out: torch.Tensor) -> torch.Tensor:
    ldo = plan.R if plan.out_trans else plan.C
    _GEMM(a.data_ptr(), planes.data_ptr(), ptr(bias), out.data_ptr(),
          plan.R, plan.C, plan.K, planes.shape[-1], ldo, int(plan.a_trans),
          int(plan.out_trans), on=a, plan=plan,
          counter=(linear_tf32x3, "launches"))
    return out


def _launch(role: str, plan: GemmPlan, **ops) -> torch.Tensor:
    """One role on the card: the pre-pass on `ops[plan.split]`, then the
    product with A the other operand."""
    if role == "forward":
        x, w, b = ops["x"], ops["weight"], ops["bias"]
        out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32,
                          device=x.device)
        return _gemm(plan, x, _split(w, False), b, out)
    if role == "dgrad":
        dy, w = ops["dy"], ops["weight"]
        out = torch.empty((dy.shape[0], w.shape[1]), dtype=torch.float32,
                          device=dy.device)
        return _gemm(plan, dy, _split(w, True), None, out)
    dy, x = ops["dy"], ops["x"]
    a = dy if plan.split == "x" else x
    out = torch.empty((dy.shape[1], x.shape[1]), dtype=torch.float32,
                      device=dy.device)
    return _gemm(plan, a, _split(ops[plan.split], True), None, out)


class _LinearTF32x3(torch.autograd.Function):
    """x2 [M, K] · Wᵀ + b whose backward runs the same kernel for dgrad and
    wgrad (the plain versions off the card); db is a sum over rows."""

    @staticmethod
    def forward(ctx, x2, weight, bias):
        ctx.save_for_backward(x2, weight)
        if x2.device.type != "cuda":
            return F.linear(x2, weight, bias)
        plans = linear_plan(x2.shape[0], weight.shape[0], x2.shape[1])
        return _launch("forward", plans["forward"], x=x2, weight=weight,
                       bias=bias)

    @staticmethod
    def backward(ctx, dy):
        x2, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        plain = dy.device.type != "cuda"
        if not plain:
            dy = _aligned(dy)
            plans = linear_plan(x2.shape[0], weight.shape[0], x2.shape[1])
        dx = dw = db = None
        if need[0]:
            dx = (dy @ weight if plain else
                  _launch("dgrad", plans["dgrad"], dy=dy, weight=weight))
        if need[1]:
            dw = (dy.t() @ x2 if plain else
                  _launch("wgrad", plans["wgrad"], dy=dy, x=x2))
        if need[2]:
            db = dy.sum(0)
        return dx, dw, db


def linear_tf32x3(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] · weight [N, K]ᵀ + bias [N] → [..., N], differentiable:
    the 3×TF32 kernels for CUDA float32 tensors, the plain versions
    elsewhere (see the top)."""
    K = x.shape[-1]
    if weight.dim() != 2 or weight.shape[1] != K:
        raise ValueError(f"linear_tf32x3: weight {tuple(weight.shape)} does "
                         f"not take x {tuple(x.shape)}")
    N = weight.shape[0]
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"linear_tf32x3: bias {tuple(bias.shape)} is not "
                         f"[{N}]")
    M = x.numel() // K if K else 0
    if x.device.type == "cuda":
        for what, t in (("x", x), ("weight", weight), ("bias", bias)):
            if t is not None and t.dtype != torch.float32:
                raise TypeError(f"linear_tf32x3: {what} must be float32 on "
                                f"the card, got {t.dtype}")
            if t is not None and t.device != x.device:
                raise ValueError(f"linear_tf32x3: {what} must be on "
                                 f"{x.device}")
        linear_plan(M, N, K)
        x2, weight = _aligned(x.reshape(M, K)), _aligned(weight)
        bias = None if bias is None else bias.contiguous()
    else:
        x2 = x.reshape(M, K)
    return _LinearTF32x3.apply(x2, weight, bias).reshape(*x.shape[:-1], N)


counters(linear_tf32x3, "launches", "split_launches")
