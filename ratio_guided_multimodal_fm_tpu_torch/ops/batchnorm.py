"""Fused BatchNorm+SiLU in train mode, forward and backward (no TPU kernel:
the JAX package's flax BatchNorm and SiLU are XLA's).

silu(BatchNorm(x)) for NCHW x, with flax's train-mode semantics as
models/ratio.py:BatchNorm2d has them: the batch mean and the biased
variance E[x²] − E[x]² over (N, H, W), clamped at 0, eps 1e-5, then
running = 0.9·running + 0.1·batch and `num_batches_tracked` + 1, in place.

Statistics: mean = E[x] and msq = E[x²] are PyTorch's float32 means, as
BatchNorm2d takes them, var = max(msq − mean², 0) and rstd = rsqrt(var +
eps) in float32, so the statistics, the running statistics and y equal
BatchNorm2d's then SiLU's. rstd is saved NEGATED for a channel whose
variance was clamped: the backward then drops the variance term, as
autograd of clamp_min does. Forward: z = (x − mean)·(rstd·γ) + β, y =
silu(z). Backward, with x̂ = (x − mean)·rstd, s = sigmoid(z): g = dy·s·(1 +
z(1 − s)), dβ = Σg, dγ = Σg·x̂ (float64 sums), dx = rstd·γ·((g − dβ/n) −
x̂·dγ/n).

Kernels (CUDA float32 tensors): csrc/batch_norm_silu.cu, one launch
forward after the two means, two backward (a reduce and an apply; `bn_plan`
below). The kernels and the plain versions here
(`batch_norm_silu_reference`, `batch_norm_silu_backward_reference`) round
at the same points. CPU tensors run the plain versions; any other device
raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops._capi import (
    FLOAT,
    INT,
    PTR,
    Kernel,
    counters,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import NUM_SMS

EPS = 1e-5                 # flax's and torch's BatchNorm epsilon
SLICE = 32                 # channels of a backward reduce CTA (csrc kSlice)
ROWS_PER_PASS = 64         # rows a reduce CTA's 512 threads load at once
MAX_C = 1024               # 32 slices
APPLY_THREADS = 256
APPLY_CTAS_PER_SM = 8
# The kernels against the plain versions at the same statistics: both round
# at the same points, so float32 outputs differ only where the float64
# sums' order moves a float32 rounding, and by the exponential's ulps.
TOL_F32 = dict(rtol=1e-4, atol=1e-5)


@dataclass(frozen=True)
class BNPlan:
    """Launches of csrc/batch_norm_silu.cu for rows x C: the backward's
    reduce grid is `row_blocks` x `slices` CTAs of 512 threads (about one
    an SM), each apply grid `apply_grid` CTAs of 256 threads."""
    slices: int
    row_blocks: int
    apply_grid: int


@functools.lru_cache(maxsize=256)
def bn_plan(rows: int, C: int) -> BNPlan:
    """The plan for x of `rows` rows of C channels (C a multiple of 4, at
    most MAX_C). Raises ValueError for a shape the kernels do not take."""
    if rows < 1 or C < 4 or C % 4 or C > MAX_C or rows * C >= 2**31:
        raise ValueError(f"batch_norm_silu: no plan for {rows} rows of "
                         f"{C} channels (C a multiple of 4 up to {MAX_C}, "
                         f"fewer than 2**31 elements)")
    slices = -(-C // SLICE)
    row_blocks = max(1, min(-(-NUM_SMS // slices),
                            -(-rows // ROWS_PER_PASS)))
    apply_grid = max(1, min(-(-rows * C // 4 // APPLY_THREADS),
                            NUM_SMS * APPLY_CTAS_PER_SM))
    return BNPlan(slices, row_blocks, apply_grid)


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _quotient(s: torch.Tensor, n: int) -> torch.Tensor:
    """s / n in float64, divided by a tensor: on CUDA, PyTorch divides by a
    Python scalar as a product with its reciprocal."""
    return s / torch.full_like(s, float(n))


def bn_moments(x: torch.Tensor):
    """(E[x], E[x²]) [C] of NCHW x over (N, H, W): PyTorch's means in x's
    dtype, as models/ratio.py:BatchNorm2d takes them."""
    return x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))


def bn_stats_reference(x: torch.Tensor, eps: float = EPS):
    """(mean, rstd, var) [C] of NCHW x as the forward forms them (see the
    top), in x's dtype: rstd negated where the variance was clamped, var
    the clamped biased variance."""
    mean, msq = bn_moments(x)
    raw = msq - mean * mean
    var = raw.clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return mean, torch.where(raw < 0, -rstd, rstd), var


def _affine(x, weight, bias, mean, rstd):
    """(x − mean, z = (x − mean)·(|rstd|·γ) + β, |rstd|·γ)."""
    mul = rstd.abs() * weight
    xm = x - _chan(mean)
    return xm, xm * _chan(mul) + _chan(bias), mul


def batch_norm_silu_reference(x, weight, bias, running_mean, running_var,
                              num_batches_tracked, eps: float = EPS):
    """Plain PyTorch forward: (y in x's memory format, mean, rstd [C]) in
    x's dtype; updates the running statistics and `num_batches_tracked` in
    place."""
    mean, rstd, var = bn_stats_reference(x, eps)
    with torch.no_grad():
        for run, new in ((running_mean, mean), (running_var, var)):
            run.copy_(0.9 * run + 0.1 * new)
        num_batches_tracked.add_(1)
    _, z, _ = _affine(x, weight, bias, mean, rstd)
    return F.silu(z), mean, rstd


def batch_norm_silu_backward_reference(dy, x, weight, bias, mean, rstd):
    """Plain PyTorch backward at the forward's saved mean and rstd:
    (dx, dγ, dβ [C]) in x's dtype, as the top sets out."""
    xm, z, mul = _affine(x, weight, bias, mean, rstd)
    xh = xm * _chan(rstd.abs())
    s = torch.sigmoid(z)
    g = dy * s * (1 + z * (1 - s))
    n = x.numel() // x.shape[1]
    s1 = g.to(torch.float64).sum((0, 2, 3))
    s2 = (g.to(torch.float64) * xh.to(torch.float64)).sum((0, 2, 3))
    c1 = _quotient(s1, n).to(x.dtype)
    c2 = torch.where(rstd < 0, 0.0, _quotient(s2, n)).to(x.dtype)
    dx = _chan(mul) * ((g - _chan(c1)) - xh * _chan(c2))
    return dx, s2.to(x.dtype), s1.to(x.dtype)


_FORWARD = Kernel("batch_norm_silu", "batch_norm_silu",
                  [PTR] * 10 + [INT] * 2 + [FLOAT] + [INT])
_BACKWARD = Kernel("batch_norm_silu", "batch_norm_silu_backward",
                   [PTR] * 12 + [INT] * 4)


def _check(what, t, C, dtype=torch.float32):
    if tuple(t.shape) != (C,) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"batch_norm_silu: {what} must be contiguous "
                         f"{dtype} [{C}], got {t.dtype} {tuple(t.shape)}")


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _launch(x, weight, bias, running_mean, running_var, num_batches_tracked,
            eps):
    """(y, mean, rstd): PyTorch's two means, then the kernel; x
    channels_last float32."""
    N, C, H, W = x.shape
    rows = N * H * W
    plan = bn_plan(rows, C)
    mean, msq = bn_moments(x)
    y = torch.empty_like(x)
    rstd = torch.empty_like(mean)
    _FORWARD(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             mean.data_ptr(), msq.data_ptr(), y.data_ptr(), rstd.data_ptr(),
             running_mean.data_ptr(), running_var.data_ptr(),
             num_batches_tracked.data_ptr(), rows, C, float(eps),
             plan.apply_grid, on=x, plan=plan,
             counter=(batch_norm_silu, "launches"))
    return y, mean, rstd


def _launch_backward(dy, x, weight, bias, mean, rstd):
    N, C, H, W = x.shape
    rows = N * H * W
    plan = bn_plan(rows, C)
    dy = _channels_last(dy)
    if dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    coef = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    ws = torch.empty(plan.slices * plan.row_blocks * 2 * SLICE,
                     dtype=torch.float64, device=x.device)
    # the reduce's last-CTA tickets, one a slice, 0 at launch
    tickets = torch.zeros(plan.slices, dtype=torch.int32, device=x.device)
    _BACKWARD(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), ws.data_ptr(), coef.data_ptr(), tickets.data_ptr(),
        rows, C, plan.row_blocks, plan.apply_grid, on=x, plan=plan,
        counter=(batch_norm_silu_backward, "launches"))
    return dx, dgamma, dbeta


def batch_norm_silu_backward(dy: torch.Tensor, x: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dγ, dβ) of `batch_norm_silu` at the forward's saved mean and
    rstd (float32 [C], rstd negated where the variance was clamped).

    CUDA tensors launch the backward kernels (dy is brought to x's
    channels_last memory first), CPU tensors run
    `batch_norm_silu_backward_reference`; any other device raises."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"batch_norm_silu_backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} != x {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return batch_norm_silu_backward_reference(dy, x, weight, bias, mean,
                                                  rstd)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_silu_backward: unsupported device "
                         f"{x.device}")
    return _launch_backward(dy, x, weight, bias, mean, rstd)


counters(batch_norm_silu_backward, "launches")


class _BatchNormSiLU(torch.autograd.Function):
    """silu(BatchNorm(x)) in train mode whose forward saves (mean, rstd)
    and whose backward is `batch_norm_silu_backward`. The running
    statistics come in a tuple, outside autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, running, eps):
        if x.device.type == "cpu":
            y, mean, rstd = batch_norm_silu_reference(x, weight, bias,
                                                      *running, eps)
        else:
            y, mean, rstd = _launch(x, weight, bias, *running, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = batch_norm_silu_backward(dy, x, weight, bias, mean, rstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None, None)


def batch_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    num_batches_tracked: torch.Tensor,
                    eps: float = EPS) -> torch.Tensor:
    """silu(BatchNorm(x)) in train mode for NCHW float32 x (float64 too on
    the CPU): `BatchNorm2d` in train mode, then SiLU, in one op; weight,
    bias, running_mean, running_var [C] in x's dtype,
    num_batches_tracked int64. Updates the running statistics and
    `num_batches_tracked` in place; differentiable in x, weight and bias.

    CUDA tensors take PyTorch's two means, then launch the kernel (x is
    brought to channels_last memory first; the ratio net's activations
    already are), CPU tensors run `batch_norm_silu_reference`; any other
    device raises."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm_silu: x must be NCHW, got shape "
                         f"{tuple(x.shape)}")
    C = x.shape[1]
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise TypeError(f"batch_norm_silu: x must be float32 on the "
                            f"card, got {x.dtype}")
        x = _channels_last(x)
        bn_plan(x.numel() // C, C)
        if x.data_ptr() % 16:
            raise ValueError("batch_norm_silu: x must be 16-byte aligned")
    elif x.device.type != "cpu":
        raise ValueError(f"batch_norm_silu: unsupported device {x.device}")
    for what, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check(what, t, C, x.dtype)
        if t.device != x.device:
            raise ValueError(f"batch_norm_silu: {what} must be on "
                             f"{x.device}")
    if (num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.device != x.device):
        raise ValueError("batch_norm_silu: num_batches_tracked must be an "
                         f"int64 scalar on {x.device}")
    return _BatchNormSiLU.apply(
        x, weight, bias, (running_mean, running_var, num_batches_tracked),
        eps)


counters(batch_norm_silu, "launches")
