"""Fused GroupNorm+SiLU kernel (port of ops/groupnorm_pallas.py).

silu(GroupNorm(G)(x)) with float32 statistics, the fast variance
E[x²]−E[x]² and an affine, for NCHW tensors laid out either contiguously
or in `channels_last` (NHWC) memory.

Kernel (Triton, CUDA tensors): one program per (sample, group). It loops
over the group's H·W·(C/G) elements twice — first for the float32 sums of
x and x², then to normalise, apply the affine and SiLU in float32 and
store in the input dtype. Bound on the card: bytes alone (x read, y
written; the second read of x mostly hits L2), no tensor-core work.

The plain version `group_norm_silu_reference` mirrors the JAX XLA path
(models/layers.py FusedGroupNorm): statistics in float32, affine in
float32, cast to the input dtype, then SiLU. The wrapper runs it only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops import _build


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch silu(GroupNorm(num_groups)(x)) for NCHW x."""
    B, C, H, W = x.shape
    xf = x.to(torch.float32).reshape(B, num_groups, C // num_groups, H * W)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    y = (y * weight.to(torch.float32)[None, :, None, None]
         + bias.to(torch.float32)[None, :, None, None])
    return F.silu(y.to(x.dtype))


@functools.cache
def _triton_kernel():
    """Build the Triton kernel on first use. triton is imported here, not at
    module import, so CPU-only installs can import this module; `tl` is
    bound as a module global because the jitted kernel resolves the names
    it uses through its module's globals."""
    global tl
    # keep Triton's compiled kernels beside the CUDA ones, inside the repo
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def gn_silu_kernel(x_ptr, w_ptr, b_ptr, y_ptr, HW, CG, G,
                       stride_b, stride_c, stride_hw, eps,
                       BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        n = pid // G
        g = pid % G
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < CG
        c = g * CG + cols
        base = n.to(tl.int64) * stride_b
        col_off = c[None, :] * stride_c
        acc = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_HW, BLOCK_C], dtype=tl.float32)
        for hw0 in range(0, HW, BLOCK_HW):
            rows = hw0 + tl.arange(0, BLOCK_HW)
            mask = (rows < HW)[:, None] & cmask[None, :]
            offs = base + rows[:, None] * stride_hw + col_off
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc += v
            acc2 += v * v
        count = HW * CG * 1.0    # float32 (HW or CG may be a constexpr 1)
        mean = tl.sum(tl.sum(acc, axis=1), axis=0) / count
        var = tl.sum(tl.sum(acc2, axis=1), axis=0) / count - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        scale = tl.load(w_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        shift = tl.load(b_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        for hw0 in range(0, HW, BLOCK_HW):
            rows = hw0 + tl.arange(0, BLOCK_HW)
            mask = (rows < HW)[:, None] & cmask[None, :]
            offs = base + rows[:, None] * stride_hw + col_off
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = (v - mean) * rstd * scale[None, :] + shift[None, :]
            y = y * tl.sigmoid(y)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return gn_silu_kernel


def _next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def _launch(x: torch.Tensor, weight, bias, num_groups: int, eps: float):
    B, C, H, W = x.shape
    cg = C // num_groups
    y = torch.empty_like(x)           # same strides as x (dense layouts)
    block_c = _next_pow2(cg)
    block_hw = min(_next_pow2(H * W), max(16, 2048 // block_c))
    _triton_kernel()[(B * num_groups,)](
        x, weight, bias, y, H * W, cg, num_groups,
        x.stride(0), x.stride(1), x.stride(3), float(eps),
        BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4)
    group_norm_silu.launches += 1
    return y


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, num_groups: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """silu(GroupNorm(num_groups)(x)) for NCHW x (contiguous or
    channels_last), float32 or bfloat16; weight/bias [C] float32.

    CUDA tensors launch the Triton kernel, CPU tensors run
    `group_norm_silu_reference`; any other device raises.
    """
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu: x must be NCHW, got shape "
                         f"{tuple(x.shape)}")
    B, C, H, W = x.shape
    if C % num_groups:
        raise ValueError(f"group_norm_silu: C={C} not divisible by "
                         f"num_groups={num_groups}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_silu: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if tuple(p.shape) != (C,) or p.dtype != torch.float32:
            raise ValueError(f"group_norm_silu: {name} must be float32 "
                             f"[{C}], got {p.dtype} {tuple(p.shape)}")
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"group_norm_silu: {name} must be contiguous "
                             f"on {x.device}")
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if not ((x.is_contiguous()
             or x.is_contiguous(memory_format=torch.channels_last))
            and x.stride(2) == W * x.stride(3)):
        raise ValueError("group_norm_silu: x must be contiguous in NCHW or "
                         "channels_last memory format")
    return _launch(x, weight, bias, num_groups, eps)


group_norm_silu.launches = 0
