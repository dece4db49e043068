"""Fused GroupNorm+SiLU+conv3x3 kernel (port of ops/resblock_pallas.py).

The half-ResBlock unit, NHWC like the JAX function:

    out = conv3x3(silu(GroupNorm(groups)(x)), SAME) + b

with float32 statistics (fast variance E[x²]−E[x]², eps 1e-6), the
normalise, affine and SiLU in float32, the activation rounded to x's dtype
before the convolution (the weights too), float32 accumulation, and the
bias added before the final cast to x's dtype. SAME padding pads the
*activation* with zeros.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/fused_gn_silu_conv.cu (a statistics pass, then one implicit-GEMM
convolution whose A-operand loader applies the GroupNorm+SiLU on the way
into shared memory: bf16 on tensor cores through WMMA, float32 in plain
IEEE FMA). On a CPU tensor it runs `fused_gn_silu_conv_reference`, the
plain PyTorch version. Any other device raises.

A `channels_last` NCHW activation of the port's U-Nets is this layout with
`.permute(0, 2, 3, 1)` and no copy; HWIO weights are a torch OIHW weight
`.permute(2, 3, 1, 0)`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops import _build

EPS = 1e-6   # the JAX module's GroupNorm epsilon
# The kernel against the plain version on the same bfloat16 input: both
# round at the same points, so they agree to about two bfloat16 steps of
# the output.
TOL_BF16 = dict(rtol=2**-7, atol=0.05)


def fused_gn_silu_conv_reference(x, gn_scale, gn_bias, conv_w, conv_b,
                                 groups: int):
    """Plain PyTorch version, in the JAX kernel's order of operations
    (resblock_pallas.py:56-83). x [B,H,W,C]; conv_w [3,3,C,O] HWIO."""
    B, H, W, C = x.shape
    f32 = torch.float32
    xf = x.to(f32).reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(B, H, W, C)
    y = y * gn_scale.to(f32) + gn_bias.to(f32)
    y = (y * torch.sigmoid(y)).to(x.dtype)          # conv in x's dtype
    w = conv_w.to(x.dtype)
    # the rounded operands in float32: exact products, float32 accumulation
    out = F.conv2d(y.permute(0, 3, 1, 2).to(f32),
                   w.permute(3, 2, 0, 1).to(f32), padding=1)
    out = out.permute(0, 2, 3, 1) + conv_b.to(f32)
    return out.to(x.dtype)


_c_fn = None


def _kernel_fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.load("fused_gn_silu_conv")
        fn = lib.rgmf_fused_gn_silu_conv
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, i, p, p, i, p]
        fn.restype = i
        lib.rgmf_cuda_error_string.argtypes = [i]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fn = (fn, lib.rgmf_cuda_error_string)
    return _c_fn


def _launch(x, gn_scale, gn_bias, conv_w, conv_b, groups: int):
    fn, err_str = _kernel_fn()
    B, H, W, C = x.shape
    O = conv_w.shape[3]
    dev = x.device
    stats = torch.empty((B * groups, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=dev)
    err = fn(x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
             conv_w.data_ptr(), conv_b.data_ptr(), B, H, W, C, O, groups,
             EPS, int(x.dtype == torch.bfloat16), stats.data_ptr(),
             out.data_ptr(), dev.index if dev.index is not None else
             torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_silu_conv kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    fused_gn_silu_conv.launches += 1
    return out


def fused_gn_silu_conv(x: torch.Tensor, gn_scale: torch.Tensor,
                       gn_bias: torch.Tensor, conv_w: torch.Tensor,
                       conv_b: torch.Tensor, groups: int) -> torch.Tensor:
    """conv3x3(silu(GroupNorm(groups)(x))) + b, NHWC -> [B,H,W,O] in x's
    dtype. x [B,H,W,C] float32 or bfloat16; gn_scale, gn_bias [C], conv_w
    [3,3,C,O] (HWIO) and conv_b [O] float32, all on x's device.

    CUDA tensors launch the kernel, CPU tensors run
    `fused_gn_silu_conv_reference`; any other device raises.
    """
    if x.dim() != 4:
        raise ValueError(f"fused_gn_silu_conv: x must be [B,H,W,C], got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    if conv_w.dim() != 4 or tuple(conv_w.shape[:3]) != (3, 3, C):
        raise ValueError(f"conv_w must be [3,3,{C},O], got "
                         f"{tuple(conv_w.shape)}")
    O = conv_w.shape[3]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gn_silu_conv: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, p, n in (("gn_scale", gn_scale, C), ("gn_bias", gn_bias, C),
                       ("conv_b", conv_b, O)):
        if tuple(p.shape) != (n,) or p.dtype != torch.float32:
            raise ValueError(f"fused_gn_silu_conv: {name} must be float32 "
                             f"[{n}], got {p.dtype} {tuple(p.shape)}")
    if conv_w.dtype != torch.float32:
        raise ValueError(f"fused_gn_silu_conv: conv_w must be float32, got "
                         f"{conv_w.dtype}")
    for name, p in (("gn_scale", gn_scale), ("gn_bias", gn_bias),
                    ("conv_w", conv_w), ("conv_b", conv_b)):
        if p.device != x.device:
            raise ValueError(f"fused_gn_silu_conv: {name} is on {p.device}, "
                             f"x on {x.device}")
    if x.device.type == "cpu":
        return fused_gn_silu_conv_reference(x, gn_scale, gn_bias, conv_w,
                                            conv_b, groups)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv: unsupported device {x.device}")
    if not all(a.is_contiguous()
               for a in (x, gn_scale, gn_bias, conv_w, conv_b)):
        raise ValueError("fused_gn_silu_conv: x (NHWC), conv_w (HWIO) and "
                         "the parameter vectors must be contiguous")
    if B == 0 or H == 0 or W == 0 or O == 0:
        raise ValueError(f"fused_gn_silu_conv: empty shape x "
                         f"{tuple(x.shape)}, O={O}")
    return _launch(x, gn_scale, gn_bias, conv_w, conv_b, groups)


fused_gn_silu_conv.launches = 0
