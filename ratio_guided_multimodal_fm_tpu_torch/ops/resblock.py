"""Fused GroupNorm+SiLU+conv3x3 kernel (port of ops/resblock_pallas.py).

The half-ResBlock unit, NHWC like the JAX function:

    out = conv3x3(silu(GroupNorm(groups)(x)), SAME) + b

with float32 statistics (fast variance E[x²]−E[x]², eps 1e-6), the
normalise, affine and SiLU in float32, the activation rounded to x's dtype
before the convolution (the weights too), float32 accumulation, and the
bias added before the final cast to x's dtype. SAME padding pads the
*activation* with zeros.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/fused_gn_silu_conv.cu: a statistics pass (the code of kernel B), a
pass that puts the weights in the operand layout, and a persistent
halo-tile convolution that applies the GroupNorm+SiLU once per element of
each tile's (R+2)×(Wt+2)×C halo in shared memory and multiplies the 9
shifted views of it (bf16 on tensor cores through mma.sync, float32 in
plain IEEE FMA). `conv_plan` below picks the tile. On a CPU tensor it runs
`fused_gn_silu_conv_reference`, the plain PyTorch version. Any other
device raises.

A `channels_last` NCHW activation of the port's U-Nets is this layout with
`.permute(0, 2, 3, 1)` and no copy; HWIO weights are a torch OIHW weight
`.permute(2, 3, 1, 0)`.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Iterator, Tuple

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


SMEM_MAX = 232_448     # dynamic shared memory one block may use (H100)
MAX_TILE = 128         # output pixels of one tile
BN, KC = 64, 64        # outputs per N chunk, input channels per weight stage
STAGES = 2             # weight stages in the shared-memory ring


@dataclass(frozen=True)
class ConvPlan:
    """Tiling of csrc/fused_gn_silu_conv.cu's convolution for one shape:
    tiles of `rows` image rows by `cols` columns of one sample (all O
    outputs, in chunks of 64), `smem_bytes` of dynamic shared memory."""
    rows: int
    cols: int
    tiles_h: int
    tiles_w: int
    kpad: int              # channels multiplied (zero-padded)
    n_pad: int             # outputs, padded to the N chunk
    smem_bytes: int
    weight_elems: int      # the weights as stages (64 outputs x 64 inputs)


def _conv_smem(itemsize: int, C: int, W: int, R: int, Wt: int) -> int:
    """csrc/fused_gn_silu_conv.cu:conv_smem(...).total."""
    def up(v, m):
        return -(-v // m) * m
    pitch = up(C, 16) + 8 if itemsize == 2 else up(C, 4)
    wr = W if Wt == W else Wt + 2
    halo = up(128 + 16 * up(C, 8), 128)
    raw = halo + up((R + 2) * (Wt + 2) * pitch * itemsize, 128)
    w = raw + up((R + 2) * wr * C * itemsize, 128)
    stage = BN * (KC + 8) * 2 if itemsize == 2 else KC * BN * 4
    return w + STAGES * stage


@functools.lru_cache(maxsize=1024)
def conv_plan(H: int, W: int, C: int, O: int, itemsize: int) -> ConvPlan:
    """The widest tile of whole rows (at most 128 pixels; column tiles of
    128 where W > 128) whose shared memory fits a block. Raises ValueError
    where even one row does not fit."""
    cols = min(W, MAX_TILE)
    rows = min(H, MAX_TILE // cols)
    while rows > 1 and _conv_smem(itemsize, C, W, rows, cols) > SMEM_MAX:
        rows -= 1
    smem = _conv_smem(itemsize, C, W, rows, cols)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_gn_silu_conv: C={C} needs {smem} B of "
                         f"shared memory for one row, more than {SMEM_MAX}")
    kpad = -(-C // 16) * 16 if itemsize == 2 else C
    stage = BN * (KC + 8) if itemsize == 2 else KC * BN
    n_pad = -(-O // BN) * BN
    return ConvPlan(rows, cols, -(-H // rows), -(-W // cols), kpad, n_pad,
                    smem, n_pad // BN * 9 * -(-kpad // KC) * stage)


def conv_tiles(plan: ConvPlan, B: int, H: int, W: int
               ) -> Iterator[Tuple[int, int, range, range]]:
    """(tile, sample, output rows, output columns) of every tile, as the
    kernel's tile_of decodes them."""
    per = plan.tiles_h * plan.tiles_w
    for t in range(B * per):
        h0 = (t % per) // plan.tiles_w * plan.rows
        w0 = (t % plan.tiles_w) * plan.cols
        yield (t, t // per, range(h0, min(H, h0 + plan.rows)),
               range(w0, min(W, w0 + plan.cols)))


_c_fn = None


def _kernel_fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.load("fused_gn_silu_conv")
        fn = lib.rgmf_fused_gn_silu_conv
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 5 + [i] * 6 + [ctypes.c_float] + [i] * 4
                       + [p] * 3 + [i, p])
        fn.restype = i
        lib.rgmf_cuda_error_string.argtypes = [i]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fn = (fn, lib.rgmf_cuda_error_string)
    return _c_fn


def _launch(x, gn_scale, gn_bias, conv_w, conv_b, groups: int):
    fn, err_str = _kernel_fn()
    B, H, W, C = x.shape
    O = conv_w.shape[3]
    plan = conv_plan(H, W, C, O, x.element_size())
    dev = x.device
    stats = torch.empty((B * groups, 2), dtype=torch.float32, device=dev)
    wp = torch.empty(plan.weight_elems, dtype=x.dtype, device=dev)
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=dev)
    err = fn(x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
             conv_w.data_ptr(), conv_b.data_ptr(), B, H, W, C, O, groups,
             EPS, int(x.dtype == torch.bfloat16), plan.rows, plan.cols,
             plan.smem_bytes, wp.data_ptr(), stats.data_ptr(),
             out.data_ptr(), dev.index if dev.index is not None else
             torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gn_silu_conv kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()}), {plan}")
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
