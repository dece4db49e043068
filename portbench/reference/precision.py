"""The precision a reference computation runs in.

`fp32` is the reference itself: float32 with TF32 off. The lower ones are
the controls that `correct` has to reject:

* `fp8`: every convolution and dense layer reads its input and its weight
  rounded to float8 e4m3 with a per-tensor scale (amax / 448), and adds and
  accumulates in float32: the step below bfloat16.
* `tf32`: the step below float32 with TF32 off. On a card the library's
  own TF32 paths are switched on for the call (`tf32_scope`); on the CPU,
  which has none, the inputs and weights are rounded to TF32's 10-bit
  mantissa.

`fp32_cl` is the reference again with every convolution's input and weight
in channels_last memory, where the library picks other float32 algorithms:
a second float32 reading, which shows how far float32 rounding alone moves
a number.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "fp8", "tf32", "fp32_cl")
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().max().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to 10 mantissa bits, to nearest (ties away)."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r.view(x.shape) - x).detach()


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last) \
        if x.dim() == 4 else x


def rounder(precision: str, device: torch.device):
    """The function applied to every conv / dense input and weight."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if precision == "fp8":
        return _fp8
    if precision == "fp32_cl":
        return _channels_last
    if precision == "tf32" and device.type != "cuda":
        return _tf32
    return None


@contextlib.contextmanager
def tf32_scope(precision: str):
    """Set the library's TF32 switches for a computation: on for `tf32`,
    off otherwise; restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
