"""Multi-head attention's core, softmax(q kᵀ / sqrt(d)) v, with its
backend pinned: the one entry point the port's transformers call.

`sdpa(q, k, v)` takes q, k, v [B, H, N, d] and runs
`F.scaled_dot_product_attention` under exactly one backend:

* on CUDA the memory-efficient one (CUTLASS's fused forward and backward,
  `fmha_cutlassF_*` / `fmha_cutlassB_*`): it never forms the B·H·N²
  scores. PyTorch's flash backend takes no float32, and the port trains in
  float32 with TF32 off (core/device.py). For float32 on sm80 and later
  the CUTLASS kernels run their two products on the tensor cores as
  3×TF32 (`OpMultiplyAddFastF32`: each operand split into a TF32 high and
  low part, three products), which keeps float32's accuracy;
* on the CPU the math one.

A call the pinned backend cannot take raises; it never falls back to
another backend (the math path on the card would materialise the scores:
16 × 256² floats a head and a block of SiT-XL/2).

Counters, in the `ops` launch-counter scheme (`ops.launch_counts`):
`sdpa.efficient_launches` and `sdpa.math_launches`, one per forward call
that ran eagerly on that backend. A CUDA graph's capture only
records and its replays do not pass through the wrapper, so neither
counts; autograd's backward is not counted either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops._capi import count, counters


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d)) v over [B, H, N, d] (no mask, no dropout):
    the memory-efficient backend on CUDA, the math one elsewhere."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    cuda = q.device.type == "cuda"
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION if cuda
                     else SDPBackend.MATH):
        out = F.scaled_dot_product_attention(q, k, v)
    count(sdpa, "efficient_launches" if cuda else "math_launches", q.device)
    return out


counters(sdpa, "efficient_launches", "math_launches")
