"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* `guidance.flash_guidance`        — CUDA C++ (csrc/flash_guidance.cu)
* `groupnorm.group_norm_silu`      — CUDA C++ (csrc/group_norm_silu.cu)
* `groupnorm.group_norm_silu_backward` — CUDA C++
  (csrc/group_norm_silu_backward.cu), the Function's backward
* `resblock.fused_gn_silu_conv`    — CUDA C++ (csrc/fused_gn_silu_conv.cu)
* `batchnorm.batch_norm_silu`      — CUDA C++ (csrc/batch_norm_silu.cu),
  train-mode BatchNorm+SiLU of the experiment-2 ratio net; its backward
  `batchnorm.batch_norm_silu_backward` in the same source
* `linear.linear_tf32x3`           — CUDA C++ (csrc/linear_tf32x3.cu),
  SiT's float32 token projections as 3×TF32 wgmma products, forward,
  dgrad and wgrad (`launches`), each after a split pre-pass
  (`split_launches`)
* `attention.sdpa`                 — PyTorch's memory-efficient (CUTLASS)
  attention on the card, its math backend on the CPU, pinned: counted per
  backend (`efficient_launches`, `math_launches`)

Each wrapper counts the launches of its kernel that run when it is called,
in `<wrapper>.launches` (`launch_counts` reads them all,
`reset_launch_counts` sets them to 0). A CUDA graph's capture only records
the kernels and its replays run them without passing through the wrappers,
so neither counts: a graph's launches are read from a profiler trace.
Binding, launching, checking and counting are `_capi`'s, the one seam
between the wrappers and csrc/.
"""
from ratio_guided_multimodal_fm_tpu_torch.ops._capi import COUNTERS
from ratio_guided_multimodal_fm_tpu_torch.ops.attention import sdpa
from ratio_guided_multimodal_fm_tpu_torch.ops.batchnorm import (
    batch_norm_silu,
    batch_norm_silu_backward,
    batch_norm_silu_backward_reference,
    batch_norm_silu_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_backward,
    group_norm_silu_backward_reference,
    group_norm_silu_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
    flash_guidance,
    flash_guidance_reference,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.linear import linear_tf32x3
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)


def launch_counts() -> dict:
    """{'<wrapper>.<counter>': count} of every kernel wrapper."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in COUNTERS}


def reset_launch_counts() -> None:
    """Every wrapper's counters to 0."""
    for fn, attr in COUNTERS:
        setattr(fn, attr, 0)


__all__ = ["batch_norm_silu", "batch_norm_silu_backward",
           "batch_norm_silu_backward_reference", "batch_norm_silu_reference",
           "flash_guidance", "flash_guidance_reference",
           "fused_gn_silu_conv", "fused_gn_silu_conv_reference",
           "group_norm_silu", "group_norm_silu_backward",
           "group_norm_silu_backward_reference", "group_norm_silu_reference",
           "launch_counts", "linear_tf32x3", "reset_launch_counts", "sdpa"]
