"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* `guidance.flash_guidance`        — CUDA C++ (csrc/flash_guidance.cu)
* `groupnorm.group_norm_silu`      — CUDA C++ (csrc/group_norm_silu.cu)
* `groupnorm.group_norm_silu_backward` — CUDA C++
  (csrc/group_norm_silu_backward.cu), the Function's backward
* `resblock.fused_gn_silu_conv`    — CUDA C++ (csrc/fused_gn_silu_conv.cu)

Each wrapper counts the launches of its kernel that run when it is called,
in `<wrapper>.launches` (`launch_counts` reads them all,
`reset_launch_counts` sets them to 0). A CUDA graph's capture only records
the kernels and its replays run them without passing through the wrappers,
so neither counts: a graph's launches are read from a profiler trace.
"""
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
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)

_COUNTERS = ((group_norm_silu, "launches"),
             (group_norm_silu_backward, "launches"),
             (group_norm_silu_backward, "weight_grad_launches"),
             (flash_guidance, "launches"),
             (fused_gn_silu_conv, "launches"))


def launch_counts() -> dict:
    """{'<wrapper>.<counter>': count} of every kernel wrapper."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in _COUNTERS}


def reset_launch_counts() -> None:
    """Every wrapper's counters to 0."""
    for fn, attr in _COUNTERS:
        setattr(fn, attr, 0)


__all__ = ["flash_guidance", "flash_guidance_reference",
           "fused_gn_silu_conv", "fused_gn_silu_conv_reference",
           "group_norm_silu", "group_norm_silu_backward",
           "group_norm_silu_backward_reference", "group_norm_silu_reference",
           "launch_counts", "reset_launch_counts"]
