"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* `guidance.flash_guidance`        — CUDA C++ (csrc/flash_guidance.cu)
* `groupnorm.group_norm_silu`      — CUDA C++ (csrc/group_norm_silu.cu)
* `resblock.fused_gn_silu_conv`    — CUDA C++ (csrc/fused_gn_silu_conv.cu)

Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import (
    group_norm_silu,
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

__all__ = ["flash_guidance", "flash_guidance_reference",
           "fused_gn_silu_conv", "fused_gn_silu_conv_reference",
           "group_norm_silu", "group_norm_silu_reference"]
