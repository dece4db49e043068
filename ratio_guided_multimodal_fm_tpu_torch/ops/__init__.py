"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* `guidance.flash_guidance`     — CUDA C++ (csrc/flash_guidance.cu)
* `groupnorm.group_norm_silu`   — Triton

Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""
