"""Fused GroupNorm+SiLU kernel (port of ops/groupnorm_pallas.py).

silu(GroupNorm(G)(x)) with float32 statistics, the fast variance
E[x²]−E[x]² and an affine, for NCHW tensors laid out either contiguously
or in `channels_last` (NHWC) memory. The affine output is rounded to x's
dtype before SiLU, which runs in float32 on the rounded value: the order of
the JAX U-Net's default XLA path (models/layers.py FusedGroupNorm).

Statistics: the sums of x and x² over a group are taken in float64, where
they are exact for bfloat16 inputs whatever the order of the additions;
mean and E[x²] are rounded once to float32, var = E[x²] − mean² in float32
and rstd = float32(1/sqrt(float64(var + eps))). The kernel computes exactly
these operations, so on the card it and `group_norm_silu_reference` agree
on (mean, rstd) bit for bit and their bf16 outputs differ only through the
float32 SiLU (one bfloat16 step at most). With float32 sums taken in two
orders, the bf16 rounding of some affine outputs would move, and where SiLU
shrinks such a value into a lower binade the move exceeds one step of the
output.

Kernel (CUDA tensors): csrc/group_norm_silu.cu, one pass over device
memory; `gn_plan` below decides its launch. CPU tensors run
`group_norm_silu_reference`; any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.ops import _build

SMEM_MAX = 232_448         # dynamic shared memory one block may use (H100)
NUM_SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8            # the portable thread-block cluster size
SLICE_BYTES = 64 * 1024    # a CTA's slice: three fit an SM's shared memory
SMALL_BYTES = 32 * 1024    # samples up to this size may share a CTA
MAX_THREADS = 512
# The kernel against the plain version on the same input: both take the same
# statistics and round at the same points, so bfloat16 outputs agree to one
# bfloat16 step (the float32 SiLU may differ by a few ulps).
TOL_BF16 = dict(rtol=2**-7, atol=1e-3)
THREADS = 256              # a CTA's threads, where the shape allows


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch silu(GroupNorm(num_groups)(x)) for NCHW x."""
    B, C, H, W = x.shape
    n = C // num_groups * H * W
    f32, f64 = torch.float32, torch.float64
    xd = x.to(f64).reshape(B, num_groups, n)
    mean = (xd.sum(-1, keepdim=True) / n).to(f32)
    msq = ((xd * xd).sum(-1, keepdim=True) / n).to(f32)
    var = msq - mean * mean
    rstd = (1.0 / torch.sqrt((var + eps).to(f64))).to(f32)
    y = ((x.to(f32).reshape(B, num_groups, n) - mean) * rstd).reshape(
        B, C, H, W)
    y = (y * weight.to(f32)[None, :, None, None]
         + bias.to(f32)[None, :, None, None])
    return F.silu(y.to(x.dtype))


@dataclass(frozen=True)
class GNPlan:
    """Launch of csrc/group_norm_silu.cu for one shape.

    A CTA takes `samples_per_cta` whole samples, or (cluster > 1) one
    `cluster`-th of a sample: pixels [r·HW/K, (r+1)·HW/K) in channels_last,
    channels [r·C/K, (r+1)·C/K) in NCHW, for rank r of the cluster. `vec`
    elements go in one load or store; `staged` slices are bulk-copied into
    `smem_bytes` of dynamic shared memory, else read twice from device
    memory."""
    channels_last: bool
    vec: int
    cluster: int
    samples_per_cta: int
    threads: int
    staged: bool
    smem_bytes: int
    grid: int
    slice_cap: int         # elements of the largest slice


def _header_bytes(groups: int, spc: int, nwarps: int) -> int:
    """csrc/group_norm_silu.cu:header_bytes."""
    n = 16 + 16 * groups + 8 * spc * groups + 16 * spc * groups * nwarps
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=1024)
def gn_plan(B: int, C: int, H: int, W: int, groups: int, itemsize: int,
            channels_last: bool, align: int = 16) -> GNPlan:
    """The launch of the kernel for x [B, C, H, W] of `itemsize`-byte
    elements whose data pointer is `align`-byte aligned. Raises ValueError
    for a shape it cannot plan."""
    HW = H * W
    inner = C if channels_last else HW     # contiguous run of one unit
    units = HW if channels_last else C     # what a cluster splits
    vec = 16 // itemsize
    while vec > 1 and (inner % vec or align % (vec * itemsize)):
        vec //= 2
    bulk = (inner * itemsize) % 16 == 0 and align % 16 == 0
    sample_bytes = C * HW * itemsize

    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * cluster <= units
           and -(-units // cluster) * inner * itemsize > SLICE_BYTES):
        cluster *= 2
    spc = 1
    if cluster == 1:
        spc = max(1, min(4, SMALL_BYTES // sample_bytes,
                         -(-B // (2 * NUM_SMS))))
    slice_cap = -(-units // cluster) * inner

    per = C // vec if channels_last else 1  # a thread's channels stay fixed
    base = math.lcm(32, groups, per)
    if base > MAX_THREADS:
        raise ValueError(f"group_norm_silu: no thread count for C={C}, "
                         f"groups={groups} (needs a multiple of {base})")
    threads = base * max(1, min(MAX_THREADS // base, round(THREADS / base)))
    hdr = _header_bytes(groups, spc, threads // 32)
    staged = bulk and hdr + spc * slice_cap * itemsize <= SMEM_MAX
    smem = hdr + (spc * slice_cap * itemsize if staged else 0)
    if smem > SMEM_MAX:
        raise ValueError(f"group_norm_silu: {smem} B of shared memory for "
                         f"groups={groups}")
    return GNPlan(channels_last, vec, cluster, spc, threads, staged, smem,
                  -(-B // spc) * cluster, slice_cap)


def gn_slices(plan: GNPlan, B: int, C: int, H: int, W: int
              ) -> Iterator[Tuple[int, int, int, int]]:
    """(cta, sample, lo, hi): element range [lo, hi) of a sample's memory
    that each CTA of the plan normalises, as the kernel computes it."""
    HW = H * W
    K, spc = plan.cluster, plan.samples_per_cta
    for cta in range(plan.grid):
        r, b0 = cta % K, (cta // K) * spc
        if plan.channels_last:
            lo, hi = r * HW // K * C, (r + 1) * HW // K * C
        else:
            lo, hi = r * C // K * HW, (r + 1) * C // K * HW
        for b in range(b0, min(B, b0 + spc)):
            yield cta, b, lo, hi


_c_fn = None


def _kernel_fn():
    global _c_fn
    if _c_fn is None:
        lib = _build.load("group_norm_silu")
        fn = lib.rgmf_group_norm_silu
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 4 + [ctypes.c_float] + [i] * 10 + [p]
        fn.restype = i
        lib.rgmf_cuda_error_string.argtypes = [i]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fn = (fn, lib.rgmf_cuda_error_string)
    return _c_fn


def _launch(x: torch.Tensor, weight, bias, num_groups: int, eps: float):
    fn, err_str = _kernel_fn()
    B, C, H, W = x.shape
    cl = not x.is_contiguous()          # then channels_last (checked)
    y = torch.empty_like(x)             # x's strides
    align = math.gcd(x.data_ptr(), 16) or 16
    plan = gn_plan(B, C, H, W, num_groups, x.element_size(), cl, align)
    dev = x.device
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             B, C, H * W, num_groups, float(eps),
             int(x.dtype == torch.bfloat16), int(cl), plan.vec, plan.cluster,
             plan.samples_per_cta, plan.threads, int(plan.staged),
             plan.smem_bytes, plan.grid,
             dev.index if dev.index is not None else
             torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_silu kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()}), {plan}")
    group_norm_silu.launches += 1
    return y


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, num_groups: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """silu(GroupNorm(num_groups)(x)) for NCHW x (contiguous or
    channels_last), float32 or bfloat16; weight/bias [C] float32.

    CUDA tensors launch the kernel, CPU tensors run
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
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("group_norm_silu: x must be contiguous in NCHW or "
                         "channels_last memory format")
    if x.numel() == 0:
        raise ValueError(f"group_norm_silu: empty x {tuple(x.shape)}")
    return _launch(x, weight, bias, num_groups, eps)


group_norm_silu.launches = 0
