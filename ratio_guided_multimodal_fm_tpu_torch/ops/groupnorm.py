"""Fused GroupNorm+SiLU kernel (port of ops/groupnorm_pallas.py).

silu(GroupNorm(G)(x)) with float32 statistics, the fast variance
E[x²]−E[x]² and an affine, for NCHW tensors laid out either contiguously
or in `channels_last` (NHWC) memory. The affine output is rounded to x's
dtype before SiLU, which runs in float32 on the rounded value: the order of
the JAX U-Net's default XLA path (models/layers.py FusedGroupNorm).

Statistics: the sums of x and x² over a group are taken in float64, where
they are exact for bfloat16 inputs whatever the order of the additions;
mean and E[x²] are the IEEE float64 quotients of the sums by the group's
size, rounded once to float32, var = E[x²] − mean² in float32 and rstd =
float32(1/sqrt(float64(var + eps))). The kernel computes exactly these
operations, so on the card it and `group_norm_silu_reference` agree on
(mean, rstd) bit for bit and their bf16 outputs differ only through the
float32 SiLU (one bfloat16 step at most). (For float32 inputs the float64
sums of x² are not exact, so their order can still move a float32
rounding, at a rate of order 2^-25 per group.) With float32 sums taken in two
orders, the bf16 rounding of some affine outputs would move, and where SiLU
shrinks such a value into a lower binade the move exceeds one step of the
output.

Kernel (CUDA tensors): csrc/group_norm_silu.cu, one pass over device
memory; `gn_plan` below decides its launch. CPU tensors run
`group_norm_silu_reference`; any other device raises.

Gradient: where autograd records (grad enabled and x, weight or bias
requiring grad), `group_norm_silu` is a `torch.autograd.Function` whose
forward also saves the statistics (mean, rstd [B, G]) and whose backward is
`group_norm_silu_backward`: csrc/group_norm_silu_backward.cu on the card
(launch plan `gn_backward_plan`), `group_norm_silu_backward_reference` for
CPU tensors. Otherwise the forward runs as before, with no statistics
written.
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
EPS = 1e-6   # the JAX module's GroupNorm epsilon (groupnorm_pallas.py:35)
# The kernel against the plain version on the same input: both take the same
# statistics and round at the same points, so bfloat16 outputs agree to one
# bfloat16 step (the float32 SiLU may differ by a few ulps).
TOL_BF16 = dict(rtol=2**-7, atol=1e-3)
THREADS = 256              # a CTA's threads, where the shape allows


def gn_stats_reference(x: torch.Tensor, num_groups: int, eps: float = EPS):
    """(mean, rstd) [B, G] of NCHW x: float64 sums, mean and E[x²] rounded to
    float32, the fast variance in float32 (see the top). float64 x keeps
    every step in float64."""
    B = x.shape[0]
    n = x[0].numel() // num_groups
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xd = x.to(torch.float64).reshape(B, num_groups, n)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which moves the float32 rounding of ~1 in
    # 10^4 means off the kernel's (IEEE) quotient where n is not a power of 2
    nd = torch.full((B, num_groups), float(n), dtype=torch.float64,
                    device=x.device)
    mean = (xd.sum(-1) / nd).to(cdt)
    msq = ((xd * xd).sum(-1) / nd).to(cdt)
    var = msq - mean * mean
    rstd = (1.0 / torch.sqrt((var + eps).to(torch.float64))).to(cdt)
    return mean, rstd


def _normalise(x, mean, rstd):
    """(x̂, the statistics' dtype, in which x̂ and the affine are taken)."""
    B, C, H, W = x.shape
    G = mean.shape[1]
    cdt = mean.dtype
    xh = ((x.to(cdt).reshape(B, G, -1) - mean[..., None])
          * rstd[..., None]).reshape(B, C, H, W)
    return xh, cdt


def _affine(xh, weight, bias, cdt):
    return xh * weight.to(cdt)[None, :, None, None] \
        + bias.to(cdt)[None, :, None, None]


def _apply_reference(x, weight, bias, mean, rstd):
    xh, cdt = _normalise(x, mean, rstd)
    return F.silu(_affine(xh, weight, bias, cdt).to(x.dtype))


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch silu(GroupNorm(num_groups)(x)) for NCHW x."""
    mean, rstd = gn_stats_reference(x, num_groups, eps)
    return _apply_reference(x, weight, bias, mean, rstd)


def group_norm_silu_backward_reference(dy, x, weight, bias, mean, rstd,
                                       weight_grads: bool = True):
    """Plain PyTorch backward of `group_norm_silu` at the saved statistics
    (mean, rstd [B, G]): (dx in x's dtype, dγ, dβ float32 [C] or None).

    In float32 (float64 for float64 inputs): s = sigmoid(ã) at the ROUNDED
    affine output ã, da = dy·s·(1 + ã(1 − s)), per (b, g) c₁ = mean(da·γ)
    and c₂ = mean(da·γ·x̂), dx = rstd·(da·γ − c₁ − x̂·c₂); dγ = Σ da·x̂ and
    dβ = Σ da over batch and pixels."""
    B, C, H, W = x.shape
    G = mean.shape[1]
    xh, cdt = _normalise(x, mean, rstd)
    a = _affine(xh, weight, bias, cdt).to(x.dtype).to(cdt)
    s = torch.sigmoid(a)
    da = dy.to(cdt) * s * (1 + a * (1 - s))
    dag = (da * weight.to(cdt)[None, :, None, None]).reshape(B, G, -1)
    xhg = xh.reshape(B, G, -1)
    c1 = dag.mean(-1, keepdim=True)
    c2 = (dag * xhg).mean(-1, keepdim=True)
    dx = (rstd[..., None] * (dag - c1 - xhg * c2)).reshape(B, C, H, W)
    if not weight_grads:
        return dx.to(x.dtype), None, None
    return dx.to(x.dtype), (da * xh).sum((0, 2, 3)), da.sum((0, 2, 3))


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


def _decompose(B, C, H, W, groups, itemsize, channels_last, align,
               slice_bytes, small_bytes, max_cluster=MAX_CLUSTER):
    """(vec, bulk, cluster, samples per CTA, slice_cap, threads, base): how
    the forward and the backward kernel cut x into CTAs' slices; a CTA's
    thread count is a multiple of `base`."""
    HW = H * W
    inner = C if channels_last else HW     # contiguous run of one unit
    units = HW if channels_last else C     # what a cluster splits
    vec = 16 // itemsize
    while vec > 1 and (inner % vec or align % (vec * itemsize)):
        vec //= 2
    bulk = (inner * itemsize) % 16 == 0 and align % 16 == 0
    sample_bytes = C * HW * itemsize

    cluster = 1
    while (cluster < max_cluster and 2 * cluster <= units
           and -(-units // cluster) * inner * itemsize > slice_bytes):
        cluster *= 2
    spc = 1
    if cluster == 1:
        spc = max(1, min(4, small_bytes // sample_bytes,
                         -(-B // (2 * NUM_SMS))))
    slice_cap = -(-units // cluster) * inner

    per = C // vec if channels_last else 1  # a thread's channels stay fixed
    base = math.lcm(32, groups, per)
    if base > MAX_THREADS:
        raise ValueError(f"group_norm_silu: no thread count for C={C}, "
                         f"groups={groups} (needs a multiple of {base})")
    threads = base * max(1, min(MAX_THREADS // base, round(THREADS / base)))
    return vec, bulk, cluster, spc, slice_cap, threads, base


@functools.lru_cache(maxsize=1024)
def gn_plan(B: int, C: int, H: int, W: int, groups: int, itemsize: int,
            channels_last: bool, align: int = 16) -> GNPlan:
    """The launch of the kernel for x [B, C, H, W] of `itemsize`-byte
    elements whose data pointer is `align`-byte aligned. Raises ValueError
    for a shape it cannot plan."""
    vec, bulk, cluster, spc, slice_cap, threads, _ = _decompose(
        B, C, H, W, groups, itemsize, channels_last, align, SLICE_BYTES,
        SMALL_BYTES)
    hdr = _header_bytes(groups, spc, threads // 32)
    staged = bulk and hdr + spc * slice_cap * itemsize <= SMEM_MAX
    smem = hdr + (spc * slice_cap * itemsize if staged else 0)
    if smem > SMEM_MAX:
        raise ValueError(f"group_norm_silu: {smem} B of shared memory for "
                         f"groups={groups}")
    return GNPlan(channels_last, vec, cluster, spc, threads, staged, smem,
                  -(-B // spc) * cluster, slice_cap)


# The backward (csrc/group_norm_silu_backward.cu)
WIDE_CLUSTER = 16          # a non-portable cluster, where the card holds it
MAX_BARRIERS = 4           # mbarriers of a CTA, one a staged sample (kMaxBars)
# A slice too large to stage is read twice from device memory; this much
# dynamic shared memory keeps an SM to at most two such CTAs, so that what
# pass 1 read last is still in the L2 when pass 2 reads it back.
UNSTAGED_SMEM = 77 * 1024


def _bwd_header_bytes(C: int, groups: int, spc: int) -> int:
    """csrc/group_norm_silu_backward.cu:bwd_header_bytes."""
    n = 8 * MAX_BARRIERS + 16 * spc * groups + 16 * spc * C + 8 * spc * groups
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=1024)
def gn_backward_plan(B: int, C: int, H: int, W: int, groups: int,
                     itemsize: int, channels_last: bool, align: int = 16,
                     max_cluster: int = MAX_CLUSTER) -> GNPlan:
    """The launch of csrc/group_norm_silu_backward.cu for x and dy
    [B, C, H, W] whose data pointers are both `align`-byte aligned: kernel
    B's decomposition with half its slice and clusters of up to
    `max_cluster` CTAs (16 only where the card holds such clusters), so
    that a CTA stages the slice of x and of dy (`smem_bytes` of dynamic
    shared memory). A slice that does not fit is read twice from device
    memory (`staged` False) by up to 512 threads, at most two CTAs an SM.
    Raises ValueError for a shape it cannot plan."""
    vec, bulk, cluster, spc, slice_cap, threads, base = _decompose(
        B, C, H, W, groups, itemsize, channels_last, align, SLICE_BYTES // 2,
        SMALL_BYTES // 2, max_cluster)
    hdr = _bwd_header_bytes(C, groups, spc)
    slices = 2 * spc * slice_cap * itemsize      # x and dy of the samples
    staged = bulk and hdr + slices <= SMEM_MAX
    smem = hdr + (slices if staged else 0)
    if bulk and not staged:
        threads = base * (MAX_THREADS // base)
        smem = max(hdr, UNSTAGED_SMEM)
    if smem > SMEM_MAX:
        raise ValueError(f"group_norm_silu_backward: {smem} B of shared "
                         f"memory for C={C}, groups={groups}")
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


_c_fns = {}


def _kernel_fn(name: str, argtypes):
    """The C entry point rgmf_<name> of csrc/<name>.cu and the library's
    error-string function."""
    if name not in _c_fns:
        lib = _build.load(name)
        fn = getattr(lib, f"rgmf_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rgmf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rgmf_cuda_error_string.restype = ctypes.c_char_p
        _c_fns[name] = (fn, lib.rgmf_cuda_error_string)
    return _c_fns[name]


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 10 + [_P]
_BWD_ARGS = [_P] * 10 + [_I] * 14 + [_P]


def _device_and_stream(x):
    dev = x.device
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _eager() -> int:
    """1 when the kernel just launched runs now, 0 when a CUDA graph
    capture only recorded it (a replay runs it without this wrapper, so a
    graph's launches are read from a profiler trace of its replays)."""
    return int(not torch.cuda.is_current_stream_capturing())


def _launch(x: torch.Tensor, weight, bias, num_groups: int, eps: float,
            stats: bool = False):
    """y (x's strides); with `stats` also (mean, rstd) float32 [B, G]."""
    fn, err_str = _kernel_fn("group_norm_silu", _FWD_ARGS)
    B, C, H, W = x.shape
    cl = not x.is_contiguous()          # then channels_last (checked)
    y = torch.empty_like(x)             # x's strides
    mean = rstd = None
    if stats:
        mean = torch.empty((B, num_groups), dtype=torch.float32,
                           device=x.device)
        rstd = torch.empty_like(mean)
    align = math.gcd(x.data_ptr(), 16) or 16
    plan = gn_plan(B, C, H, W, num_groups, x.element_size(), cl, align)
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             _ptr(mean), _ptr(rstd), B, C, H * W, num_groups, float(eps),
             int(x.dtype == torch.bfloat16), int(cl), plan.vec, plan.cluster,
             plan.samples_per_cta, plan.threads, int(plan.staged),
             plan.smem_bytes, plan.grid, *_device_and_stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_silu kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()}), {plan}")
    group_norm_silu.launches += _eager()
    return (y, mean, rstd) if stats else y


@functools.lru_cache(maxsize=None)
def backward_clusters(index: int, is_bf16: bool, plan: GNPlan) -> int:
    """Clusters of the plan's launch that card `index` holds at once
    (cudaOccupancyMaxActiveClusters); builds the kernel if needed."""
    _kernel_fn("group_norm_silu_backward", _BWD_ARGS)
    fn = _build.load("group_norm_silu_backward"
                     ).rgmf_group_norm_silu_backward_max_clusters
    fn.argtypes = [_I] * 7
    fn.restype = _I
    n = fn(int(is_bf16), int(plan.channels_last), plan.vec, plan.cluster,
           plan.threads, plan.smem_bytes, index)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {-n}"
                           f" for {plan}")
    return n


# clusters of up to this many CTAs where the card holds them
# (backward_clusters); MAX_CLUSTER keeps every plan portable
BACKWARD_MAX_CLUSTER = WIDE_CLUSTER


def backward_plan(x: torch.Tensor, dy: torch.Tensor, groups: int) -> GNPlan:
    """The plan that the kernel launches with for CUDA x and dy (dy in x's
    memory format): clusters of up to BACKWARD_MAX_CLUSTER CTAs where the
    card holds at least one such cluster, else of up to MAX_CLUSTER."""
    B, C, H, W = x.shape
    cl = not x.is_contiguous()
    align = math.gcd(math.gcd(x.data_ptr(), dy.data_ptr()), 16) or 16
    args = (B, C, H, W, groups, x.element_size(), cl, align)
    plan = gn_backward_plan(*args, BACKWARD_MAX_CLUSTER)
    if plan.cluster > MAX_CLUSTER and backward_clusters(
            _device_and_stream(x)[0], x.dtype == torch.bfloat16, plan) < 1:
        plan = gn_backward_plan(*args)
    return plan


def _launch_backward(dy, x, weight, bias, mean, rstd, weight_grads: bool):
    fn, err_str = _kernel_fn("group_norm_silu_backward", _BWD_ARGS)
    B, C, H, W = x.shape
    G = mean.shape[1]
    cl = not x.is_contiguous()
    dy = dy.contiguous(memory_format=torch.channels_last if cl
                       else torch.contiguous_format)
    dx = torch.empty_like(x)
    bf16 = x.dtype == torch.bfloat16
    plan = backward_plan(x, dy, G)
    ws = dgamma = dbeta = None
    if weight_grads:
        ws = torch.empty((plan.grid // plan.cluster, C, 2),
                         dtype=torch.float64, device=x.device)
        dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
        dbeta = torch.empty_like(dgamma)
    err = fn(x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(ws),
             _ptr(dgamma), _ptr(dbeta), B, C, H * W, G, int(bf16), int(cl),
             plan.vec, plan.cluster, plan.samples_per_cta, plan.threads,
             int(plan.staged), plan.smem_bytes, plan.grid,
             *_device_and_stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_silu_backward kernel launch failed: "
                           f"CUDA error {err} ({err_str(err).decode()}), "
                           f"{plan}")
    group_norm_silu_backward.launches += _eager()
    group_norm_silu_backward.weight_grad_launches += _eager() * weight_grads
    return dx, dgamma, dbeta


def group_norm_silu_backward(dy: torch.Tensor, x: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight_grads: bool = True):
    """(dx, dγ, dβ) of silu(GroupNorm(x)) at the forward's saved statistics
    mean, rstd (float32 [B, G]); dγ and dβ are None unless `weight_grads`.

    CUDA tensors launch csrc/group_norm_silu_backward.cu (dy is brought to
    x's memory format first; with `weight_grads` a second launch reduces the
    clusters' dγ/dβ partials), CPU tensors run
    `group_norm_silu_backward_reference`; any other device raises.
    """
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"group_norm_silu_backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} != x {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return group_norm_silu_backward_reference(dy, x, weight, bias, mean,
                                                  rstd, weight_grads)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_backward: unsupported device "
                         f"{x.device}")
    return _launch_backward(dy, x, weight, bias, mean.contiguous(),
                            rstd.contiguous(), weight_grads)


group_norm_silu_backward.launches = 0
# the calls that also ran the second launch, the dγ/dβ reduction
group_norm_silu_backward.weight_grad_launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    """silu(GroupNorm(x)) whose forward saves the statistics and whose
    backward is `group_norm_silu_backward`; dγ and dβ are formed only where
    `ctx.needs_input_grad` asks for them."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        if x.device.type == "cpu":
            mean, rstd = gn_stats_reference(x, num_groups, eps)
            y = _apply_reference(x, weight, bias, mean, rstd)
        else:
            y, mean, rstd = _launch(x, weight, bias, num_groups, eps,
                                    stats=True)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        _, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = group_norm_silu_backward(dy, x, weight, bias, mean, rstd,
                                              need_w or need_b)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if need_w else None, db if need_b else None, None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, num_groups: int,
                    eps: float = EPS) -> torch.Tensor:
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.device.type == "cuda":
        if not (x.is_contiguous()
                or x.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("group_norm_silu: x must be contiguous in NCHW "
                             "or channels_last memory format")
        if x.numel() == 0:
            raise ValueError(f"group_norm_silu: empty x {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, weight, bias, num_groups, eps)
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, num_groups, eps)
    return _launch(x, weight, bias, num_groups, eps)


group_norm_silu.launches = 0
