"""The 3×TF32 linear kernel (ops/linear.py → csrc/linear_tf32x3.cu) at
SiT-XL/2's token projections, against the float32 product it replaced.

At each of the four projections (qkv 1152→3456, proj 1152→1152, fc1
1152→4608, fc2 4608→1152) over M = 8,192 tokens (B = 32 latents of 256
patches) and in each role (forward x·Wᵀ + b, dgrad dy·W, wgrad dyᵀ·x) it
times, by CUDA events around ITERS back-to-back calls after WARMUP calls:

* `kernel`  — the role as the port runs it (`role_calls`): the wrapper
  `linear_tf32x3` for the forward, and for dgrad and wgrad its autograd
  Function's backward, each call the split pre-pass and the product;
* `split`   — the pre-pass alone;
* `library` — torch.matmul in float32 (TF32 off): cuBLAS's and CUTLASS's
  SIMT kernels, what the port ran before and no longer calls. It is also
  the plain version's time: the plain versions are these products;

beside the bound, FLOPs / (dense bf16 tensor peak / 6), the rate of three
TF32 products, and the max |err| against the product in float64 of the
kernel, of the float32 product and of the TF32 product. It raises where
the kernel breaks the 3×TF32 rule (`check_role`, which the card tests hold
too). `calls_x_depth` sums the twelve calls' mean times × 28 blocks: the
step's token projections as isolated calls, not a measured step. It writes
the rows as JSON with the card's name and power limit.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.linear_kernel_bench \
        [--out outputs/linear_kernel_bench.json]

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ratio_guided_multimodal_fm_tpu_torch.core.card import (
    card_info,
    peaks_for,
    time_ms,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device
from ratio_guided_multimodal_fm_tpu_torch.ops import linear as L

TOKENS = 32 * 256                 # M at the SiT cell's B = 32
DEPTH = 28                        # SiT-XL/2's blocks: calls of a row a step
SITES = {"qkv": (1152, 3456), "proj": (1152, 1152), "fc1": (1152, 4608),
         "fc2": (4608, 1152)}     # (K, N)
ITERS, WARMUP = 10, 3


def operands(M, K, N, device, seed=0):
    """x [M, K], dy [M, N] ~ N(0, 1) and W [N, K] xavier-uniform, as SiT
    initialises it."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device)
    bound = (6.0 / (N + K)) ** 0.5
    w = (torch.rand(N, K, generator=g, device=device) * 2 - 1) * bound
    dy = torch.randn(M, N, generator=g, device=device)
    return x, w, dy


def role_calls(role, x, w, dy, bias=None):
    """(kernel, library, exact): zero-argument calls of one role. The
    kernel as the port runs it: `linear_tf32x3(x, w, bias)` for the
    forward; for dgrad (wgrad) the backward of a graph built once with x
    (the weight) alone requiring grad, so each call is the Function's
    backward for that operand. The library: the product by torch.matmul in
    the operands' dtype. Exact: the product in float64."""
    if role == "forward":
        kernel = lambda: L.linear_tf32x3(x, w, bias)   # noqa: E731
    else:
        leaf = (x if role == "dgrad" else w).detach().requires_grad_()
        with torch.enable_grad():
            y = (L.linear_tf32x3(leaf, w) if role == "dgrad"
                 else L.linear_tf32x3(x, leaf))
        kernel = lambda: torch.autograd.grad(   # noqa: E731
            y, leaf, dy, retain_graph=True)[0]

    def product(x, w, dy, bias):
        if role == "forward":
            return x @ w.t() if bias is None else torch.addmm(bias, x, w.t())
        return dy @ w if role == "dgrad" else dy.t() @ x

    library = lambda: product(x, w, dy, bias)   # noqa: E731
    exact = lambda: product(   # noqa: E731
        x.double(), w.double(), dy.double(),
        None if bias is None else bias.double())
    return kernel, library, exact


def role_errors(calls) -> dict:
    """Max |err| against the float64 product of the kernel's, of the
    float32 product's (TF32 off) and of the TF32 product's; `calls` is
    `role_calls`'s."""
    kernel, library, exact = calls
    want = exact()
    errs = {"kernel": float((kernel().double() - want).abs().max()),
            "float32": float((library().double() - want).abs().max())}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs["tf32"] = float((library().double() - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return errs


def check_role(name, role, errs):
    """The 3×TF32 rule: the kernel's max |err| within 3× the float32
    product's and under a tenth of the TF32 product's. Raises
    AssertionError otherwise."""
    line = (f"linear_tf32x3 {name} {role}: max |err| vs float64 kernel "
            f"{errs['kernel']:.3e}, float32 {errs['float32']:.3e}, TF32 "
            f"{errs['tf32']:.3e}")
    print(line, flush=True)
    if not (errs["kernel"] <= 3 * errs["float32"]
            and errs["kernel"] < errs["tf32"] / 10):
        raise AssertionError(f"{line}: over 3x float32's or not under a "
                             f"tenth of TF32's")


def bench_row(site, role, M, K, N, device, peak):
    x, w, dy = operands(M, K, N, device)
    bias = torch.zeros(N, device=device) if role == "forward" else None
    calls = role_calls(role, x, w, dy, bias)
    errs = role_errors(calls)
    check_role(site, role, errs)
    kernel, library, _ = calls
    plan = L.linear_plan(M, N, K)[role]
    split_src = {"weight": w, "x": x, "dy": dy}[plan.split]
    flops = 2.0 * M * N * K
    row = dict(site=site, role=role, shape=f"M={M} K={K} N={N}",
               plan=vars(plan), flops=flops, bound_ms=flops / peak * 1e3,
               kernel_max_abs_err=errs["kernel"],
               library_max_abs_err=errs["float32"],
               tf32_max_abs_err=errs["tf32"])
    for name, fn in (("kernel", kernel), ("library", library),
                     ("split", lambda: L._split(split_src,
                                                plan.split_trans))):
        row[f"{name}_ms"] = time_ms(fn, device, ITERS, WARMUP)
    row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
    row["library_tflops"] = flops / row["library_ms"] / 1e9
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs/linear_kernel_bench.json")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")        # pins float32 (no TF32)
    name, smi = torch.cuda.get_device_name(device), card_info()
    peak_key, peaks = peaks_for(name)
    peak = peaks[2] / 6                    # three TF32 products
    rows = []
    for site, (K, N) in SITES.items():
        for role in L.ROLES:
            row = bench_row(site, role, TOKENS, K, N, device, peak)
            print(json.dumps(row), flush=True)
            rows.append(row)
    calls = {k: DEPTH * sum(r[k] for r in rows)
             for k in ("kernel_ms", "library_ms", "split_ms", "bound_ms")}
    out = dict(device=name, nvidia_smi=smi, peaks_of=peak_key,
               peak_tf32x3_flops=peak,
               protocol=f"CUDA events around back-to-back calls after "
                        f"warm-up; warmup {WARMUP}, iters {ITERS}",
               rows=rows, calls_x_depth=calls)
    print(f"12 calls x {DEPTH} blocks (isolated calls, not a step): kernel "
          f"{calls['kernel_ms']:.1f} ms (split {calls['split_ms']:.1f}), "
          f"library {calls['library_ms']:.1f}, bound "
          f"{calls['bound_ms']:.1f}  [{smi}]")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}  [{smi}]")
    return out


if __name__ == "__main__":
    main()
