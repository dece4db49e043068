"""Tier-C bench: the fused GroupNorm+SiLU+conv3x3 kernel (kernel C,
ops/resblock.py) against the compositions it would replace (port of
scripts/resblock_kernel_bench.py).

At the U-Net's hot shapes (B=512, bf16, groups=8) it times, by CUDA events
around ITERS back-to-back calls after WARMUP calls:

* `kernel`  — fused_gn_silu_conv (statistics pass + implicit-GEMM conv);
* `port`    — what the port's ResBlock runs today: the Triton
  group_norm_silu, then cuDNN F.conv2d with its bias;
* `library` — F.conv2d(F.silu(F.group_norm(...))), PyTorch alone;
* `plain`   — fused_gn_silu_conv_reference (float32 conv of the rounded
  operands);

beside the bound max(FLOPs / dense bf16 tensor peak, bytes / memory rate),
FLOPs = 2·B·H·W·9·C·O and bytes = one read of x and one write of out, and
the kernel's max |err| against the plain version. It raises where the
kernel and the plain version differ by more than about two bfloat16 steps
(ops/resblock.py:TOL_BF16). It writes the rows as
JSON with the card's name and power limit; it decides nothing for the
U-Net (no model calls kernel C).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.resblock_kernel_bench \
        [--out outputs/resblock_kernel_bench.json] [--device cuda]

`--device cpu` runs the same protocol on the host clock (the plain
versions; for checking the script, never a device time).
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.core.card import (
    card_info,
    peaks_for,
    time_ms,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import group_norm_silu
from ratio_guided_multimodal_fm_tpu_torch.ops.resblock import (
    EPS,
    TOL_BF16,
    fused_gn_silu_conv,
    fused_gn_silu_conv_reference,
)

BATCH, GROUPS = 512, 8
SHAPES = ((32, 32, 64, 64), (16, 16, 128, 128), (32, 32, 32, 64))  # H W C O
ITERS, WARMUP = 20, 3    # per variant and shape: launches = 1 + WARMUP + ITERS


def bench_shape(B, H, W, C, O, device, peaks):
    g = torch.Generator(device).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    bf16 = torch.bfloat16
    x = rnd(B, H, W, C).to(bf16)                 # NHWC
    sc, bi = 1.0 + rnd(C, scale=0.1), rnd(C, scale=0.1)
    w, cb = rnd(3, 3, C, O, scale=0.2), rnd(O, scale=0.1)   # HWIO
    x_nchw = x.permute(0, 3, 1, 2)               # channels_last view, no copy
    w_oihw = w.permute(3, 2, 0, 1).to(bf16).contiguous(
        memory_format=torch.channels_last)
    cb_b, sc_b, bi_b = cb.to(bf16), sc.to(bf16), bi.to(bf16)

    variants = {
        "kernel": lambda: fused_gn_silu_conv(x, sc, bi, w, cb, GROUPS),
        "port": lambda: F.conv2d(group_norm_silu(x_nchw, sc, bi, GROUPS),
                                 w_oihw, cb_b, padding=1),
        "library": lambda: F.conv2d(
            F.silu(F.group_norm(x_nchw, GROUPS, sc_b, bi_b, EPS)), w_oihw,
            cb_b, padding=1),
        "plain": lambda: fused_gn_silu_conv_reference(x, sc, bi, w, cb,
                                                      GROUPS),
    }
    want = variants["plain"]().float()
    errs = {"kernel": variants["kernel"]().float(),
            "port": variants["port"]().permute(0, 2, 3, 1).float()}
    torch.testing.assert_close(
        errs["kernel"], want, **TOL_BF16,
        msg=lambda m: f"fused_gn_silu_conv disagrees with its plain version "
                      f"at {B}x{H}x{W}x{C}->{O} bf16\n{m}")
    flops = 2.0 * B * H * W * 9 * C * O
    nbytes = float(B * H * W * (C + O) * x.element_size())
    _, peak_bw, peak_flops = peaks
    row = dict(shape=f"{B}x{H}x{W}x{C}->{O}", groups=GROUPS, dtype="bf16",
               flops=flops, bytes=nbytes,
               bound_ms=max(flops / peak_flops, nbytes / peak_bw) * 1e3,
               bound_by=("operations" if flops / peak_flops > nbytes / peak_bw
                         else "bytes"))
    for name, got in errs.items():
        row[f"{name}_max_abs_err_vs_plain"] = float((got - want).abs().max())
    for name, fn in variants.items():
        row[f"{name}_ms"] = time_ms(fn, device, ITERS, WARMUP)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (host clock, plain "
                         "versions)")
    ap.add_argument("--out", default="outputs/resblock_kernel_bench.json")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)   # pins float32 (no TF32)
    if device.type == "cuda":
        name, smi = torch.cuda.get_device_name(device), card_info()
        timer = "CUDA events around back-to-back calls after warm-up"
    else:
        name, smi = "cpu", "cpu run: no card"
        timer = "host perf_counter on the CPU (not a device time)"
    peak_key, peaks = peaks_for(name)
    rows = []
    with torch.no_grad():
        for H, W, C, O in SHAPES:
            row = bench_shape(BATCH, H, W, C, O, device, peaks)
            print(json.dumps(row), flush=True)
            rows.append(row)
    out = dict(device=name, nvidia_smi=smi, peaks_of=peak_key,
               peak_bf16_flops=peaks[2], peak_bytes_per_s=peaks[1],
               protocol=f"{timer}; warmup {WARMUP}, iters {ITERS}",
               rows=rows)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}  [{smi}]")
    return out


if __name__ == "__main__":
    main()
