"""Times the mc_feng guidance kernel (kernel A, ops/guidance.py) four ways,
so that the host does not set the number.

At both main-path widths (B=512, N=256; D=4096 of experiment 2 and D=1568
of experiment 1, float32, t=0.5) it reports, per wrapper call, the times of
core/card.py:call_times:

* `event_ms`       — CUDA events around 20 back-to-back calls (at ~0.05 ms
  this follows the host's enqueue rate as much as the kernels);
* `device_ms`      — torch.profiler device time during which the wrapper's
  own kernels ran (L2 warm: the inputs of the previous call are still
  cached);
* `device_cold_ms` — the same with a 64 MiB buffer written between calls,
  so every call finds the 50 MB L2 cold, as a sampler step does;
* `host_ms`        — host clock over 200 enqueues without a synchronise:
  what the wrapper costs the host;

and `kernels`, the device time by kernel name.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.guidance_kernel_bench \
        [--out outputs/guidance_kernel_bench.json]

It needs a CUDA card. To compare two commits, run it from a checkout of
each in turn on the same card and read the two files.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

B_MAIN, N_MC, T_MID = 512, 256, 0.5
WIDTHS = {"D4096": (32, 3), "D1568": (28, 1)}     # image size, y channels
KERNEL_NAMES = ("scores_kernel", "weighted_sum_kernel")


def short(name: str) -> str:
    """`scores_kernel<true>` of a mangled or templated kernel name."""
    for k in KERNEL_NAMES:
        i = name.find(k)
        if i >= 0:
            return name[i:].split("(")[0][:40]
    return name[:40]


def measure(device) -> dict:
    from ratio_guided_multimodal_fm_tpu_torch.core.card import call_times
    from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
        flash_guidance,
    )

    g = torch.Generator(device).manual_seed(0)
    out = {}
    for tag, (H, y_ch) in WIDTHS.items():
        inputs = tuple(torch.randn(s, generator=g, device=device) for s in (
            (B_MAIN, H, H, 1), (B_MAIN, H, H, y_ch), (N_MC, H, H, 1),
            (N_MC, H, H, y_ch), (N_MC,)))
        row = call_times(lambda: flash_guidance(*inputs, T_MID), device,
                         KERNEL_NAMES)
        row["kernels"] = {short(k): v for k, v in row["kernels"].items()}
        out[tag] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs/guidance_kernel_bench.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("guidance_kernel_bench: needs a CUDA card")

    from ratio_guided_multimodal_fm_tpu_torch.core.card import card_info
    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        resolve_device,
    )

    device = resolve_device("cuda")        # pins float32 (no TF32)
    smi = card_info()
    times = measure(device)
    for tag, r in times.items():
        print(f"{tag}: events {r['event_ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} (L2 cold {r['device_cold_ms']:.4f}), "
              f"host {r['host_ms']:.4f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          sorted(r["kernels"].items()))
              + f"  [{smi}]", flush=True)
    out = dict(device=torch.cuda.get_device_name(device), nvidia_smi=smi,
               shape=f"B={B_MAIN} N={N_MC} float32 t={T_MID}", times=times)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}  [{smi}]")
    return out


if __name__ == "__main__":
    main()
