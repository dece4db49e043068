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
        [--out outputs/guidance_kernel_bench.json] [--yardstick_draws N]

It needs a CUDA card. To compare two commits, run it from a checkout of
each in turn on the same card and read the two files.

`--yardstick_draws N` instead measures how the float64 yardstick of
chip_smoke.py phase 3 behaves on N(0,1) images: for N seeds and t in
(0.05, 0.5, 0.95), at D = 4096 (B=512, N=256) and D = 24,576 (B=64, N=128),
the max |err| in g against the float64 plain version of the kernel, of the
float32 plain version and of the float32 plain version with the features
permuted (another float32 summation order of the same function), and how
often each of the last two exceeds twice the plain version's.
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
                         KERNEL_NAMES, 2)
        row["kernels"] = {short(k): v for k, v in row["kernels"].items()}
        out[tag] = row
    return out


def yardstick(device, draws: int) -> dict:
    """{shape: rows of (seed, t, kernel, plain, permuted)} max |err| in g
    against float64, and the counts above twice the plain version's."""
    from ratio_guided_multimodal_fm_tpu_torch.ops.guidance import (
        flash_guidance,
        flash_guidance_reference,
    )

    out = {}
    for tag, (B, N, H, ch) in {"D4096": (512, 256, 32, (1, 3)),
                               "D24576": (64, 128, 64, (3, 3))}.items():
        rows = []
        for seed in range(draws):
            g = torch.Generator(device).manual_seed(1000 + seed)
            shapes = ((B, H, H, ch[0]), (B, H, H, ch[1]), (N, H, H, ch[0]),
                      (N, H, H, ch[1]), (N,))
            inputs = tuple(torch.randn(sh, generator=g, device=device)
                           for sh in shapes)
            flat = [a.reshape(a.shape[0], -1) for a in inputs[:4]]
            perms = [torch.randperm(flat[i].shape[1], generator=g,
                                    device=device) for i in (0, 1)]
            permuted = (flat[0][:, perms[0]], flat[1][:, perms[1]],
                        flat[2][:, perms[0]], flat[3][:, perms[1]],
                        inputs[4])
            for t in (0.05, 0.5, 0.95):
                exact = flash_guidance_reference(*inputs, t, torch.float64)
                ex = [e.reshape(e.shape[0], -1) for e in exact[:2]]
                alt = flash_guidance_reference(*permuted, t, torch.float64)
                got = flash_guidance(*inputs, t)
                plain = flash_guidance_reference(*inputs, t)
                perm = flash_guidance_reference(*permuted, t)
                err = [max(float((r[i].reshape(B, -1).double() - e)
                                 .abs().max()) for i, e in enumerate(ref))
                       for r, ref in ((got, ex), (plain, ex),
                                      (perm, [a.reshape(B, -1)
                                              for a in alt[:2]]))]
                rows.append(dict(seed=seed, t=t, kernel=err[0],
                                 plain=err[1], permuted=err[2]))
        over = {k: sum(r[k] > 2.0 * r["plain"] + 1e-6 for r in rows)
                for k in ("kernel", "permuted")}
        out[tag] = dict(rows=rows, above_twice_plain=over, cases=len(rows),
                        max_ratio={k: max(r[k] / r["plain"] for r in rows)
                                   for k in ("kernel", "permuted")})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs/guidance_kernel_bench.json")
    ap.add_argument("--yardstick_draws", type=int, default=0,
                    help="measure the float64 yardstick on this many draws "
                         "instead of timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("guidance_kernel_bench: needs a CUDA card")

    from ratio_guided_multimodal_fm_tpu_torch.core.card import card_info
    from ratio_guided_multimodal_fm_tpu_torch.core.device import (
        resolve_device,
    )

    device = resolve_device("cuda")        # pins float32 (no TF32)
    smi = card_info()
    if args.yardstick_draws:
        out = yardstick(device, args.yardstick_draws)
        for tag, r in out.items():
            print(f"{tag}: of {r['cases']} draws x t, above twice the float32"
                  f" plain version's max |err| in g: kernel "
                  f"{r['above_twice_plain']['kernel']}, permuted plain "
                  f"{r['above_twice_plain']['permuted']}; largest ratio to "
                  f"the plain version's: kernel "
                  f"{r['max_ratio']['kernel']:.3g}, permuted plain "
                  f"{r['max_ratio']['permuted']:.3g}  [{smi}]", flush=True)
        out.update(device=torch.cuda.get_device_name(device), nvidia_smi=smi)
    else:
        out = None
    times = None if out else measure(device)
    for tag, r in (times or {}).items():
        print(f"{tag}: events {r['event_ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} (L2 cold {r['device_cold_ms']:.4f}), "
              f"host {r['host_ms']:.4f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          sorted(r["kernels"].items()))
              + f"  [{smi}]", flush=True)
    out = out or dict(device=torch.cuda.get_device_name(device),
                      nvidia_smi=smi,
                      shape=f"B={B_MAIN} N={N_MC} float32 t={T_MID}",
                      times=times)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}  [{smi}]")
    return out


if __name__ == "__main__":
    main()
