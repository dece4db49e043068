"""Time group_norm_silu's backward kernel at the training sites (card only).

    python ratio_guided_multimodal_fm_tpu_torch/cli/gn_backward_bench.py \\
        [--out FILE] [--tag NAME] [--calls N]

Times `ops/groupnorm.py:group_norm_silu_backward` (float32, channels_last)
at the SVHN U-Net's largest training site (128x192x32x32, dx and dγ/dβ),
the experiment-1 ratio net's first site at the grad path's batch
(512x32x28x28, dx alone) and the 64-px U-Net's 96- and 288-channel sites
(64x{96,288}x64x64, dx and dγ/dβ), beside each one's bytes bound (x and dy
read once, dx written once, at the card's published rate).

It uses the package's public entry point (and core/card.py's peaks and
card line, which older checkouts have too) and keeps its own timer, so
that it times another checkout's kernel the same way: run it from the other
checkout's root with that checkout on PYTHONPATH (each builds its own
kernels), in turns with this one inside one chip call. The timer is CUDA
events around each call, with the card held behind the host by a spin
kernel first so that the events time the kernels and not the host's
enqueue; `cold` flushes the L2 (64 MiB written) before each call, `warm`
does not. Where the package has `BACKWARD_MAX_CLUSTER`, each site is also
timed with clusters of at most 8 CTAs.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

# (B, C, H, dγ/dβ too)
SITES = [(128, 192, 32, True), (512, 32, 28, False), (64, 96, 64, True),
         (64, 288, 64, True)]
SPIN_CYCLES = 100_000_000        # ~60 ms of the card ahead of the host


def call_ms(fn, calls: int, flush=None):
    """ms of each of `calls` calls of fn() by CUDA events, enqueued while a
    spin kernel holds the card (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def time_sites(calls: int, variant=None):
    """Rows of every site; `variant` (a dict of ops/groupnorm.py constants,
    e.g. BACKWARD_MAX_CLUSTER) is set first and put back after."""
    from ratio_guided_multimodal_fm_tpu_torch.core.card import (
        l2_flusher,
        peaks_for,
    )
    from ratio_guided_multimodal_fm_tpu_torch.ops import groupnorm

    saved = {k: getattr(groupnorm, k) for k in variant or {}}
    for k, v in (variant or {}).items():
        setattr(groupnorm, k, v)
    bw = peaks_for(torch.cuda.get_device_name(0))[1][1]
    flush = l2_flusher(torch.device("cuda"))
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for B, C, H, wgrads in SITES:
        x = (torch.randn(B, C, H, H, generator=g, device="cuda") * 2 + 0.5
             ).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(B, C, H, H, generator=g, device="cuda").contiguous(
            memory_format=torch.channels_last)
        w = torch.rand(C, generator=g, device="cuda") + 0.5
        b = torch.randn(C, generator=g, device="cuda") * 0.1
        mean, rstd = groupnorm.gn_stats_reference(x, 8)

        def run():
            groupnorm.group_norm_silu_backward(dy, x, w, b, mean, rstd,
                                               wgrads)

        plan = (vars(groupnorm.backward_plan(x, dy, 8))
                if hasattr(groupnorm, "backward_plan") else None)
        cold = call_ms(run, calls, flush)
        warm = call_ms(run, calls)
        by = 3.0 * x.numel() * 4 + (2 * B * 8 * 4 + 4 * C * 4 if wgrads
                                    else 0)
        rows.append(dict(
            site=f"{B}x{C}x{H}x{H} f32 channels_last, "
                 f"{'dx+dγ/dβ' if wgrads else 'dx'}",
            variant=variant or "default", cold_ms=statistics.median(cold),
            cold_min_ms=min(cold), cold_max_ms=max(cold),
            warm_ms=statistics.median(warm), bound_ms=by / bw * 1e3,
            plan=plan))
        del x, dy
    for k, v in saved.items():
        setattr(groupnorm, k, v)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="also write the rows here as JSON")
    ap.add_argument("--tag", type=str, default="",
                    help="a name for this checkout in the output")
    ap.add_argument("--calls", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gn_backward_bench: no CUDA device (it times the "
                           "card's kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ratio_guided_multimodal_fm_tpu_torch.core.card import card_info
    from ratio_guided_multimodal_fm_tpu_torch.ops import groupnorm

    rows = time_sites(args.calls)
    if hasattr(groupnorm, "BACKWARD_MAX_CLUSTER"):
        rows += time_sites(args.calls, dict(
            BACKWARD_MAX_CLUSTER=groupnorm.MAX_CLUSTER))
    card = card_info()
    for r in rows:
        r.update(tag=args.tag, card=card)
        print(f"[{args.tag}] {r['site']} ({r['variant']}): cold "
              f"{r['cold_ms']:.4f} ms "
              f"(min {r['cold_min_ms']:.4f}, max {r['cold_max_ms']:.4f}), "
              f"warm {r['warm_ms']:.4f}, bound {r['bound_ms']:.4f}; plan "
              f"{r['plan']}  [{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
