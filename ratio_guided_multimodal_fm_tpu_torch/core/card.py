"""The card's published peak rates, its name and power limit, and the
device-time protocol: the one source that the tier-C bench
(cli/resblock_kernel_bench.py) and chip_smoke.py compute bounds and times
from."""
from __future__ import annotations

import subprocess
import time

import torch

# Published dense peaks at the full power limit (NVIDIA data sheets):
# (float32 non-tensor FLOP/s, memory bytes/s, bf16 tensor-core FLOP/s) by
# the name the card reports, most specific names first.
PEAKS = {"H100 PCIe": (51e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 3.9e12, 835e12),
         "H100": (67e12, 3.35e12, 989e12), "H200": (67e12, 4.8e12, 989e12)}


def peaks_for(name: str):
    """(key, (f32 FLOP/s, bytes/s, bf16 FLOP/s)) for a card name; an
    unknown name gets the H100 SXM's."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def card_info() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def time_ms(fn, device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Mean time of fn() in ms over `iters` back-to-back calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
