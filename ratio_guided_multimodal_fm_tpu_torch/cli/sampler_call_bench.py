"""Times whole guided-sampler calls in a process of their own, so that the
host-bound call time is read without what another script ran before it.

For each path (experiment 2: FlowMatchingUNetMNIST(32) + FlowMatchingUNetSVHN
+ RatioEstimatorMNISTSVHN; experiment 1: two MNIST-28 FlowMatchingUNets +
RatioEstimatorMNIST in float32), random weights from a seed, bf16 U-Net
activations, B=512 pairs, N_mc=256, --steps Euler steps, mc_feng at γ=0.5:
one warm-up call, then --calls calls, each timed by CUDA events and the host
clock. Prints one JSON line (seconds per call, samples/s, the card's name
and power limit).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.sampler_call_bench \
        [--paths exp2 exp1] [--calls 3] [--steps 100]

It needs a CUDA card. It uses only the sampler's public entry points, so a
checkout of an older commit can be timed by running this file with that
checkout's package first on PYTHONPATH; compare two commits in turns inside
one machine session.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.card import card_info
from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    place_model,
    resolve_device,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingUNet,
    FlowMatchingUNetMNIST,
    FlowMatchingUNetSVHN,
    RatioEstimatorMNIST,
    RatioEstimatorMNISTSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    make_guided_sampler_p,
)

B_MAIN, N_MC, GAMMA = 512, 256, 0.5
PATHS = {"exp2": ((32, 32, 1), (32, 32, 3)), "exp1": ((28, 28, 1),
                                                      (28, 28, 1))}


def build(path: str, device):
    """The path's random-init nets, seeded; out_conv perturbed so the
    velocity nets are not identically zero."""
    torch.manual_seed(0)
    bf16 = torch.bfloat16
    if path == "exp2":
        nets = (FlowMatchingUNetMNIST(img_size=32, dtype=bf16),
                FlowMatchingUNetSVHN(dtype=bf16),
                RatioEstimatorMNISTSVHN(dtype=bf16))
    else:
        nets = (FlowMatchingUNet(dtype=bf16), FlowMatchingUNet(dtype=bf16),
                RatioEstimatorMNIST())
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for net in nets[:2]:
            net.out_conv.weight.copy_(
                torch.randn(net.out_conv.weight.shape, generator=g) * 0.02)
    return tuple(place_model(m, device) for m in nets)


def time_path(path: str, calls: int, steps: int, device) -> dict:
    x_shape, y_shape = PATHS[path]
    cfg = GuidedSamplerConfig(guidance_method="mc_feng",
                              guidance_strength=GAMMA, num_steps=steps,
                              mc_batch_size=N_MC, x_shape=x_shape,
                              y_shape=y_shape)
    sampler = make_guided_sampler_p(lambda m, x, t: velocity_fn(m)(x, t),
                                    lambda m, y, t: velocity_fn(m)(y, t), cfg,
                                    lambda r, x, y: ratio_log_fn(r)(x, y))
    models = build(path, device)
    events, walls = [], []
    for i in range(calls + 1):                  # call 0 warms up
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev0.record()
        x1, y1, _ = sampler(models, torch.Generator(device).manual_seed(i),
                            B_MAIN)
        ev1.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - h0)
        events.append(ev0.elapsed_time(ev1) / 1e3)
        if not (bool(torch.isfinite(x1).all())
                and bool(torch.isfinite(y1).all())):
            raise RuntimeError(f"{path}: non-finite samples")
    return dict(warmup_s=events[0], event_s=events[1:], wall_s=walls[1:],
                samples_per_s=[B_MAIN / s for s in events[1:]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", nargs="+", choices=sorted(PATHS),
                    default=["exp2", "exp1"])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sampler_call_bench needs a CUDA card")
    device = resolve_device("cuda")        # pins float32 (no TF32)
    out = {"card": card_info(), "batch": B_MAIN, "n_mc": N_MC,
           "steps": args.steps}
    for path in args.paths:
        out[path] = time_path(path, args.calls, args.steps, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
