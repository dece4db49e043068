"""Generate (x, y) pairs via guided sampling, experiment 1: MNIST-28 ↔ a
transformed MNIST (port of cli/sample.py: methods 'none', 'mc_feng',
'grad', 'mc_feng+grad' and 'smc', with the --smc_* flags).

Loads reference-layout state dicts from ./checkpoints — the .pth files the
JAX package's `rgmf-export-torch --out ...` writes:

    checkpoints/flow_x_best.pth                     (--model unet_mnist,
    checkpoints/flow_y_{transform}_best.pth          or fm_original with
                                                     --model original)
    checkpoints/ratio_{loss}_{transform}_best.pth   (--model ratio)

with `_reflow` (--reflow) and `_ema` (--ema, --ratio_ema) name parts as
the JAX CLI reads them. The ratio net runs in float32 whatever --dtype is.
--merged_unet evaluates both flows as one network (models/merged.py)
where their topologies match: the U-Nets, not the encoder-decoder.
Writes outputs/diagnostics_{method}_gamma{γ}_{transform}.json and, where
matplotlib is installed, outputs/samples_{method}_gamma{γ}_{transform}.png.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.sample \
        --guidance_method mc_feng --guidance_strength 0.5 --dtype bf16
"""
from __future__ import annotations

import argparse
import os

import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_ema_flag,
    add_mc_refresh_flag,
    add_reflow_flag,
    add_smc_flags,
    add_solver_flag,
    checkpoint_path,
    dtype_of,
    fm_bridge,
    fm_model,
    init_runtime,
    load_state_dict,
    maybe_merged_pair_fn,
    ratio_log_fn,
    report_guidance_diagnostics,
    sample_smc_from_args,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
from ratio_guided_multimodal_fm_tpu_torch.models import RatioEstimatorMNIST
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    sample_bimodal_guided,
)

SHAPE = (28, 28, 1)


def load_exp1_flows(args, device: torch.device):
    """FM_x and FM_y (--model unet|original) from ./checkpoints, on
    `device`."""
    rf = "reflow" if args.reflow else None
    em = "ema" if args.ema else None
    nets = []
    for path in (checkpoint_path("flow", "x", None, rf, em, "best"),
                 checkpoint_path("flow", "y", args.transform_type, rf, em,
                                 "best")):
        nets.append(place_model(load_state_dict(
            fm_model(args.model, dtype_of(args)), path,
            fm_bridge(args.model)),
            device))
        print(f"  Loaded {path}")
    return nets[0], nets[1]


def load_exp1_ratio(args, device: torch.device):
    """The ratio net (float32, whatever --dtype is) from ./checkpoints."""
    path = checkpoint_path("ratio", args.loss_type, args.transform_type,
                           "ema" if args.ratio_ema else None, "best")
    ratio = place_model(load_state_dict(
        RatioEstimatorMNIST(loss_type=args.loss_type), path, "ratio"), device)
    print(f"  Loaded {path}")
    return ratio


def load_exp1_models(args, device: torch.device):
    """FM_x, FM_y (+ the ratio net when guiding) from ./checkpoints."""
    fm_x, fm_y = load_exp1_flows(args, device)
    ratio = (load_exp1_ratio(args, device)
             if args.guidance_method != "none" else None)
    return fm_x, fm_y, ratio


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sample bimodal pairs")
    parser.add_argument("--transform_type", type=str, default="rotate90")
    parser.add_argument("--guidance_method", type=str, default="none",
                        choices=["none", "mc_feng", "grad", "mc_feng+grad",
                                 "smc"],
                        help="none=independent, mc_feng=Feng MC guidance, "
                             "grad=ratio-gradient guidance, mc_feng+grad "
                             "both, smc=particle-filter guidance "
                             "(sample/smc.py; no candidate pool)")
    parser.add_argument("--guidance_strength", type=float, default=0.5)
    parser.add_argument("--mc_batch_size", type=int, default=128)
    parser.add_argument("--loss_type", type=str, default="disc")
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--num_steps", type=int, default=100)
    add_solver_flag(parser)
    add_reflow_flag(parser)
    add_ema_flag(parser)
    add_smc_flags(parser)
    parser.add_argument("--ratio_clip", type=float, default=None,
                        help="Clip |log ratio| of MC samples")
    add_mc_refresh_flag(parser)
    parser.add_argument("--ess_floor", type=float, default=None,
                        help="Adaptive guidance: per-trajectory gamma_eff = "
                             "gamma*min(1, ESS/ess_floor)")
    parser.add_argument("--model", type=str, default="unet",
                        choices=["unet", "original"])
    add_common_flags(parser)
    args = parser.parse_args(argv)

    device = init_runtime(args, training=False)   # pins float32 (no TF32)
    generator = torch.Generator(device).manual_seed(args.seed)
    print(f"Random seed: {args.seed}")
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    fm_x, fm_y, ratio = load_exp1_models(args, device)

    print(f"\nSampling {args.num_samples} pairs "
          f"(method={args.guidance_method}, gamma={args.guidance_strength}, "
          f"mc_batch_size={args.mc_batch_size}, steps={args.num_steps})")
    if args.guidance_method == "smc":
        samples_x, samples_y, diags = sample_smc_from_args(
            args, velocity_fn(fm_x), velocity_fn(fm_y), ratio_log_fn(ratio),
            SHAPE, SHAPE, generator)
    else:
        samples_x, samples_y, diags = sample_bimodal_guided(
            velocity_fn(fm_x), velocity_fn(fm_y),
            fm_pair_fn=maybe_merged_pair_fn(fm_x, fm_y, args),
            log_ratio_fn=None if ratio is None else ratio_log_fn(ratio),
            guidance_method=args.guidance_method,
            guidance_strength=args.guidance_strength,
            num_samples=args.num_samples, num_steps=args.num_steps,
            mc_batch_size=args.mc_batch_size, x_shape=SHAPE, y_shape=SHAPE,
            generator=generator, log_ratio_clip=args.ratio_clip,
            ess_floor=args.ess_floor, solver=args.solver,
            time_grid=args.time_grid, grid_power=args.grid_power,
            mc_refresh=args.mc_refresh, return_diagnostics=True)

    os.makedirs("outputs", exist_ok=True)
    tag = (f"{args.guidance_method}"
           f"_gamma{args.guidance_strength}_{args.transform_type}")
    report_guidance_diagnostics(
        diags, args.num_steps, save_path=f"outputs/diagnostics_{tag}.json",
        time_grid=args.time_grid, grid_power=args.grid_power)
    try:
        from ratio_guided_multimodal_fm_tpu_torch.eval.viz import (
            visualize_pairs,
        )
        visualize_pairs(samples_x, samples_y, f"outputs/samples_{tag}.png",
                        args.transform_type)
    except ImportError as e:   # matplotlib is optional
        print(f"Skipped the PNG ({e})")
    print("\nSampling complete!")
    return samples_x, samples_y, diags


if __name__ == "__main__":
    main()
