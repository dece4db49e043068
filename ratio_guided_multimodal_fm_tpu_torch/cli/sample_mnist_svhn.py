"""Generate MNIST-SVHN pairs via guided sampling (port of
cli/sample_mnist_svhn.py: methods 'none', 'mc_feng', 'grad',
'mc_feng+grad' and 'smc', whose defaults here are islands of 8 and
--smc_resample_tau 0.7, as in the JAX CLI).

Loads reference-layout state dicts from ./checkpoints — the .pth files the
JAX package's `rgmf-export-torch --out ...` writes:

    checkpoints/flow_mnist32_best.pth          (--model unet_mnist)
    checkpoints/flow_svhn_best.pth             (--model unet_svhn)
    checkpoints/ratio_{loss}_mnist_svhn_best.pth  (--model ratio_mnist_svhn)

with `_reflow` (--reflow) and `_ema` (--ema, --ratio_ema) name parts.

Writes outputs/mnist_svhn/diagnostics_{method}_gamma{γ}.json and, where
matplotlib is installed, samples_{method}_gamma{γ}.png.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.sample_mnist_svhn \
        --guidance_method mc_feng --guidance_strength 0.5
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
    dtype_of,
    init_runtime,
    load_state_dict,
    ratio_log_fn,
    report_guidance_diagnostics,
    sample_smc_from_args,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingUNetMNIST,
    FlowMatchingUNetSVHN,
    RatioEstimatorMNISTSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    sample_bimodal_guided,
)


def load_mnist_svhn_models(loss_type: str, need_ratio: bool,
                           device: torch.device,
                           dtype: torch.dtype = torch.float32,
                           reflow: bool = False, ema: bool = False,
                           ratio_ema: bool = False):
    """FM_mnist32 + FM_svhn (+ ratio net) from ./checkpoints, on `device`.
    reflow / ema / ratio_ema select the `_reflow` and `_ema` files."""
    rf = ("_reflow" if reflow else "") + ("_ema" if ema else "")
    fm_mnist = load_state_dict(FlowMatchingUNetMNIST(img_size=32, dtype=dtype),
                               f"checkpoints/flow_mnist32{rf}_best.pth",
                               "unet_mnist")
    fm_svhn = load_state_dict(FlowMatchingUNetSVHN(dtype=dtype),
                              f"checkpoints/flow_svhn{rf}_best.pth",
                              "unet_svhn")
    ratio = None
    if need_ratio:
        rem = "_ema" if ratio_ema else ""
        ratio = place_model(load_state_dict(
            RatioEstimatorMNISTSVHN(loss_type=loss_type, dtype=dtype),
            f"checkpoints/ratio_{loss_type}_mnist_svhn{rem}_best.pth",
            "ratio_mnist_svhn"), device)
    return place_model(fm_mnist, device), place_model(fm_svhn, device), ratio


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sample MNIST-SVHN pairs")
    parser.add_argument("--guidance_method", type=str, default="none",
                        choices=["none", "mc_feng", "grad", "mc_feng+grad",
                                 "smc"])
    parser.add_argument("--guidance_strength", type=float, default=0.5)
    parser.add_argument("--mc_batch_size", type=int, default=256)
    parser.add_argument("--loss_type", type=str, default="disc")
    parser.add_argument("--num_samples", type=int, default=32)
    parser.add_argument("--num_steps", type=int, default=100)
    add_solver_flag(parser)
    add_reflow_flag(parser)
    add_ema_flag(parser)
    add_smc_flags(parser)
    # experiment 2's SMC defaults: islands of 8, tau 0.7 (the JAX CLI's)
    parser.set_defaults(smc_group=8, smc_resample_tau=0.7)
    parser.add_argument("--ratio_clip", type=float, default=None,
                        help="Clip |log ratio| of MC samples")
    add_mc_refresh_flag(parser)
    parser.add_argument("--ess_floor", type=float, default=None,
                        help="Adaptive guidance: per-trajectory gamma_eff = "
                             "gamma*min(1, ESS/ess_floor)")
    add_common_flags(parser)
    args = parser.parse_args(argv)

    device = init_runtime(args, training=False)   # pins float32 (no TF32)
    generator = torch.Generator(device).manual_seed(args.seed)
    print(f"Random seed: {args.seed}")
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    fm_m, fm_s, ratio = load_mnist_svhn_models(
        args.loss_type, args.guidance_method != "none", device, dtype_of(args),
        args.reflow, args.ema, args.ratio_ema)

    print(f"\nSampling {args.num_samples} pairs "
          f"(method={args.guidance_method}, gamma={args.guidance_strength})")
    if args.guidance_method == "smc":
        samples_x, samples_y, diags = sample_smc_from_args(
            args, velocity_fn(fm_m), velocity_fn(fm_s), ratio_log_fn(ratio),
            (32, 32, 1), (32, 32, 3), generator)
    else:
        samples_x, samples_y, diags = sample_bimodal_guided(
            velocity_fn(fm_m), velocity_fn(fm_s),
            log_ratio_fn=None if ratio is None else ratio_log_fn(ratio),
            guidance_method=args.guidance_method,
            guidance_strength=args.guidance_strength,
            num_samples=args.num_samples, num_steps=args.num_steps,
            mc_batch_size=args.mc_batch_size,
            x_shape=(32, 32, 1), y_shape=(32, 32, 3), generator=generator,
            log_ratio_clip=args.ratio_clip, ess_floor=args.ess_floor,
            solver=args.solver, time_grid=args.time_grid,
            grid_power=args.grid_power, mc_refresh=args.mc_refresh,
            return_diagnostics=True)

    os.makedirs("outputs/mnist_svhn", exist_ok=True)
    tag = f"{args.guidance_method}_gamma{args.guidance_strength}"
    report_guidance_diagnostics(
        diags, args.num_steps,
        save_path=f"outputs/mnist_svhn/diagnostics_{tag}.json",
        time_grid=args.time_grid, grid_power=args.grid_power)
    try:
        from ratio_guided_multimodal_fm_tpu_torch.eval.viz import (
            visualize_pairs_mnist_svhn,
        )
        visualize_pairs_mnist_svhn(samples_x, samples_y,
                                   f"outputs/mnist_svhn/samples_{tag}.png")
    except ImportError as e:   # matplotlib is optional
        print(f"Skipped the PNG ({e})")
    print("\nSampling complete!")
    return samples_x, samples_y, diags


if __name__ == "__main__":
    main()
