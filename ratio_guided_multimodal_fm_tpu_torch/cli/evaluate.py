"""Evaluate the coherence of generated pairs over a (method × strength)
sweep, experiment 1: MNIST-28 ↔ a transformed MNIST (port of
cli/evaluate.py: methods 'none', 'mc_feng', 'grad', 'mc_feng+grad' and
'smc').

Loads reference-layout state dicts from ./checkpoints — the .pth files the
JAX package's `rgmf-export-torch --out ...` writes: the flows and the ratio
net as cli/sample.py reads them, and the eval classifier

    checkpoints/mnist_classifier.pth      (--model classifier_mnist)

Samples each configuration in chunks with a fresh MC set per chunk
(eval/chunked.py; one chunk for a method without an MC set, such as
smc), classifies x and the inverse-transformed y, and writes
outputs/evaluation_results.json with the JAX CLI's keys; `--fid` adds the
classifier-feature FID against the test set (eval/fid.py).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.evaluate \
        --guidance_methods none mc_feng grad --guidance_strengths 0 0.5 1
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_ema_flag,
    add_eval_flags,
    add_grad_flags,
    add_mc_refresh_flag,
    add_reflow_flag,
    add_smc_flags,
    add_solver_flag,
    classifier_fn,
    init_runtime,
    load_state_dict,
    maybe_merged_pair_fn,
    METHODS,
    ratio_log_fn,
    report_guidance_diagnostics,
    smc_config_from_args,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.sample import (
    SHAPE,
    load_exp1_flows,
    load_exp1_ratio,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_classifier_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.chunked import (
    sample_in_chunks,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.coherence import (
    evaluate_coherence,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.fid import (
    compute_fid,
    compute_inception_fid,
)
from ratio_guided_multimodal_fm_tpu_torch.models import MNISTClassifier
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    MC_METHODS,
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler_p,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.smc import make_smc_sampler

CHUNK_INFO_KEYS = ("n_chunks", "chunk_policy", "mc_set_ess", "ess_final_mean",
                   "ess_final_min", "ess_trajectory_min",
                   "ess_trajectory_mean")


def check_methods(methods) -> None:
    for m in methods:
        if m not in METHODS:
            raise SystemExit(f"ERROR: unknown guidance method {m!r}; one of "
                             f"{METHODS}")


def add_sweep_flags(parser: argparse.ArgumentParser):
    """The flags both evaluation CLIs share."""
    parser.add_argument("--guidance_methods", nargs="+",
                        default=["none", "mc_feng"],
                        help="any of: none, mc_feng, grad, mc_feng+grad, "
                             "smc (particle-filter guidance, sample/smc.py)")
    parser.add_argument("--guidance_strengths", nargs="+", type=float,
                        default=[0.0, 0.5, 1.0])
    parser.add_argument("--mc_batch_size", type=int, default=256)
    parser.add_argument("--loss_type", type=str, default="disc")
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--num_steps", type=int, default=100)
    add_solver_flag(parser)
    add_reflow_flag(parser)
    add_ema_flag(parser)
    add_smc_flags(parser)
    parser.add_argument("--ratio_clip", type=float, default=None,
                        help="Clip |log ratio| of MC samples")
    add_grad_flags(parser)
    parser.add_argument("--ess_floor", type=float, default=None,
                        help="Adaptive guidance: per-trajectory gamma_eff = "
                             "gamma*min(1, ESS/ess_floor)")
    add_mc_refresh_flag(parser)
    add_eval_flags(parser)
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="Path to an Inception network (TorchScript or "
                             "torchvision inception_v3 .pth) for true "
                             "Inception-FID beside --fid's classifier-"
                             "feature distance (eval/fid.py); none ships "
                             "with the repository")


def sweep_config(args, method: str, strength: float, x_shape, y_shape):
    return GuidedSamplerConfig(
        guidance_method=method, guidance_strength=strength,
        num_steps=args.num_steps, mc_batch_size=args.mc_batch_size,
        x_shape=x_shape, y_shape=y_shape, ess_floor=args.ess_floor,
        grad_strength=args.grad_strength, grad_scale=args.grad_scale,
        grad_t_max=args.grad_t_max, solver=args.solver,
        time_grid=args.time_grid, grid_power=args.grid_power,
        mc_refresh=args.mc_refresh)


def sample_config(args, method, strength, fm_x, fm_y, log_ratio, mc_cache,
                  device, x_shape, y_shape, fm_pair=None):
    """One configuration of the sweep in chunks (eval/chunked.py): returns
    (samples_x, samples_y, merged diagnostics, chunk info). `fm_pair`
    (--merged_unet) evaluates both flows as one network in the MC sets and
    the guided sampler, not in SMC, as in the JAX CLI."""
    make_mc = None
    if method in MC_METHODS and args.mc_refresh <= 1:
        def make_mc(gen):
            return generate_mc_set(
                fm_x, fm_y, log_ratio, gen, args.mc_batch_size, x_shape,
                y_shape, args.num_steps, log_ratio_clip=args.ratio_clip,
                solver=args.solver, time_grid=args.time_grid,
                grid_power=args.grid_power, fm_pair_fn=fm_pair)
    if method == "smc":
        smc = make_smc_sampler(fm_x, fm_y, smc_config_from_args(
            args, strength, x_shape, y_shape), log_ratio)

        def sample_chunk(gen, n_i, mc_ci):
            return smc(gen, n_i)
    else:
        sampler = make_guided_sampler_p(
            lambda _, x, t: fm_x(x, t), lambda _, y, t: fm_y(y, t),
            sweep_config(args, method, strength, x_shape, y_shape),
            None if log_ratio is None else (lambda _, x, y: log_ratio(x, y)),
            fm_pair_apply=None if fm_pair is None else (
                lambda _x, _y: fm_pair))

        def sample_chunk(gen, n_i, mc_ci):
            return sampler((None, None, None), gen, n_i, mc_ci)

    no_mc = ("mc_refresh>1: fresh candidate sets generated inside the "
             "sampler (refresh subsumes per-chunk sets)"
             if args.mc_refresh > 1 and method in MC_METHODS
             else "no MC set (method has no candidate pool)")
    print(f"  Sampling {args.num_samples} pairs...")
    out = sample_in_chunks(sample_chunk, make_mc, args.num_samples,
                           args.seed, device, eval_chunks=args.eval_chunks,
                           auto_chunks=args.auto_chunks,
                           mc_cache=mc_cache.setdefault(method, {}),
                           no_mc_reason=no_mc)
    report_guidance_diagnostics(out[2], args.num_steps,
                                time_grid=args.time_grid,
                                grid_power=args.grid_power)
    return out


def base_result(args, method, strength, metrics, chunk_info, diags) -> dict:
    """The JAX CLIs' result keys of one configuration; `diags` are the
    merged diagnostics of its chunks (numpy)."""
    result = {"method": method, "guidance_strength": strength}
    if getattr(args, "transform_type", None) is not None:
        result["transform_type"] = args.transform_type
    result.update({k: metrics[k] for k in (
        "coherence_acc", "num_samples", "label_entropy_x",
        "label_entropy_y")})
    result.update({k: chunk_info[k] for k in CHUNK_INFO_KEYS
                   if k in chunk_info})
    if args.mc_refresh > 1 and method in MC_METHODS:
        result["mc_refresh"] = args.mc_refresh
    if method == "smc":
        result["smc_final_ess"] = float(np.mean(diags["final_ess"]))
        # the sum over steps of 'resampled': an event count in global mode,
        # the island-average event count in island mode
        result["smc_resamples"] = float(np.sum(diags["resampled"]))
        result["smc_churn"] = args.smc_churn
        result["smc_resample_tau"] = args.smc_resample_tau
    return result


def write_results(results, output_path: str) -> None:
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nResults saved to: {output_path}")
    print("\nSummary:")
    for r in results:
        print(f"  {r['method']:20s} gamma={r['guidance_strength']:.1f} "
              f"-> coherence={r['coherence_acc']:.3f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate guided sampling")
    parser.add_argument("--transform_type", type=str, default="rotate90")
    add_sweep_flags(parser)
    parser.add_argument("--model", type=str, default="unet",
                        choices=["unet", "original"])
    parser.add_argument("--save_samples", action="store_true",
                        help="Save generated samples per config as "
                             "outputs/samples_{method}_gamma{g}_{transform}"
                             ".npz")
    add_common_flags(parser)
    args = parser.parse_args(argv)
    check_methods(args.guidance_methods)

    device = init_runtime(args, training=False)   # pins float32 (no TF32)
    print(f"Random seed: {args.seed}")

    clf = place_model(load_state_dict(
        MNISTClassifier(), os.path.join("checkpoints",
                                        "mnist_classifier.pth"),
        "classifier_mnist"), device)
    classify = classifier_fn(clf)
    fm_x_net, fm_y_net = load_exp1_flows(args, device)
    fm_x, fm_y = velocity_fn(fm_x_net), velocity_fn(fm_y_net)
    fm_pair = maybe_merged_pair_fn(fm_x_net, fm_y_net, args)
    if fm_pair is not None:
        print("  Merged-pair evaluation of FM_x and FM_y")

    real_images = None
    if args.fid:
        loader = get_classifier_dataloader(batch_size=args.num_samples,
                                           train=False, root=args.data_root)
        real_images = next(iter(loader))["x"]

    results = []
    mc_cache = {}
    for method in args.guidance_methods:
        for strength in args.guidance_strengths:
            if method == "none" and strength > 0:
                continue
            print(f"\n{'=' * 60}\nEvaluating: method={method}, "
                  f"gamma={strength}\n{'=' * 60}")
            log_ratio = None
            if method != "none":
                try:
                    log_ratio = ratio_log_fn(load_exp1_ratio(args, device))
                except SystemExit as e:
                    print(f"ERROR: Ratio estimator not found ({e})")
                    continue
            samples_x, samples_y, diags, chunk_info = sample_config(
                args, method, strength, fm_x, fm_y, log_ratio, mc_cache,
                device, SHAPE, SHAPE, fm_pair)
            metrics = evaluate_coherence(samples_x, samples_y, classify,
                                         args.transform_type)
            result = base_result(args, method, strength, metrics, chunk_info,
                                 diags)
            if real_images is not None:
                # Frechet distance on eval-classifier features, NOT
                # Inception-FID (eval/fid.py)
                result["classifier_fid_x"] = compute_fid(
                    clf, real_images, samples_x.cpu().numpy())
                if args.inception_weights:
                    result["inception_fid_x"] = compute_inception_fid(
                        real_images, samples_x, args.inception_weights,
                        device=device)
            if args.save_samples:
                os.makedirs("outputs", exist_ok=True)
                np.savez_compressed(
                    f"outputs/samples_{method}_gamma{strength}"
                    f"_{args.transform_type}.npz",
                    x=samples_x.cpu().numpy(), y=samples_y.cpu().numpy())
            results.append(result)
            print(f"  -> Coherence accuracy: {metrics['coherence_acc']:.3f}")

    write_results(results, os.path.join("outputs", "evaluation_results.json"))
    return results


if __name__ == "__main__":
    main()
