"""Evaluate MNIST-SVHN guided sampling over a (method × strength) sweep:
dual-classifier coherence (+ classifier-FID), experiment 2 (port of
cli/evaluate_mnist_svhn.py: methods 'none', 'mc_feng', 'grad',
'mc_feng+grad' and 'smc', whose defaults here are islands of 8 and
--smc_resample_tau 0.7, as in the JAX CLI).

Loads reference-layout state dicts from ./checkpoints: the flows and the
ratio net as cli/sample_mnist_svhn.py reads them, and the classifiers

    checkpoints/mnist32_classifier.pth    (--model classifier_mnist32)
    checkpoints/svhn_classifier.pth       (--model classifier_svhn)

and writes outputs/mnist_svhn/evaluation_results.json with the JAX CLI's
keys.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.evaluate_mnist_svhn \
        --guidance_methods none mc_feng grad --fid
"""
from __future__ import annotations

import argparse
import os

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    classifier_fn,
    dtype_of,
    init_runtime,
    load_state_dict,
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.evaluate import (
    add_sweep_flags,
    base_result,
    check_methods,
    sample_config,
    write_results,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.sample_mnist_svhn import (
    load_mnist_svhn_models,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_mnist32_flow_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.coherence import (
    evaluate_coherence_dual,
)
from ratio_guided_multimodal_fm_tpu_torch.eval.fid import (
    compute_fid,
    compute_inception_fid,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    MNISTClassifier32,
    SVHNClassifier,
)

X_SHAPE, Y_SHAPE = (32, 32, 1), (32, 32, 3)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate MNIST-SVHN sampling")
    add_sweep_flags(parser)
    # experiment 2's SMC defaults: islands of 8, tau 0.7 (the JAX CLI's)
    parser.set_defaults(smc_group=8, smc_resample_tau=0.7)
    add_common_flags(parser)
    args = parser.parse_args(argv)
    check_methods(args.guidance_methods)

    device = init_runtime(args, training=False)   # pins float32 (no TF32)
    print(f"Random seed: {args.seed}")

    clf_m = place_model(load_state_dict(
        MNISTClassifier32(), "checkpoints/mnist32_classifier.pth",
        "classifier_mnist32"), device)
    clf_s = place_model(load_state_dict(
        SVHNClassifier(), "checkpoints/svhn_classifier.pth",
        "classifier_svhn"), device)
    classify_m, classify_s = classifier_fn(clf_m), classifier_fn(clf_s)

    need_ratio = any(m != "none" for m in args.guidance_methods)
    fm_m, fm_s, ratio = load_mnist_svhn_models(
        args.loss_type, need_ratio, device, dtype_of(args), args.reflow,
        args.ema, args.ratio_ema)
    log_ratio = None if ratio is None else ratio_log_fn(ratio)

    real_m = None
    if args.fid:
        n = min(args.num_samples, 1000)
        real_m = next(iter(get_mnist32_flow_dataloader(
            n, False, args.data_root)))["x"]

    results = []
    mc_cache = {}
    v_m, v_s = velocity_fn(fm_m), velocity_fn(fm_s)
    for method in args.guidance_methods:
        for strength in args.guidance_strengths:
            if method == "none" and strength > 0:
                continue
            print(f"\n{'=' * 60}\nEvaluating: method={method}, "
                  f"gamma={strength}\n{'=' * 60}")
            samples_x, samples_y, diags, chunk_info = sample_config(
                args, method, strength, v_m, v_s,
                log_ratio if method != "none" else None, mc_cache, device,
                X_SHAPE, Y_SHAPE)
            metrics = evaluate_coherence_dual(samples_x, samples_y,
                                              classify_m, classify_s)
            result = base_result(args, method, strength, metrics, chunk_info,
                                 diags)
            if real_m is not None:
                # classifier-feature Frechet distance, not Inception-FID
                result["classifier_fid_mnist"] = compute_fid(
                    clf_m, real_m, samples_x.cpu().numpy())
                if args.inception_weights:
                    result["inception_fid_mnist"] = compute_inception_fid(
                        real_m, samples_x, args.inception_weights,
                        device=device)
            results.append(result)
            print(f"  -> Coherence accuracy: {metrics['coherence_acc']:.3f}")

    write_results(results, os.path.join("outputs", "mnist_svhn",
                                        "evaluation_results.json"))
    return results


if __name__ == "__main__":
    main()
