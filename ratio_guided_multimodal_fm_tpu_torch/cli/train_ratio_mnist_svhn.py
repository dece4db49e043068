"""Train the asymmetric MNIST-SVHN ratio estimator (port of
cli/train_ratio_mnist_svhn.py).

Flag-parity with the JAX CLI (ref src/train_ratio_mnist_svhn.py:79-94);
patience 5, a periodic save every 10 epochs. Its BatchNorm encoders train
on batch statistics and update their running statistics each step
(models/ratio.py:BatchNorm2d, flax's momentum 0.9 and biased variance).
Writes bare state dicts checkpoints/ratio_{loss}_mnist_svhn_{best|epochN}
.pth with the BatchNorm buffers and, with --ema_decay,
ratio_{loss}_mnist_svhn_ema_best.pth (the EMA params with the current
running statistics), the files the experiment-2 sample and evaluate CLIs
read. float32, on the card unless --device cpu; --fused_steps and the
multi-process flags as in train_ratio.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_ratio_mnist_svhn \\
        --loss_type disc --epochs 30
"""
from __future__ import annotations

import argparse

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_ratio_train_flags,
    arm_preemption,
    init_runtime,
    run_ratio_training,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_mnist_svhn_ratio_dataloader,
    get_mnist_svhn_ratio_index_loader,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    RatioEstimatorMNISTSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    checkpoint_path,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train MNIST-SVHN ratio estimator")
    add_ratio_train_flags(parser)
    args = parser.parse_args(argv)

    device = init_runtime(args)
    arm_preemption()   # SIGTERM-safe from startup (train CLIs only)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")

    loader = None if args.fused_steps > 1 else (
        get_mnist_svhn_ratio_dataloader(
            batch_size=args.batch_size, real_fake_ratio=args.real_fake_ratio,
            train=True, root=args.data_root, seed=args.seed, device=device))
    return run_ratio_training(
        args, RatioEstimatorMNISTSVHN(loss_type=args.loss_type), loader,
        device, lambda part: checkpoint_path("ratio", args.loss_type,
                                             "mnist_svhn", part),
        index_loader=lambda: get_mnist_svhn_ratio_index_loader(
            batch_size=args.batch_size, fused_steps=args.fused_steps,
            real_fake_ratio=args.real_fake_ratio, root=args.data_root,
            seed=args.seed, device=device))


if __name__ == "__main__":
    main()
