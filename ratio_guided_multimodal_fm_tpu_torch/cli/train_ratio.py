"""Train the experiment-1 ratio estimator r̂(x, y) for an MNIST transform
(port of cli/train_ratio.py).

Flag-parity with the JAX CLI (ref src/train_ratio.py:23-48); patience is
fixed at 5 and a periodic save comes every 10 epochs, as in the reference.
Writes bare state dicts checkpoints/ratio_{loss}_{transform}_{best|epochN}
.pth and, with --ema_decay, ratio_{loss}_{transform}_ema_best.pth: the
files the experiment-1 sample and evaluate CLIs read (--ratio_ema for the
EMA). float32, on the card unless --device cpu; every step runs the
GroupNorm+SiLU forward kernel and its backward with dγ/dβ at the net's 8
GN sites. --fused_steps K takes K optimizer steps a dispatch (one CUDA
graph replay on the card); the multi-process flags train data-parallel.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_ratio \\
        --loss_type disc --transform_type rotate90 --epochs 30
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
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_ratio_dataloader,
    get_ratio_index_loader,
)
from ratio_guided_multimodal_fm_tpu_torch.models import RatioEstimatorMNIST
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    checkpoint_path,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train ratio estimator")
    parser.add_argument("--transform_type", type=str, default="rotate90")
    parser.add_argument("--rulsif_alpha", type=float, default=0.2)
    parser.add_argument("--lambda_penalty", type=float, default=0.1)
    add_ratio_train_flags(parser)
    args = parser.parse_args(argv)

    device = init_runtime(args)
    arm_preemption()   # SIGTERM-safe from startup (train CLIs only)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")

    loader = None if args.fused_steps > 1 else get_ratio_dataloader(
        transform_type=args.transform_type, batch_size=args.batch_size,
        real_fake_ratio=args.real_fake_ratio, root=args.data_root,
        seed=args.seed, device=device)
    print(f"Transform type: {args.transform_type}")
    print(f"Loss type: {args.loss_type}")
    print(f"Real/fake ratio: {args.real_fake_ratio}")

    return run_ratio_training(
        args, RatioEstimatorMNIST(loss_type=args.loss_type), loader, device,
        lambda part: checkpoint_path("ratio", args.loss_type,
                                     args.transform_type, part),
        index_loader=lambda: get_ratio_index_loader(
            transform_type=args.transform_type, batch_size=args.batch_size,
            fused_steps=args.fused_steps,
            real_fake_ratio=args.real_fake_ratio, root=args.data_root,
            seed=args.seed, device=device),
        alpha=args.rulsif_alpha, lambda_penalty=args.lambda_penalty)


if __name__ == "__main__":
    main()
