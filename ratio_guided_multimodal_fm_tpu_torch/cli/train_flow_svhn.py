"""Train the flow-matching U-Net on SVHN (experiment 2, modality y; port of
cli/train_flow_svhn.py).

Flag-parity with the JAX CLI (ref src/train_flow_svhn.py:84-101) incl.
--resume; writes checkpoints/flow_svhn_{best|epochN}.pth (resumable full
dicts) and, with --ema_decay, flow_svhn_ema_best.pth. float32, on the card
unless --device cpu; --fused_steps and the multi-process flags as in
train_flow_mnist32.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_flow_svhn \\
        --epochs 1 --ema_decay 0.999
"""
from __future__ import annotations

import argparse

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    arm_preemption,
    init_runtime,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.train_flow_mnist32 import (
    add_flow_train_flags,
    run_flow_training,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_svhn_flow_dataloader,
    svhn_dataset,
)
from ratio_guided_multimodal_fm_tpu_torch.models import FlowMatchingUNetSVHN


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train FM on SVHN")
    add_flow_train_flags(parser, "flow_svhn")
    args = parser.parse_args(argv)

    device = init_runtime(args)
    arm_preemption()   # SIGTERM-safe from startup (train CLIs only)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")
    return run_flow_training(
        FlowMatchingUNetSVHN(),
        lambda: get_svhn_flow_dataloader(args.batch_size, True,
                                         args.data_root, seed=args.seed,
                                         device=device),
        args, "flow_svhn", device,
        dataset_fn=lambda: svhn_dataset(True, args.data_root, device))


if __name__ == "__main__":
    main()
