"""Train the experiment-2 evaluation classifiers (port of
cli/train_classifiers_mnist_svhn.py) -> checkpoints/mnist32_classifier.pth
and checkpoints/svhn_classifier.pth (with its BatchNorm buffers), the files
the experiment-2 evaluate CLI reads.

Flag-parity with the JAX CLI (ref src/train_classifiers_mnist_svhn.py:
116-127: 10 epochs, Adam lr 1e-3); as there, the loaders keep their own
seed 0 and --seed seeds the weights and the dropout masks. float32, on the
card unless --device cpu.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.\\
train_classifiers_mnist_svhn
"""
from __future__ import annotations

import argparse

from ratio_guided_multimodal_fm_tpu_torch.cli.common import init_runtime
from ratio_guided_multimodal_fm_tpu_torch.cli.train_classifier import (
    add_classifier_flags,
    train_classifier,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_mnist32_flow_dataloader,
    get_svhn_flow_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    MNISTClassifier32,
    SVHNClassifier,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train MNIST32 and SVHN classifiers")
    add_classifier_flags(parser, epochs=10)
    args = parser.parse_args(argv)

    device = init_runtime(args)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")
    out = {}
    for name, make_loader, model, path in (
            ("MNIST32 classifier", get_mnist32_flow_dataloader,
             MNISTClassifier32, "checkpoints/mnist32_classifier.pth"),
            ("SVHN classifier", get_svhn_flow_dataloader, SVHNClassifier,
             "checkpoints/svhn_classifier.pth")):
        train_loader, test_loader = (
            make_loader(args.batch_size, train, args.data_root, device=device)
            for train in (True, False))
        out[path] = train_classifier(name, model(), train_loader,
                                     test_loader, args.epochs, args.lr,
                                     args.seed, device, path)
    return out


if __name__ == "__main__":
    main()
