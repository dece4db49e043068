"""Train the MNIST-28 evaluation classifier (port of
cli/train_classifier.py) -> checkpoints/mnist_classifier.pth.

Flag-parity with the JAX CLI (ref src/train_classifier.py:72-80: 3
epochs, Adam lr 1e-3); the bare reference-layout state dict it writes is
the file the experiment-1 evaluate CLI reads. float32, on the card unless
--device cpu.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_classifier
"""
from __future__ import annotations

import argparse

import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_train_runtime_flags,
    count_params,
    init_runtime,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_classifier_dataloader,
)
from ratio_guided_multimodal_fm_tpu_torch.models import MNISTClassifier
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_classifier_state,
    make_classifier_train_step,
)


def add_classifier_flags(p: argparse.ArgumentParser, epochs: int):
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    add_train_runtime_flags(p)
    add_common_flags(p)


def _mean(outs) -> float:
    return (float(torch.stack(outs).double().mean()) if outs
            else float("nan"))


@torch.no_grad()
def test_accuracy(model: torch.nn.Module, loader) -> float:
    """Top-1 accuracy over the loader's batches in eval mode (dropout off,
    BatchNorm on running statistics); the model returns to train mode."""
    model.eval()
    correct = total = 0
    for b in loader.epoch(0):
        pred = model(b["x"]).argmax(-1).cpu().numpy()
        correct += int((pred == b["label"]).sum())
        total += len(pred)
    model.train()
    return correct / max(total, 1)


def train_classifier(name: str, model: torch.nn.Module, train_loader,
                     test_loader, epochs: int, lr: float, seed: int,
                     device, out_path: str):
    """Adam(lr) for `epochs` epochs of the train loader (step (epoch, i)
    seeds its dropout from RNG(seed + 1).generator(epoch, i)), the test
    accuracy after each, then the bare state dict (BatchNorm buffers
    included) to `out_path`. Returns (state, history)."""
    state = create_classifier_state(model, device, lr=lr)
    print(f"\n=== Training {name} ===")
    print(f"Parameters: {count_params(state.model):,}")
    step = make_classifier_train_step()
    rng = RNG(seed + 1, device)
    history = []
    for epoch in range(epochs):
        losses, accs = [], []
        for i, b in enumerate(train_loader.epoch(epoch)):
            loss, acc = step(state, b["x"], b["label"],
                             rng.generator(epoch, i))
            losses.append(loss)
            accs.append(acc)
        row = {"epoch": epoch + 1, "loss": _mean(losses),
               "train_acc": _mean(accs),
               "test_acc": test_accuracy(state.model, test_loader)}
        print(f"Epoch {epoch+1}/{epochs} - loss: {row['loss']:.4f} - "
              f"train_acc: {row['train_acc']:.4f} - "
              f"test_acc: {row['test_acc']:.4f}")
        history.append(row)
    save_checkpoint(out_path, state.model.state_dict())
    print(f"Saved: {out_path}")
    return state, history


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train MNIST classifier")
    add_classifier_flags(parser, epochs=3)
    args = parser.parse_args(argv)

    device = init_runtime(args)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")
    train_loader = get_classifier_dataloader(
        args.batch_size, train=True, root=args.data_root, seed=args.seed,
        device=device)
    test_loader = get_classifier_dataloader(
        args.batch_size, train=False, root=args.data_root, seed=args.seed,
        device=device)
    return train_classifier(
        "MNIST classifier", MNISTClassifier(), train_loader, test_loader,
        args.epochs, args.lr, args.seed, device,
        "checkpoints/mnist_classifier.pth")


if __name__ == "__main__":
    main()
