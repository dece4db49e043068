"""Train the flow-matching U-Net on MNIST-32 (experiment 2, modality x;
port of cli/train_flow_mnist32.py).

Flag-parity with the JAX CLI (ref src/train_flow_mnist32.py:64-81) incl.
--resume, --ema_decay and --preempt_path; float32, on the card unless
--device cpu. Writes reference-layout .pth files that the sample and
evaluate CLIs read as they are: checkpoints/flow_mnist32_best.pth and
flow_mnist32_epoch{N}.pth (resumable full dicts) and, with --ema_decay,
flow_mnist32_ema_best.pth (a bare state dict, read with --ema).
--fused_steps K takes K optimizer steps a dispatch (one CUDA graph replay
on the card); the multi-process flags train data-parallel.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_flow_mnist32 \\
        --epochs 50 --ema_decay 0.999
"""
from __future__ import annotations

import argparse

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_fast_rng_flag,
    add_fused_flag,
    arm_preemption,
    count_params,
    init_runtime,
    multihost_adapt,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_index_chunk_loader,
)
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_svhn import (
    get_mnist32_flow_dataloader,
    mnist32_dataset,
)
from ratio_guided_multimodal_fm_tpu_torch.models import FlowMatchingUNetMNIST
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    checkpoint_path,
    load_checkpoint,
    save_checkpoint,
    save_train_checkpoint,
)
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    epoch_data_iter,
    finish_preemptible,
    restore_preempt,
    train_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    make_fm_train_multistep,
    make_fm_train_step,
)


def add_flow_train_flags(parser: argparse.ArgumentParser, name: str):
    """The flags the MNIST-32 and SVHN flow CLIs share."""
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--save_every", type=int, default=10)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to checkpoint to resume from (e.g. "
                             f"checkpoints/{name}_best.pth)")
    parser.add_argument("--ema_decay", type=float, default=None,
                        help="Polyak-average the weights with this decay "
                             "(e.g. 0.999); best saves also write "
                             f"{name}_ema_best.pth, loadable with --ema on "
                             "the sample/evaluate CLIs")
    parser.add_argument("--preempt_path", type=str, default=None,
                        help="Preemption-safe training: on SIGTERM, save a "
                             "step-granular resumable checkpoint here and "
                             "exit; if it exists at startup, resume from it")
    add_fused_flag(parser)
    add_fast_rng_flag(parser)
    add_common_flags(parser)


def run_flow_training(model, loader, args, ckpt_prefix: str, device,
                      dataset_fn=None):
    """Shared driver of the MNIST-32 and SVHN flow CLIs: --resume (the
    full dict, or bare weights), step-granular --preempt_path preemption
    (it takes precedence over --resume), best and periodic resumable
    saves, the EMA file. `loader()` gives the batch loader; with
    --fused_steps K > 1 `dataset_fn()` gives the whole modality on the
    device instead and each driver step is a fused K-step macro step.
    Multi-process runs train data-parallel. Returns (state, best loss,
    history)."""
    ema_decay = args.ema_decay
    state = create_fm_state(model, device, lr=args.lr, ema_decay=ema_decay)
    print(f"Model parameters: {count_params(state.model):,}")

    start_epoch, best_loss = 0, float("inf")
    if args.resume:
        print(f"Resuming from checkpoint: {args.resume}")
        ckpt = load_checkpoint(args.resume)
        state.model.load_state_dict(ckpt.get("model_state_dict", ckpt))
        if "optimizer_state_dict" in ckpt:
            state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
            start_epoch = int(ckpt["epoch"])
            best_loss = float(ckpt["best_loss"])
        if state.ema is not None:
            # the EMA restarts from the RESTORED weights (a copy), or the
            # random init would leak into it for ~1/(1-decay) steps
            state.reset_ema()
        print(f"  Resumed at epoch {start_epoch}, best_loss={best_loss:.4f}")

    state, resume = restore_preempt(args.preempt_path, state)
    if resume["start_epoch"] or resume["start_step"]:
        print(f"Resuming preempted run: epoch {resume['start_epoch']}, "
              f"step {resume['start_step']} "
              f"(best {resume['start_best']:.4f})")
    else:
        resume["start_epoch"] = start_epoch    # from --resume (epoch-level)
        resume["start_best"] = best_loss

    def save_best(s, epoch, best):
        path = checkpoint_path(ckpt_prefix, "best")
        save_train_checkpoint(path, s, epoch, best)
        print(f"  -> Saved best model: {path}")
        if s.ema is not None:
            epath = checkpoint_path(ckpt_prefix, "ema", "best")
            save_checkpoint(epath, s.ema)
            print(f"  -> Saved EMA model: {epath}")

    def save_periodic(s, epoch, best):
        path = checkpoint_path(ckpt_prefix, f"epoch{epoch}")
        save_train_checkpoint(path, s, epoch, best)
        print(f"  -> Saved checkpoint: {path}")

    if args.fused_steps > 1:
        dataset = dataset_fn()
        chunks = get_index_chunk_loader(len(dataset), args.batch_size,
                                        args.fused_steps, seed=args.seed)
        fused = make_fm_train_multistep(ema_decay)

        def step(s, idx, g):
            return fused(s, dataset, idx, g)

        print(f"Fused dispatch: {args.fused_steps} steps/program, "
              f"{len(chunks)} programs/epoch (epoch logs count programs)")
        data_iter = epoch_data_iter(chunks)
    else:
        state, step, extract = multihost_adapt(
            state, make_fm_train_step(ema_decay), lambda b: b["x"])
        data_iter = epoch_data_iter(loader(), extract)

    state, best, history = train_epochs(
        state, step, data_iter, args.epochs, RNG(args.seed + 1, device),
        save_best_fn=save_best, save_periodic_fn=save_periodic,
        save_every=args.save_every, patience=args.patience,
        preempt_path=args.preempt_path, **resume)
    if not finish_preemptible(history, args.preempt_path):
        print("\nTraining complete!")
        print(f"Best loss: {best:.4f}")
    return state, best, history


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train FM on MNIST 32x32")
    add_flow_train_flags(parser, "flow_mnist32")
    args = parser.parse_args(argv)

    device = init_runtime(args)
    arm_preemption()   # SIGTERM-safe from startup (train CLIs only)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")
    return run_flow_training(
        FlowMatchingUNetMNIST(img_size=32),
        lambda: get_mnist32_flow_dataloader(args.batch_size, True,
                                            args.data_root, seed=args.seed,
                                            device=device),
        args, "flow_mnist32", device,
        dataset_fn=lambda: mnist32_dataset(True, args.data_root, device))


if __name__ == "__main__":
    main()
