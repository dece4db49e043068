"""Train an independent flow-matching model for modality x or y of
experiment 1 (MNIST-28 and a transformed MNIST; port of
cli/train_flow.py).

Flag-parity with the JAX CLI (ref src/train_flow.py:26-49). Writes bare
state dicts checkpoints/flow_{modality}[_{transform}]_{best|epochN}.pth
and, with --ema_decay, flow_{modality}[_{transform}]_ema_best.pth: the
files the experiment-1 sample and evaluate CLIs read. float32, on the card
unless --device cpu. --model original trains the encoder-decoder
FlowMatchingModel; --model sit_xl_2|sit_s_2 trains the class-conditional
SiT transformer (models/sit.py) on pre-extracted latents, --latents
<file.npz> holding `latents` [N, 32, 32, 4] float32 and `labels` [N]
integers (the form fast-DiT-style training reads), through the fused
trainer with the labels on the device, and writes
checkpoints/flow_{model}_{best|epochN}.pth (no --modality there); --metrics_dir appends each epoch's metrics to
<dir>/flow_{modality}.jsonl and --profile_dir writes a torch.profiler
Chrome trace of the run there, with the run's program spans (each
train.fm.call and its graph's spans) in a Chrome trace beside it on the
profiler's clock (core/observability.py). --fused_steps K
takes K optimizer steps a dispatch (one CUDA graph replay on the card);
with --coordinator_address/--num_processes/--process_id each rank trains
on its rows of the global batch (data-parallel).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_flow \\
        --modality y --transform_type rotate90 --epochs 50
    python -m ratio_guided_multimodal_fm_tpu_torch.cli.train_flow \\
        --model sit_xl_2 --latents in256_latents.npz --batch_size 32 \\
        --fused_steps 2 --ema_decay 0.9999
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_fast_rng_flag,
    add_fused_flag,
    arm_preemption,
    count_params,
    fm_model,
    init_runtime,
    multihost_adapt,
)
from ratio_guided_multimodal_fm_tpu_torch.core.observability import (
    MetricsLogger,
    profile_trace,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, set_seed
from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    get_flow_dataloader,
    get_flow_dataset,
    get_index_chunk_loader,
)
from ratio_guided_multimodal_fm_tpu_torch.models.sit import SiT_S_2, SiT_XL_2
from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
    is_writer,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    checkpoint_path,
)
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    epoch_data_iter,
    finish_preemptible,
    restore_preempt,
    train_flow_matching_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_fm_state,
    make_fm_train_multistep,
    make_fm_train_step,
)

SIT_MODELS = {"sit_xl_2": SiT_XL_2, "sit_s_2": SiT_S_2}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Flow Matching model")
    parser.add_argument("--modality", type=str, default=None,
                        choices=["x", "y"],
                        help="Modality to train (x=standard, y=transformed); "
                             "required for --model unet|original")
    parser.add_argument("--transform_type", type=str, default="rotate90",
                        help="Transformation type for y modality")
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--save_every", type=int, default=10,
                        help="Save checkpoint every N epochs")
    parser.add_argument("--patience", type=int, default=10,
                        help="Early stopping patience")
    parser.add_argument("--model", type=str, default="unet",
                        choices=["unet", "original", *SIT_MODELS])
    parser.add_argument("--latents", type=str, default=None,
                        help="--model sit_*: an .npz of `latents` [N, 32, "
                             "32, 4] float32 and `labels` [N] integers")
    parser.add_argument("--ema_decay", type=float, default=None,
                        help="Polyak-average the weights with this decay "
                             "(e.g. 0.999); best saves also write "
                             "flow_*_ema_best.pth, loadable with --ema on "
                             "the sample/evaluate CLIs")
    add_fused_flag(parser)
    add_fast_rng_flag(parser)
    parser.add_argument("--metrics_dir", type=str, default=None,
                        help="Write JSONL epoch metrics here (observability)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the "
                             "training run here, and its program spans "
                             "beside it (spans_*.json)")
    parser.add_argument("--preempt_path", type=str, default=None,
                        help="Preemption-safe training: on SIGTERM, save a "
                             "step-granular resumable checkpoint here and "
                             "exit; if it exists at startup, resume from it "
                             "(bit-exact against the uninterrupted run)")
    add_common_flags(parser)
    args = parser.parse_args(argv)
    sit = args.model in SIT_MODELS
    if sit and not args.latents:
        parser.error(f"--model {args.model} trains on --latents <file.npz>")
    if not sit and args.modality is None:
        parser.error(f"--model {args.model} needs --modality x|y")

    device = init_runtime(args)
    arm_preemption()   # SIGTERM-safe from startup (train CLIs only)
    set_seed(args.seed)
    print(f"Random seed: {args.seed}; device: {device}")

    transform = None
    if sit:
        print(f"Training {args.model} on {args.latents}")
    else:
        print(f"Training modality: {args.modality}")
        if args.modality == "y":
            transform = args.transform_type
            print(f"Transform type: {args.transform_type}")

    model = SIT_MODELS[args.model]() if sit else fm_model(args.model)
    state = create_fm_state(model, device, lr=args.lr,
                            ema_decay=args.ema_decay)
    print(f"Model parameters: {count_params(state.model):,}")

    # a preempted run left {weights, optimiser, EMA, epoch, step, partial
    # loss sums}: restore them and skip to that position
    state, resume = restore_preempt(args.preempt_path, state)
    if resume["start_epoch"] or resume["start_step"]:
        print(f"Resuming preempted run: epoch {resume['start_epoch']}, "
              f"step {resume['start_step']} "
              f"(best {resume['start_best']:.4f})")

    modality = args.model if sit else args.modality
    if sit or args.fused_steps > 1:
        # K optimizer steps a dispatch over the dataset on the device (and
        # its labels, for SiT): the driver iterates macro steps ([K, B]
        # index chunks); SiT trains this way at every K, 1 included
        labels = None
        if sit:
            with np.load(args.latents) as f:
                dataset = torch.from_numpy(np.ascontiguousarray(
                    f["latents"], np.float32)).to(device)
                labels = torch.from_numpy(f["labels"].astype(np.int64)).to(
                    device)
            print(f"{len(dataset):,} latents")
        else:
            dataset = get_flow_dataset(transform, True, args.data_root,
                                       device)
        loader = get_index_chunk_loader(len(dataset), args.batch_size,
                                        args.fused_steps, seed=args.seed)
        fused = make_fm_train_multistep(args.ema_decay)

        def step(s, idx, g):
            return fused(s, dataset, idx, g, labels=labels)

        print(f"Fused dispatch: {args.fused_steps} steps/program, "
              f"{len(loader)} programs/epoch (epoch logs count programs)")
        data_iter = epoch_data_iter(loader)
    else:
        loader = get_flow_dataloader(transform_type=transform,
                                     batch_size=args.batch_size, train=True,
                                     root=args.data_root, seed=args.seed,
                                     device=device)
        state, step, extract = multihost_adapt(
            state, make_fm_train_step(args.ema_decay), lambda b: b[modality])
        data_iter = epoch_data_iter(loader, extract)
    metrics_logger = (MetricsLogger(args.metrics_dir, f"flow_{modality}")
                      if args.metrics_dir and is_writer() else None)
    try:
        with profile_trace(args.profile_dir):
            state, best, history = train_flow_matching_epochs(
                state, step, data_iter, args.epochs,
                RNG(args.seed + 1, device),
                best_path=checkpoint_path("flow", modality, transform,
                                          "best"),
                periodic_path_fn=lambda e: checkpoint_path(
                    "flow", modality, transform, f"epoch{e}"),
                save_every=args.save_every, patience=args.patience,
                metrics_logger=metrics_logger,
                preempt_path=args.preempt_path, **resume)
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
    if not finish_preemptible(history, args.preempt_path):
        print("\nTraining complete!")
    return state, best, history


if __name__ == "__main__":
    main()
