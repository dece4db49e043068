"""Reflow-distill a trained flow for few-step sampling (port of
cli/reflow.py; flow/reflow.py).

Reads the teacher's reference-layout .pth and writes the student next to it
with a `_reflow` name part, the file the sample, evaluate and serve CLIs
load with --reflow (then sample with e.g. `--num_steps 8`, or `--solver
midpoint --num_steps 4`):

    checkpoints/flow_x_best.pth          -> flow_x_reflow_best.pth
    checkpoints/flow_y_{t}_best.pth      -> flow_y_{t}_reflow_best.pth
    checkpoints/flow_mnist32_best.pth    -> flow_mnist32_reflow_best.pth
    checkpoints/flow_svhn_best.pth       -> flow_svhn_reflow_best.pth

Each round generates --pairs couplings from the current teacher (the
previous round's student from round 2 on), warm-starts the student from it
with a fresh Adam state, and trains --epochs epochs over the couplings in
the JAX CLI's batch order; the parameters of the epoch with the lowest mean
loss are kept. float32, on the card unless --device cpu.

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.reflow --modality x
    python -m ratio_guided_multimodal_fm_tpu_torch.cli.reflow \\
        --experiment mnist_svhn --flow svhn
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    add_common_flags,
    add_solver_flag,
    add_train_runtime_flags,
    checkpoint_path,
    count_params,
    fm_bridge,
    fm_model,
    init_runtime,
    load_state_dict,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import place_model
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed, set_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.reflow import (
    generate_couplings,
    make_reflow_train_step,
)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingUNetMNIST,
    FlowMatchingUNetSVHN,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    save_train_checkpoint,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import create_fm_state


def _resolve(args):
    """(model factory, sample shape, teacher path, student path, the
    exporter's model kind) of the flow to distill."""
    if args.experiment == "mnist_svhn":
        if args.flow == "mnist32":
            return (lambda: FlowMatchingUNetMNIST(img_size=32), (32, 32, 1),
                    checkpoint_path("flow", "mnist32", "best"),
                    checkpoint_path("flow", "mnist32", "reflow", "best"),
                    "unet_mnist")
        return (FlowMatchingUNetSVHN, (32, 32, 3),
                checkpoint_path("flow", "svhn", "best"),
                checkpoint_path("flow", "svhn", "reflow", "best"),
                "unet_svhn")
    transform = args.transform_type if args.modality == "y" else None
    return (lambda: fm_model(args.model), (28, 28, 1),
            checkpoint_path("flow", args.modality, transform, "best"),
            checkpoint_path("flow", args.modality, transform, "reflow",
                            "best"),
            fm_bridge(args.model))


def _copy(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_reflow(make_model, sample_shape, teacher_path: str,
               student_path: str, model_kind: str, args,
               device: torch.device) -> float:
    """The rounds of the module docstring; saves the student as a resumable
    training dict (a fresh Adam state, as JAX saves it) and returns the
    best mean epoch loss of the last round."""
    teacher = place_model(load_state_dict(make_model(), teacher_path,
                                          model_kind), device)
    params = _copy(teacher)
    step = make_reflow_train_step()
    bs = args.batch_size
    best = float("inf")
    for r in range(args.rounds):
        teacher.load_state_dict(params)
        t0 = time.perf_counter()
        x0, x1 = generate_couplings(
            lambda m, x, t: velocity_fn(m)(x, t), teacher,
            derive_seed(args.seed, 1000 + r), args.pairs, sample_shape,
            num_steps=args.teacher_steps, solver=args.solver,
            gen_batch_size=args.gen_batch_size, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)     # the print's time is real
        print(f"[round {r + 1}/{args.rounds}] {len(x0)} couplings in "
              f"{time.perf_counter() - t0:.1f}s ({args.teacher_steps}-step "
              f"{args.solver} teacher)")

        # the student warm-starts from the current teacher (standard reflow:
        # the velocity field barely changes, the coupling does)
        student = make_model()
        student.load_state_dict(params)
        state = create_fm_state(student, device, lr=args.lr)
        if r == 0:
            print(f"Model parameters: {count_params(state.model):,}")
        n = (len(x0) // bs) * bs
        best = float("inf")
        best_params = params
        for epoch in range(args.epochs):
            perm = torch.from_numpy(np.random.default_rng(
                args.seed + 31 * r + epoch).permutation(len(x0))[:n]).to(
                device)
            losses = []
            te = time.perf_counter()
            for s in range(0, n, bs):
                idx = perm[s:s + bs]
                gen = torch.Generator(device).manual_seed(derive_seed(
                    args.seed, r * 100000 + epoch * 1000 + s // bs))
                losses.append(step(state, x0.index_select(0, idx),
                                   x1.index_select(0, idx), gen))
            mean_loss = (float(torch.stack(losses).double().mean())
                         if losses else float("nan"))
            print(f"  epoch {epoch + 1}/{args.epochs}: loss {mean_loss:.4f} "
                  f"({n // bs} steps, {time.perf_counter() - te:.1f}s)")
            if mean_loss < best:
                best = mean_loss
                best_params = _copy(state.model)
        params = best_params

    final = make_model()
    final.load_state_dict(params)
    save_train_checkpoint(student_path,
                          create_fm_state(final, device, lr=args.lr),
                          args.epochs, best)
    print(f"Saved reflowed flow: {student_path} (best loss {best:.4f})")
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Reflow-distill a trained flow for few-step sampling")
    parser.add_argument("--experiment", type=str, default="mnist_transform",
                        choices=["mnist_transform", "mnist_svhn"])
    parser.add_argument("--modality", type=str, default="x",
                        choices=["x", "y"],
                        help="experiment-1 flow to distill")
    parser.add_argument("--transform_type", type=str, default="rotate90")
    parser.add_argument("--model", type=str, default="unet",
                        choices=["unet", "original"])
    parser.add_argument("--flow", type=str, default="mnist32",
                        choices=["mnist32", "svhn"],
                        help="experiment-2 flow to distill")
    parser.add_argument("--pairs", type=int, default=20480,
                        help="teacher couplings to generate per round")
    parser.add_argument("--gen_batch_size", type=int, default=512)
    parser.add_argument("--teacher_steps", type=int, default=100,
                        help="ODE steps for teacher coupling generation")
    parser.add_argument("--rounds", type=int, default=1,
                        help="reflow iterations (2-reflow re-couples from "
                             "the round-1 student)")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    add_solver_flag(parser)
    add_train_runtime_flags(parser)
    add_common_flags(parser)
    args = parser.parse_args(argv)

    device = init_runtime(args)
    set_seed(args.seed)
    make_model, shape, teacher_path, student_path, kind = _resolve(args)
    return run_reflow(make_model, shape, teacher_path, student_path, kind,
                      args, device)


if __name__ == "__main__":
    main()
