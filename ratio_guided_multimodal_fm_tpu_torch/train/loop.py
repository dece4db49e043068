"""Epoch drivers (port of train/loop.py): best and periodic checkpoints,
early stopping, preemption-safe resume.

Patience semantics mirror ref train_flow.py:84-117 (best-loss tracking,
save_every periodic saves, stop after `patience` non-improving epochs).
`train_epochs` is the generic driver; `train_flow_matching_epochs` the
flow wrapper that experiment 1's train CLI uses. A `metrics_logger`
(core/observability.py:MetricsLogger) gets each epoch's means and steps/s,
as in the JAX driver.

Step outputs (a scalar loss, or a metrics dict of scalars for the ratio
steps) stay on the device until the epoch ends (or a preemption saves),
then are summed per key in float64 on the host: one synchronisation per
epoch, none per step. float32 values of a few thousand steps sum exactly
in float64, so a resumed epoch's sums (carried part + the rest) equal the
uninterrupted one's.

Multi-process runs (parallel/multihost.py): every rank runs the driver
on identical metrics (the steps return the global batch's), so the save
and early-stopping decisions agree; rank 0 alone writes the files
(train/checkpoint.py) and clears the preemption state, and each step the
ranks agree on preemption (an all-reduce MAX of the local flag, one host
collective a step), so that all of them stop at the same step.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Optional

import torch

from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
    DataParallel,
    is_writer,
    process_info,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    ema_checkpoint_path,
    load_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from ratio_guided_multimodal_fm_tpu_torch.train.preemption import (
    PreemptionGuard,
)


class EarlyStopper:
    """Best-loss early stopping (ref train_flow.py:84-117)."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.best = float("inf")
        self.counter = 0

    def update(self, loss: float) -> bool:
        """Returns True if this is a new best."""
        if loss < self.best:
            self.best = loss
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience


def restore_preempt(preempt_path: Optional[str], state):
    """Restore a preemption checkpoint (if one exists at `preempt_path`)
    into `state` (weights, optimiser, EMA) in place.

    Returns (state, resume): `resume` is the kwargs dict for
    `train_epochs(..., **resume)` (start_epoch, start_step, start_best,
    start_patience_counter, start_partial_sums, start_partial_count), with
    all-zero defaults when there is nothing to restore."""
    resume = {"start_epoch": 0, "start_step": 0,
              "start_best": float("inf"), "start_patience_counter": 0,
              "start_partial_sums": None, "start_partial_count": 0}
    if not (preempt_path and os.path.isfile(preempt_path)):
        return state, resume
    raw = load_checkpoint(preempt_path)
    state.model.load_state_dict(raw["model_state_dict"], strict=True)
    state.optimizer.load_state_dict(raw["optimizer_state_dict"])
    if state.ema is not None and raw.get("ema") is not None:
        with torch.no_grad():
            for k, v in raw["ema"].items():
                state.ema[k].copy_(v)
    resume.update(
        start_epoch=int(raw["epoch"]), start_step=int(raw["step"]),
        start_best=float(raw["best_loss"]),
        start_patience_counter=int(raw["patience_counter"]),
        start_partial_count=int(raw["partial_count"]))
    if raw.get("partial_sums"):
        resume["start_partial_sums"] = {k: float(v) for k, v
                                        in raw["partial_sums"].items()}
    return state, resume


def finish_preemptible(history, preempt_path: Optional[str],
                       log_fn: Callable[[str], None] = print) -> bool:
    """Shared CLI epilogue: report the preemption outcome and clear
    consumed resume state. Returns True when the run was preempted (the
    caller returns instead of printing 'Training complete')."""
    if history and history[-1].get("preempted"):
        if preempt_path:
            log_fn("\nPreempted — resumable checkpoint saved; rerun the "
                   "same command to continue.")
        else:
            log_fn("\nPreempted — stopped cleanly after the in-flight "
                   "step. No resumable checkpoint (run with "
                   "--preempt_path to enable step-granular resume).")
        return True
    if preempt_path and os.path.isfile(preempt_path) and is_writer():
        os.remove(preempt_path)       # completed: clear resume state
    return False


def epoch_data_iter(loader, extract: Callable = lambda b: b):
    """Position-addressed epoch iterator factory for train_epochs: uses
    loader.epoch(e) where the loader has it (a restarted process must
    reproduce epoch e's batch order) and maps `extract` over the batches
    after the resume skip, so skipped batches are never extracted."""

    def data_iter(epoch, skip: int = 0):
        it = (loader.epoch(epoch) if hasattr(loader, "epoch")
              else iter(loader))
        for batch in itertools.islice(it, skip, None):
            yield extract(batch)
    return data_iter


def _sums(outs, loss_key: Optional[str]) -> dict:
    """Per-key float64 host sums of the step outputs so far (one
    synchronisation): {'loss': Σ} for scalar losses, else one sum per key
    of the metrics dicts."""
    if not outs:
        return {}
    if loss_key is None:
        return {"loss": float(torch.stack(outs).double().sum())}
    keys = list(outs[0])
    tot = torch.stack([torch.stack([o[k] for k in keys])
                       for o in outs]).double().sum(0).tolist()
    return dict(zip(keys, tot))


def _add(sums: dict, carry: dict) -> dict:
    """`sums` plus the sums carried over a preemption, key by key."""
    out = dict(sums)
    for k, v in carry.items():
        out[k] = out.get(k, 0.0) + v
    return out


def train_epochs(
    state,
    train_step: Callable,              # (state, batch, generator) -> out
    data_iter_fn: Callable,            # (epoch[, skip]) -> batches
    epochs: int,
    rng: RNG,
    loss_key: Optional[str] = None,    # None: out is a scalar loss; else
                                       # out is a metrics dict and
                                       # out[loss_key] drives early stopping
    save_best_fn: Optional[Callable] = None,      # (state, epoch, best)
    save_periodic_fn: Optional[Callable] = None,  # (state, epoch, best)
    save_every: int = 10,
    patience: int = 10,
    log_fn: Callable[[str], None] = print,
    metrics_logger=None,
    preempt_path: Optional[str] = None,
    start_epoch: int = 0,
    start_step: int = 0,
    start_best: float = float("inf"),
    start_patience_counter: int = 0,
    start_partial_sums: Optional[dict] = None,
    start_partial_count: int = 0,
):
    """Training driver over scalar-loss steps (`loss_key` None) or
    metrics-dict steps (the ratio nets, `loss_key='loss'`). Returns (state,
    best_loss, history); history rows hold the epoch's mean of every key.

    Preemption-safe: SIGTERM sets a flag (train/preemption.py); the driver
    finishes the in-flight step, saves {model_state_dict,
    optimizer_state_dict, ema?, epoch, step, best_loss, patience_counter,
    partial_sums, partial_count} to `preempt_path` (the state dict carries
    BatchNorm buffers, the partial sums every key) and returns with
    history[-1]["preempted"] = True. `restore_preempt` restores the state
    and gives the start_* kwargs. The early-stop state and the partial
    epoch's loss sums survive the restart, so the best-checkpoint and
    early-stop decisions do not diverge from the uninterrupted run.
    Exactness: step (epoch, i) draws from rng.generator(epoch, i) and the
    epoch's batch order is a function of the epoch (data_iter_fn(epoch)),
    so a mid-epoch restart reproduces the uninterrupted run bit for bit
    on the CPU.
    """
    stopper = EarlyStopper(patience)
    stopper.best = start_best
    stopper.counter = start_patience_counter
    history = []

    def _save_preempt(epoch, step_i, sums, count):
        if preempt_path:
            tree = {
                "model_state_dict": state.model.state_dict(),
                "optimizer_state_dict": state.optimizer.state_dict(),
                "epoch": epoch,
                "step": step_i,
                "best_loss": stopper.best,
                "patience_counter": stopper.counter,
                "partial_sums": sums,
                "partial_count": count,
            }
            if state.ema is not None:
                tree["ema"] = state.ema
            save_checkpoint(preempt_path, tree)
            log_fn(f"  -> Preempted: resumable checkpoint at "
                   f"{preempt_path} (epoch {epoch}, step {step_i})")

    # multi-process: every rank preempts at the step where any rank has
    # seen its SIGTERM (one may see it a step before another)
    agree = (DataParallel().agree if process_info()[1] > 1
             else lambda local: local)

    with PreemptionGuard() as guard:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            outs = []
            restarting = epoch == start_epoch
            skip = start_step if restarting else 0
            carry = dict(start_partial_sums or {}) if restarting else {}
            carry_n = start_partial_count if restarting else 0
            # iterators that take the skip count do not extract the
            # skipped batches; plain (epoch)-only ones skip inline
            try:
                iterator = enumerate(data_iter_fn(epoch, skip), start=skip)
                inline_skip = 0
            except TypeError:
                iterator = enumerate(data_iter_fn(epoch))
                inline_skip = skip
            for step_i, batch in iterator:
                if step_i < inline_skip:
                    continue
                outs.append(train_step(state, batch,
                                       rng.generator(epoch, step_i)))
                if agree(guard.preempted):
                    wait_for_saves()
                    _save_preempt(epoch, step_i + 1, _add(_sums(
                        outs, loss_key), carry), len(outs) + carry_n)
                    history.append({"epoch": epoch + 1,
                                    "preempted_at_step": step_i + 1,
                                    "preempted": True})
                    wait_for_saves()
                    return state, stopper.best, history
            n_steps = len(outs) + carry_n
            if not n_steps:
                continue    # the epoch yielded no batch and carried none
            # the sums synchronise the device, so the rate is the card's
            totals = _add(_sums(outs, loss_key), carry)
            steps_per_sec = len(outs) / max(time.time() - t0, 1e-9)
            avg = {k: v / n_steps for k, v in totals.items()}
            avg_loss = avg[loss_key or "loss"]
            if loss_key is None:
                log_fn(f"Epoch {epoch+1}/{epochs} - Loss: {avg_loss:.4f} "
                       f"({steps_per_sec:.1f} steps/s)")
            else:
                log_fn(f"Epoch {epoch+1}/{epochs} - " + " - ".join(
                    f"{k}: {v:.4f}" for k, v in avg.items())
                    + f" ({steps_per_sec:.1f} steps/s)")
            history.append({"epoch": epoch + 1, **avg,
                            "steps_per_sec": steps_per_sec})
            if metrics_logger is not None:
                metrics_logger.log(epoch + 1, {**avg,
                                               "steps_per_sec": steps_per_sec})
            # the best and periodic saves write on a background thread
            # while the next epoch runs; the loop waits for them before
            # it returns (and load_checkpoint waits too)
            if stopper.update(avg_loss) and save_best_fn:
                save_best_fn(state, epoch + 1, stopper.best)
            if save_periodic_fn and (epoch + 1) % save_every == 0:
                save_periodic_fn(state, epoch + 1, stopper.best)
            if stopper.should_stop:
                log_fn(f"\nEarly stopping after {epoch+1} epochs "
                       f"(patience={patience})")
                break
    wait_for_saves()
    return state, stopper.best, history


def train_flow_matching_epochs(
    state,
    train_step: Callable,
    data_iter_fn: Callable,
    epochs: int,
    rng: RNG,
    best_path: Optional[str] = None,
    periodic_path_fn: Optional[Callable[[int], str]] = None,
    save_every: int = 10,
    patience: int = 10,
    log_fn: Callable[[str], None] = print,
    metrics_logger=None,
    preempt_path: Optional[str] = None,
    **resume,
):
    """FM wrapper over `train_epochs` (scalar-loss steps, bare state-dict
    best and periodic checkpoints). Returns (state, best, history). With
    an EMA, every best save also writes the EMA weights under the `_ema`
    name (flow_x_best.pth -> flow_x_ema_best.pth), which the sample and
    evaluate CLIs load with --ema."""

    def save_best(s, epoch, best):
        if best_path:
            save_checkpoint(best_path, s.model.state_dict(), async_save=True)
            log_fn(f"  -> Saved best model: {best_path}")
            if s.ema is not None:
                save_checkpoint(ema_checkpoint_path(best_path), s.ema,
                                async_save=True)
                log_fn(f"  -> Saved EMA model: "
                       f"{ema_checkpoint_path(best_path)}")

    def save_periodic(s, epoch, best):
        if periodic_path_fn:
            save_checkpoint(periodic_path_fn(epoch), s.model.state_dict(),
                            async_save=True)

    return train_epochs(
        state, train_step, data_iter_fn, epochs, rng,
        save_best_fn=save_best, save_periodic_fn=save_periodic,
        save_every=save_every, patience=patience, log_fn=log_fn,
        metrics_logger=metrics_logger, preempt_path=preempt_path, **resume)
