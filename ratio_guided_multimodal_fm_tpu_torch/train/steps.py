"""The train steps (port of train/steps.py): flow matching (FMTrainState,
_fm_substep, make_fm_train_step, create_fm_state), the ratio nets
(RatioTrainState, make_ratio_train_step for JAX's _ratio_substep,
make_ratio_eval_step, create_ratio_state) and the evaluation classifiers
(make_classifier_train_step, create_classifier_state).

One step: t ~ U(0, 1) and x_0 ~ N(0, I) from the step's generator (or
injected), x_t = (1-t)·x_0 + t·x_1, loss = mean((v(x_t, t) − (x_1 − x_0))²)
in float32, its gradient by autograd (on the card every GroupNorm site runs
the forward kernel with its statistics, and the backward kernel with dγ and
dβ), an Adam update with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0: torch.optim.Adam's update is optax's; JAX leaves it to XLA
outside any kernel, so the port leaves it to the library), then, where an
EMA is kept, ema = d·ema + (1−d)·params.

A ratio step forms the masked loss of flow/losses.py from the scores of
(x, y) pairs, clips the gradient by its global norm as optax's
clip_by_global_norm does (scale by max_norm/‖g‖ where ‖g‖ ≥ max_norm, on
the device, no host synchronisation), then takes the same Adam step and
EMA update; its BatchNorm nets update their running statistics in the
forward (models/ratio.py:BatchNorm2d). A classifier step is float32
softmax cross-entropy against integer labels, then Adam (lr 1e-3).

Data-parallel runs (parallel/multihost.py, a state's `dp`): each rank
takes its contiguous rows of the global batch, the FM step draws t and x_0
for the whole global batch from the step's generator and keeps its rows,
each rank's loss is its share of the global loss (masked means over the
global counts, rulsif's squared global mean, BatchNorm on the global
batch's statistics: flow/losses.py, models/ratio.py), and the gradients
are summed over the ranks before the clip and Adam, so the update is the
one-process update of the whole batch up to the order of the sums. The
dropout masks are each rank's own.

The fused K-step trainers (`make_fm_train_multistep`,
`make_ratio_train_multistep`, the JAX package's lax.scan ones) gather K
batches from the dataset on the device and take K optimizer steps in one
dispatch: on the CPU a plain loop over the single step, on the card one
`torch.cuda.CUDAGraph` per (model, K, B), captured once and replayed once
per macro step (train/graphs.py).

Dropout (p = 0.1 in the U-Nets and the ratio nets' score MLPs, 0.25 / 0.3
in the classifiers) draws from the device's default generator;
the step reseeds it from its own generator's seed, so a step's dropout
masks are position-addressed like its t and x_0 (core/prng.py). The
batches are NHWC, as the JAX package's; the NCHW model sees them through a
permuted view, which on the card is channels_last memory.

Each call of a train step returned by `make_fm_train_step`,
`make_ratio_train_step` and the fused trainers is one span,
`train.fm.call` or `train.ratio.call` (core/observability.py): draws,
input copies, dropout seeding and the steps or the graph's replay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    place_for_training,
)
from ratio_guided_multimodal_fm_tpu_torch.core.guards import check_finite
from ratio_guided_multimodal_fm_tpu_torch.core.observability import span
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import cfm_loss
from ratio_guided_multimodal_fm_tpu_torch.flow.losses import get_ratio_loss
from ratio_guided_multimodal_fm_tpu_torch.train.graphs import (
    fused_macro_step,
)


@dataclass
class FMTrainState:
    """The model (in train mode on its device), its Adam optimiser and,
    with an EMA, a copy of every parameter (never an alias) keyed by the
    parameter's state-dict name: a state dict of the U-Nets, which hold no
    buffers."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    # a data-parallel run's parallel/multihost.py:DataParallel (None: one
    # process); cli/common.py:multihost_adapt sets it
    dp: Optional[object] = None

    def reset_ema(self) -> None:
        """ema = copy(params) (create_fm_state, and --resume)."""
        self.ema = {n: p.detach().clone()
                    for n, p in self.model.named_parameters()}


def create_fm_state(model: nn.Module, device, lr: float = 1e-4,
                    ema_decay: Optional[float] = None) -> FMTrainState:
    """Place `model` for training on `device` and give it Adam(lr) (ref lr
    default 1e-4, train_flow.py:36-37); with `ema_decay` the EMA starts as a
    copy of the params. The model's params are its init: seed torch (or
    load weights) before."""
    model = place_for_training(model, torch.device(device))
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    state = FMTrainState(model, opt)
    if ema_decay is not None:
        state.reset_ema()
    return state


def velocity_nhwc(model: nn.Module,
                  y: Optional[torch.Tensor] = None) -> Callable:
    """(x NHWC, t [B]) -> v NHWC through the NCHW model, without copies;
    with `y` (a class-conditional net's labels [B]) the model is called as
    model(x, t, y)."""
    cond = () if y is None else (y,)
    return lambda x, t: model(x.permute(0, 3, 1, 2), t, *cond).permute(
        0, 2, 3, 1)


def _dropout_seed(generator: torch.Generator, dp=None) -> int:
    """The dropout seed of a step: position-addressed by the step's
    generator and, in a data-parallel run, the rank (its own masks)."""
    seed = generator.initial_seed()
    return derive_seed(seed, 1) if dp is None else derive_seed(seed, 1,
                                                               dp.rank)


def _seed_dropout(device: torch.device, seed: int) -> None:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        torch.cuda.default_generators[idx].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


@torch.no_grad()
def update_ema(state: FMTrainState, ema_decay: float) -> None:
    """ema = d·ema + (1−d)·params, each product and the sum rounded to
    float32 as JAX's d * e + (1.0 - d) * p with d = float32(ema_decay)."""
    d = np.float32(ema_decay)
    names = list(state.ema)
    params = dict(state.model.named_parameters())
    ema = [state.ema[n] for n in names]
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(
        [params[n].detach() for n in names], float(np.float32(1.0) - d)))


def _apply_update(state: FMTrainState, loss: torch.Tensor,
                  ema_decay: Optional[float],
                  clip_norm: Optional[float] = None) -> None:
    """Gradients of `loss`, clipped by their global norm where `clip_norm`
    is given, then the Adam step and, with `ema_decay`, the EMA."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.dp is not None:
        state.dp.sync_grads([p.grad for p in state.model.parameters()
                             if p.grad is not None])
    if clip_norm is not None:
        clip_by_global_norm([p.grad for p in state.model.parameters()
                             if p.grad is not None], clip_norm)
    state.optimizer.step()
    if ema_decay is not None:
        update_ema(state, ema_decay)


def _fm_substep(state: FMTrainState, x1: torch.Tensor,
                generator: Optional[torch.Generator], t, x0,
                ema_decay: Optional[float], check: bool = True,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FM step body shared by the single and the fused steps: the
    loss (drawing what is not injected; `y` the labels of a
    class-conditional net), the update; returns the detached loss of the
    whole batch (summed over the ranks in a data-parallel run)."""
    dp = state.dp
    if dp is not None and t is None:
        # the one-process draws of the global batch (t, then x_0), this
        # rank's rows of them
        shape = (x1.shape[0] * dp.size,) + tuple(x1.shape[1:])
        t = dp.rows(torch.rand(shape[:1], generator=generator,
                               dtype=x1.dtype, device=x1.device))
        x0 = dp.rows(torch.randn(shape, generator=generator, dtype=x1.dtype,
                                 device=x1.device))
    loss = cfm_loss(velocity_nhwc(state.model, y), x1, t, x0, generator)
    if check:
        check_finite(loss, "fm train loss")
    if dp is None:
        _apply_update(state, loss, ema_decay)
        return loss.detach()
    share = loss / dp.size     # Σ over this rank's rows / (B·D)
    _apply_update(state, share, ema_decay)
    return dp.total(share)


def make_fm_train_step(ema_decay: Optional[float] = None) -> Callable:
    """step(state, x1, generator=None, *, t=None, x0=None, y=None) -> loss.

    x1: NHWC float32 batch on the model's device. t [B] and x0 (x1's shape)
    may be injected (parity tests); otherwise `generator` draws t, then x0,
    and seeds the dropout masks (and a class-conditional net's label
    drop). y: the labels [B] (int64, on the device) of a class-conditional
    net (models/sit.py), None for the unconditional nets. Updates `state` in place and returns the
    detached float32 loss (no host synchronisation). In a data-parallel
    run x1 is this rank's rows and the loss is the global batch's."""

    def step(state: FMTrainState, x1: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None,
             x0: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("train.fm.call"):
            if generator is not None:
                _seed_dropout(x1.device, _dropout_seed(generator, state.dp))
            elif t is None or x0 is None:
                raise ValueError("make_fm_train_step: pass a generator, or "
                                 "inject both t and x0")
            return _fm_substep(state, x1, generator, t, x0, ema_decay,
                               y=y)

    return step


@dataclass
class RatioTrainState(FMTrainState):
    """A ratio net or classifier in train mode on its device, its Adam
    optimiser, the EMA of its parameters (ratio nets only, keyed by
    state-dict name) and the global-norm clip applied before Adam (None:
    no clip, the classifiers). BatchNorm running statistics are the
    model's buffers, so `model.state_dict()` holds them (JAX
    `batch_stats`)."""
    clip_norm: Optional[float] = None


def _adam_state(model: nn.Module, device, lr: float, clip_norm, ema_decay):
    model = place_for_training(model, torch.device(device))
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    state = RatioTrainState(model, opt, clip_norm=clip_norm)
    if ema_decay is not None:
        state.reset_ema()
    return state


def create_ratio_state(model: nn.Module, device, lr: float = 1e-4,
                       clip_norm: float = 1.0,
                       ema_decay: Optional[float] = None) -> RatioTrainState:
    """Place a ratio net for training on `device` with clip(clip_norm) then
    Adam(lr) (JAX optax.chain(clip_by_global_norm, adam)); with
    `ema_decay` the EMA starts as a copy of the params."""
    return _adam_state(model, device, lr, clip_norm, ema_decay)


def create_classifier_state(model: nn.Module, device,
                            lr: float = 1e-3) -> RatioTrainState:
    """Place an evaluation classifier for training on `device` with
    Adam(lr) (ref lr default 1e-3), no clip and no EMA."""
    return _adam_state(model, device, lr, None, None)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g_norm = sqrt(Σ Σ g²); where
    g_norm ≥ max_norm every gradient becomes (g / g_norm) · max_norm, else
    it stays as it is. Runs on the device (no host synchronisation);
    returns g_norm."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm


def _on(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device, non_blocking=True)


def _ratio_substep(state: RatioTrainState, x, y, is_real, loss_fn,
                   ema_decay: Optional[float], check: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """The ratio step body shared by the single and the fused steps."""
    scores = state.model(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
    loss, metrics = loss_fn(scores, _on(is_real, scores.device))
    if check:
        check_finite(loss, "ratio train loss")
    _apply_update(state, loss, ema_decay, state.clip_norm)
    return {k: v.detach() for k, v in metrics.items()}


def make_ratio_train_step(loss_type: str = "disc",
                          ema_decay: Optional[float] = None,
                          **loss_kwargs) -> Callable:
    """step(state, x, y, is_real, generator=None) -> metrics.

    x, y: NHWC float32 batches on the model's device; is_real: [B] 0/1
    (numpy or a tensor). The scores of the NCHW model in train mode
    (dropout on, BatchNorm on batch statistics) go through the masked
    `loss_type` loss (`alpha`, `lambda_penalty` in loss_kwargs); the
    gradient is clipped by its global norm (state.clip_norm), then Adam and,
    with `ema_decay`, the EMA. Returns the loss's metrics dict as detached
    float32 device tensors (no host synchronisation). `generator` seeds the
    dropout masks; without it they come from the device's generator as it
    stands. In a data-parallel run (state.dp) x, y and is_real are this
    rank's rows; the loss is this rank's share of the global one and the
    metrics are the global batch's."""
    loss_fn = get_ratio_loss(loss_type, **loss_kwargs)

    def step(state: RatioTrainState, x: torch.Tensor, y: torch.Tensor,
             is_real, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        with span("train.ratio.call"):
            if generator is not None:
                _seed_dropout(x.device, _dropout_seed(generator, state.dp))
            fn = loss_fn if state.dp is None else get_ratio_loss(
                loss_type, dp=state.dp, **loss_kwargs)
            return _ratio_substep(state, x, y, is_real, fn, ema_decay)

    return step


def make_ratio_eval_step(loss_type: str = "disc", **loss_kwargs) -> Callable:
    """step(state, x, y, is_real) -> metrics of the loss in eval mode
    (dropout off, BatchNorm on running statistics), without gradients; the
    model returns to the mode it was in."""
    loss_fn = get_ratio_loss(loss_type, **loss_kwargs)

    @torch.no_grad()
    def step(state: RatioTrainState, x: torch.Tensor, y: torch.Tensor,
             is_real) -> Dict[str, torch.Tensor]:
        was = state.model.training
        state.model.eval()
        try:
            scores = state.model(x.permute(0, 3, 1, 2),
                                 y.permute(0, 3, 1, 2))
        finally:
            state.model.train(was)
        return loss_fn(scores, _on(is_real, scores.device))[1]

    return step


def make_classifier_train_step() -> Callable:
    """step(state, images, labels, generator=None) -> (loss, acc).

    images: NHWC float32 on the model's device; labels: [B] integers (numpy
    or a tensor). Float32 softmax cross-entropy against the integer labels
    (mean over the batch), then Adam; BatchNorm classifiers update their
    running statistics in the forward. Returns the detached loss and
    accuracy (no host synchronisation); `generator` seeds the dropout
    masks."""

    def step(state: RatioTrainState, images: torch.Tensor, labels,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if generator is not None:
            _seed_dropout(images.device,
                          derive_seed(generator.initial_seed(), 1))
        logits = state.model(images)
        labels = _on(labels, logits.device).long()
        loss = F.cross_entropy(logits.to(torch.float32), labels)
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        _apply_update(state, loss, None)
        return loss.detach(), acc

    return step


def _index_tensor(idx, device) -> torch.Tensor:
    """An int32 [K, B] index chunk on `device` (from numpy through pinned
    memory on the card, so the copy does not wait on the host)."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int32, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(idx, np.int32))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _draw_fm(seed: int, t: torch.Tensor, x0: torch.Tensor) -> None:
    """Sub-step j's t [B] then x_0 [B, ...] into t[j], x0[j], from a
    generator seeded derive_seed(seed, 0, j): what the single step would
    draw from that generator."""
    g = torch.Generator(t.device)
    for j in range(t.shape[0]):
        g.manual_seed(derive_seed(seed, 0, j))
        t[j].uniform_(0.0, 1.0, generator=g)
        x0[j].normal_(0.0, 1.0, generator=g)


def make_fm_train_multistep(ema_decay: Optional[float] = None,
                            graph: Optional[bool] = None) -> Callable:
    """The fused K-step FM trainer (JAX make_fm_train_multistep):
    step(state, dataset, idx [K, B], generator, labels=None) -> mean loss.

    dataset: the whole modality, NHWC float32 on the model's device; idx:
    int32 [K, B] rows of it (numpy or a tensor; data/mnist_dataset.py:
    get_index_chunk_loader); labels: for a class-conditional net, the
    dataset's labels [N] (int64, on the device), gathered with the same
    rows (None: the unconditional nets, whose path is unchanged). Sub-step
    j gathers dataset[idx[j]] (and labels[idx[j]]) on the device and takes
    the single step (make_fm_train_step) on it with t and
    x_0 drawn from derive_seed(seed, 0, j), seed = the macro step's
    generator's seed (position-addressed: a resume at macro-step
    granularity reproduces the run); the dropout masks of the K sub-steps
    come from one seed per macro step, derive_seed(seed, 1). The stream
    differs from a K = 1 run, as in JAX. Returns the mean of the K losses
    as a device tensor (no host synchronisation).

    On the CPU (or with graph=False) the K sub-steps are a plain loop over
    the single step's body; on the card (graph None or True) the first
    call runs that loop as the warm-up and captures it, and every later
    call refills the draws and replays one CUDA graph (train/graphs.py).
    Either way on the card Adam keeps its step count on the device
    (capturable). Single-process only.
    """

    def body(state, dataset, idx, t, x0, check=True, labels=None):
        return torch.stack([
            _fm_substep(state, dataset.index_select(0, idx[j]), None, t[j],
                        x0[j], ema_decay, check,
                        None if labels is None
                        else labels.index_select(0, idx[j]))
            for j in range(idx.shape[0])]).mean()

    graphs = {}

    def step(state: FMTrainState, dataset: torch.Tensor, idx,
             generator: torch.Generator,
             labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if state.dp is not None:
            raise ValueError("the fused K-step trainer is single-process "
                             "only")
        with span("train.fm.call"):
            device = dataset.device
            idx = _index_tensor(idx, device)
            K, B = idx.shape
            seed = generator.initial_seed()

            def prepare(st):
                _draw_fm(seed, st["t"], st["x0"])
                _seed_dropout(device, derive_seed(seed, 1))

            return fused_macro_step(
                graphs, state, graph,
                key=(K, B, dataset.data_ptr(),
                     None if labels is None else labels.data_ptr()),
                body=lambda st, check: body(state, dataset, st["idx"],
                                            st["t"], st["x0"], check, labels),
                inputs={"idx": idx},
                buffers=lambda: {
                    "t": torch.empty((K, B), dtype=dataset.dtype,
                                     device=device),
                    "x0": torch.empty((K, B) + tuple(dataset.shape[1:]),
                                      dtype=dataset.dtype, device=device)},
                prepare=prepare, loss=lambda out: out,
                what="fm train loss (fused)")

    step.graphs = graphs
    return step


def make_ratio_train_multistep(loss_type: str = "disc",
                               ema_decay: Optional[float] = None,
                               graph: Optional[bool] = None,
                               **loss_kwargs) -> Callable:
    """The fused K-step ratio trainer (JAX make_ratio_train_multistep):
    step(state, x_all, y_all, xidx [K, B], yidx [K, B], is_real [K, B],
    generator) -> metrics, each the mean over the K sub-steps.

    x_all, y_all: both modalities, NHWC on the model's device; the index
    chunks and the real/fake mask come from the host (data/mnist_dataset.
    py:get_ratio_index_loader). Sub-step j takes the single ratio step
    (make_ratio_train_step) on x_all[xidx[j]], y_all[yidx[j]], is_real[j];
    dropout as in `make_fm_train_multistep` (one seed a macro step), and
    BatchNorm's running statistics and the EMA carry through the K
    sub-steps. CPU: a loop; card: one CUDA graph per (model, K, B)."""
    loss_fn = get_ratio_loss(loss_type, **loss_kwargs)

    def body(state, x_all, y_all, xi, yi, real, check=True):
        outs = [_ratio_substep(state, x_all.index_select(0, xi[j]),
                               y_all.index_select(0, yi[j]), real[j],
                               loss_fn, ema_decay, check)
                for j in range(xi.shape[0])]
        return {k: torch.stack([o[k] for o in outs]).mean() for k in outs[0]}

    graphs = {}

    def step(state: RatioTrainState, x_all: torch.Tensor,
             y_all: torch.Tensor, xidx, yidx, is_real,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if state.dp is not None:
            raise ValueError("the fused K-step trainer is single-process "
                             "only")
        with span("train.ratio.call"):
            device = x_all.device
            xi, yi = _index_tensor(xidx, device), _index_tensor(yidx, device)
            real = torch.as_tensor(is_real, dtype=torch.float32)
            if real.device.type == "cpu" and device.type == "cuda":
                real = real.pin_memory()
            real = real.to(device, non_blocking=True)
            K, B = xi.shape
            seed = generator.initial_seed()
            return fused_macro_step(
                graphs, state, graph,
                key=(K, B, x_all.data_ptr(), y_all.data_ptr()),
                body=lambda st, check: body(state, x_all, y_all, st["xi"],
                                            st["yi"], st["real"], check),
                inputs={"xi": xi, "yi": yi, "real": real}, buffers=dict,
                prepare=lambda st: _seed_dropout(device,
                                                 derive_seed(seed, 1)),
                loss=lambda out: out["loss"],
                what="ratio train loss (fused)")

    step.graphs = graphs
    return step

