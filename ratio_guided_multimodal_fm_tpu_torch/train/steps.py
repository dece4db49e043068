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

Dropout (p = 0.1 in the U-Nets and the ratio nets' score MLPs, 0.25 / 0.3
in the classifiers) draws from the device's default generator;
the step reseeds it from its own generator's seed, so a step's dropout
masks are position-addressed like its t and x_0 (core/prng.py). The
batches are NHWC, as the JAX package's; the NCHW model sees them through a
permuted view, which on the card is channels_last memory.
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
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import cfm_loss
from ratio_guided_multimodal_fm_tpu_torch.flow.losses import get_ratio_loss


@dataclass
class FMTrainState:
    """The model (in train mode on its device), its Adam optimiser and,
    with an EMA, a copy of every parameter (never an alias) keyed by the
    parameter's state-dict name: a state dict of the U-Nets, which hold no
    buffers."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None

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


def velocity_nhwc(model: nn.Module) -> Callable:
    """(x NHWC, t [B]) -> v NHWC through the NCHW model, without copies."""
    return lambda x, t: model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)


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
    if clip_norm is not None:
        clip_by_global_norm([p.grad for p in state.model.parameters()
                             if p.grad is not None], clip_norm)
    state.optimizer.step()
    if ema_decay is not None:
        update_ema(state, ema_decay)


def make_fm_train_step(ema_decay: Optional[float] = None) -> Callable:
    """step(state, x1, generator=None, *, t=None, x0=None) -> loss.

    x1: NHWC float32 batch on the model's device. t [B] and x0 (x1's shape)
    may be injected (parity tests); otherwise `generator` draws t, then x0,
    and seeds the dropout masks. Updates `state` in place and returns the
    detached float32 loss (no host synchronisation)."""

    def step(state: FMTrainState, x1: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None,
             x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if generator is not None:
            _seed_dropout(x1.device, derive_seed(generator.initial_seed(), 1))
        elif t is None or x0 is None:
            raise ValueError("make_fm_train_step: pass a generator, or "
                             "inject both t and x0")
        loss = cfm_loss(velocity_nhwc(state.model), x1, t, x0, generator)
        check_finite(loss, "fm train loss")
        _apply_update(state, loss, ema_decay)
        return loss.detach()

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
    stands."""
    loss_fn = get_ratio_loss(loss_type, **loss_kwargs)

    def step(state: RatioTrainState, x: torch.Tensor, y: torch.Tensor,
             is_real, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        if generator is not None:
            _seed_dropout(x.device, derive_seed(generator.initial_seed(), 1))
        scores = state.model(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
        loss, metrics = loss_fn(scores, _on(is_real, scores.device))
        check_finite(loss, "ratio train loss")
        _apply_update(state, loss, ema_decay, state.clip_norm)
        return {k: v.detach() for k, v in metrics.items()}

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
