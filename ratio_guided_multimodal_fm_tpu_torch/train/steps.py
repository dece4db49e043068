"""The flow-matching train step (port of train/steps.py: FMTrainState,
_fm_substep, make_fm_train_step, create_fm_state).

One step: t ~ U(0, 1) and x_0 ~ N(0, I) from the step's generator (or
injected), x_t = (1-t)·x_0 + t·x_1, loss = mean((v(x_t, t) − (x_1 − x_0))²)
in float32, its gradient by autograd (on the card every GroupNorm site runs
the forward kernel with its statistics, and the backward kernel with dγ and
dβ), an Adam update with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0: torch.optim.Adam's update is optax's; JAX leaves it to XLA
outside any kernel, so the port leaves it to the library), then, where an
EMA is kept, ema = d·ema + (1−d)·params.

Dropout (p = 0.1 in the U-Nets) draws from the device's default generator;
the step reseeds it from its own generator's seed, so a step's dropout
masks are position-addressed like its t and x_0 (core/prng.py). The
batches are NHWC, as the JAX package's; the NCHW model sees them through a
permuted view, which on the card is channels_last memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.core.device import (
    place_for_training,
)
from ratio_guided_multimodal_fm_tpu_torch.core.guards import check_finite
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import cfm_loss


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
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if ema_decay is not None:
            update_ema(state, ema_decay)
        return loss.detach()

    return step
