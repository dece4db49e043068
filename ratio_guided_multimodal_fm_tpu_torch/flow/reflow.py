"""Reflow (rectified-flow distillation; port of flow/reflow.py).

Draw x0 ~ N(0, I), integrate the teacher to x1 = ODE(x0), then fit the
student with the CFM objective on the given (x0, x1) coupling instead of an
independent one. The marginals stay and the trajectories straighten, so a
few Euler (or midpoint) steps of the student reach what the teacher's 100
steps reach; the samplers take the fewer steps through `num_steps` and
`solver`.

Coupling generation runs the teacher's `ode_scan` at a fixed generation
batch without autograd; batch i draws its x0 from a generator seeded
`derive_seed(seed, i)` (JAX: fold_in(key, i)), so a batch's noise depends on
its position alone. The couplings stay on the device, as the port's
loaders keep their datasets there. The train step is the flow-matching step
of train/steps.py with the coupling as data: Adam, no EMA, dropout seeded
from the step's generator, the float32 loss returned without a host sync.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device
from ratio_guided_multimodal_fm_tpu_torch.core.guards import check_finite
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import cfm_loss, ode_scan


def reflow_loss(velocity_fn: Callable, x0: torch.Tensor, x1: torch.Tensor,
                t: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """CFM objective on a given coupling: t ~ U(0, 1) injected or drawn from
    `generator`, x_t on the (x0, x1) chord, target x1 − x0, float32 mean."""
    return cfm_loss(velocity_fn, x1, t, x0, generator)


def make_reflow_train_step() -> Callable:
    """step(state, x0, x1, generator=None, *, t=None) -> loss.

    x0, x1: NHWC float32 coupling batches on the model's device. `generator`
    draws t and seeds the dropout masks; or t [B] is injected (parity
    tests). Adam on `state` in place (no EMA); returns the detached float32
    loss (no host synchronisation)."""
    # train/ imports the samplers' layers, which import flow/: imported
    # here, so that flow/ (this module included) imports without train/
    from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
        _apply_update,
        _seed_dropout,
        velocity_nhwc,
    )

    def step(state, x0: torch.Tensor, x1: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if generator is not None:
            _seed_dropout(x1.device, derive_seed(generator.initial_seed(), 1))
        elif t is None:
            raise ValueError("make_reflow_train_step: pass a generator, or "
                             "inject t")
        loss = reflow_loss(velocity_nhwc(state.model), x0, x1, t, generator)
        check_finite(loss, "reflow train loss")
        _apply_update(state, loss, None)
        return loss.detach()

    return step


@torch.no_grad()
def generate_couplings(
    apply_fn: Callable,             # (params, x NHWC, t [B]) -> v
    params,
    seed: int,
    num_pairs: int,
    shape: Tuple[int, ...],
    num_steps: int = 100,
    solver: str = "euler",
    gen_batch_size: int = 512,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher's couplings (x0, x1 = ODE(x0)), float32 NHWC on `device`
    (default cuda). num_pairs is rounded up to a multiple of gen_batch_size
    (the extra pairs are kept); batch i's x0 comes from a generator seeded
    derive_seed(seed, i)."""
    device = resolve_device(device)
    n_batches = -(-num_pairs // gen_batch_size)
    n = n_batches * gen_batch_size
    x0 = torch.empty((n,) + tuple(shape), dtype=torch.float32, device=device)
    x1 = torch.empty_like(x0)
    for i in range(n_batches):
        g = torch.Generator(device).manual_seed(derive_seed(seed, i))
        rows = slice(i * gen_batch_size, (i + 1) * gen_batch_size)
        x0[rows] = torch.randn((gen_batch_size,) + tuple(shape), generator=g,
                               dtype=torch.float32, device=device)
        x1[rows] = ode_scan(lambda x, t: apply_fn(params, x, t), x0[rows],
                            num_steps, solver=solver)
    return x0, x1
