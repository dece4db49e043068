"""Training steps in plain PyTorch: the CFM loss, the disc ratio loss,
global-norm clipping, Adam and the EMA, float32.

* CFM (src/train_flow.py): t ~ U(0, 1), then x_0 ~ N(0, I), both from the
  step's generator; x_t = (1-t)·x_0 + t·x_1; loss = mean((v(x_t, t) -
  (x_1 - x_0))²).
* disc: E_real[softplus(-s)] + E_fake[softplus(s)], each a masked mean
  over the whole batch with its count clamped at 1.
* clip: where ‖g‖ (over every leaf) ≥ max_norm, g ← g / ‖g‖ · max_norm.
* Adam (b1 0.9, b2 0.999, eps 1e-8): m ← b1 m + (1-b1) g, v ← b2 v +
  (1-b2) g², p ← p - lr/(1-b1^t) · m / (sqrt(v)/sqrt(1-b2^t) + eps).
* EMA: e ← d·e + (1-d)·p with d rounded to float32.
* Dropout draws from the device's default generator, seeded at each
  step (or each fused macro step) with `dropout_seed(the step's seed)`:
  the position-addressed rule of the trainer under test, written out here.
  A fused macro step's sub-step j draws its t and x_0 from a generator
  seeded `position_seed(the macro step's seed, 0, j)`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import Net, nhwc_scores, nhwc_velocity


def position_seed(seed: int, *path: int) -> int:
    return int(np.random.SeedSequence([seed, *path]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def dropout_seed(step_seed: int) -> int:
    return position_seed(step_seed, 1)


def seed_dropout(device: torch.device, seed: int) -> None:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        torch.cuda.default_generators[idx].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


def cfm_loss(net: Net, x1: torch.Tensor, generator: torch.Generator,
             precision: str = "fp32", keep: int = None) -> torch.Tensor:
    """`keep` (a fault planted for the check's own test): the mean over
    the first `keep` rows only."""
    B = x1.shape[0]
    t = torch.rand((B,), generator=generator, dtype=torch.float32,
                   device=x1.device)
    x0 = torch.randn(x1.shape, generator=generator, dtype=torch.float32,
                     device=x1.device)
    tb = t.reshape(B, 1, 1, 1)
    x_t = (1.0 - tb) * x0 + tb * x1
    v = nhwc_velocity(net, x_t, t, precision, train=True)
    return torch.mean(((v - (x1 - x0)) ** 2)[:keep])


def _masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def disc_loss(net: Net, x, y, is_real, precision: str = "fp32",
              keep: int = None):
    """`keep`: as in `cfm_loss`, the loss of the first `keep` rows."""
    s = nhwc_scores(net, x, y, precision, train=True)[:keep]
    real = is_real.to(torch.float32)[:keep]
    return (_masked_mean(F.softplus(-s), real)
            + _masked_mean(F.softplus(s), 1.0 - real))


@torch.no_grad()
def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.mul_(float(max_norm / norm))


class Adam:
    def __init__(self, P: Dict[str, torch.Tensor], keys: List[str],
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.P, self.keys = P, keys
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(P[k]) for k in keys}
        self.v = {k: torch.zeros_like(P[k]) for k in keys}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k in self.keys:
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / (bc2 ** 0.5) + self.eps
            self.P[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


class Ema:
    def __init__(self, P: Dict[str, torch.Tensor], keys: List[str],
                 decay: float):
        self.d = float(np.float32(decay))
        self.one_minus = float(np.float32(1.0) - np.float32(decay))
        self.P, self.e = P, {k: P[k].detach().clone() for k in keys}

    @torch.no_grad()
    def update(self) -> None:
        for k, e in self.e.items():
            e.mul_(self.d).add_(self.P[k] * self.one_minus)


def trainable(P: Dict[str, torch.Tensor], keys: List[str]) -> None:
    for k in keys:
        P[k].requires_grad_(True)
