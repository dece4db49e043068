"""Density-ratio losses as masked means over the whole batch (port of
flow/losses.py).

The reference splits the batch into its real and fake parts with boolean
indexing; here, as in the JAX package, each term is a mean over the full
fixed-shape batch weighted by the real (or fake) mask, with the
denominator clamped at 1, so a batch that holds a single class gives
finite terms (no boolean indexing, no host synchronisation).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

LossOut = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def disc_loss(scores: torch.Tensor, is_real: torch.Tensor) -> LossOut:
    """Logistic-regression loss E_real[softplus(-s)] + E_fake[softplus(s)]
    (BCE-with-logits against 1 for real pairs and 0 for fake ones), with
    the accuracies of each part."""
    s = scores.to(torch.float32)
    real = is_real.to(torch.float32)
    fake = 1.0 - real
    loss = (_masked_mean(F.softplus(-s), real)
            + _masked_mean(F.softplus(s), fake))
    return loss, {"loss": loss,
                  "acc_real": _masked_mean((s > 0).to(torch.float32), real),
                  "acc_fake": _masked_mean((s < 0).to(torch.float32), fake)}


def rulsif_loss(scores: torch.Tensor, is_real: torch.Tensor,
                alpha: float = 0.2, lambda_penalty: float = 0.1) -> LossOut:
    """Relative uLSIF loss with w = softplus(T), the mixture approximated
    by the whole batch: 0.5·E_mix[w²] − E_real[w] + λ(E_mix[w] − 1)².
    `alpha` is accepted as the JAX function accepts it; neither uses it."""
    s = scores.to(torch.float32)
    real = is_real.to(torch.float32)
    w = F.softplus(s)
    constraint = lambda_penalty * (w.mean() - 1.0) ** 2
    loss = 0.5 * (w ** 2).mean() - _masked_mean(w, real) + constraint
    return loss, {"loss": loss,
                  "mean_w_real": _masked_mean(w, real),
                  "mean_w_fake": _masked_mean(w, 1.0 - real),
                  "constraint_term": constraint}


def get_ratio_loss(loss_type: str = "disc", **kwargs) -> Callable:
    """f(scores, is_real) -> (loss, metrics) for 'disc' or 'rulsif'
    (`alpha`, `lambda_penalty` from kwargs)."""
    if loss_type == "disc":
        return disc_loss
    if loss_type == "rulsif":
        alpha = kwargs.get("alpha", 0.2)
        lam = kwargs.get("lambda_penalty", 0.1)
        return lambda s, m: rulsif_loss(s, m, alpha=alpha, lambda_penalty=lam)
    raise ValueError(f"Unknown loss type: {loss_type}")


def masked_ratio_loss(scores, is_real, loss_type: str = "disc",
                      **kwargs) -> LossOut:
    return get_ratio_loss(loss_type, **kwargs)(scores, is_real)
