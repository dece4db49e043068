"""Density-ratio losses as masked means over the whole batch (port of
flow/losses.py).

The reference splits the batch into its real and fake parts with boolean
indexing; here, as in the JAX package, each term is a mean over the full
fixed-shape batch weighted by the real (or fake) mask, with the
denominator clamped at 1, so a batch that holds a single class gives
finite terms (no boolean indexing, no host synchronisation).

In a data-parallel run (`dp`, parallel/multihost.py:DataParallel) each
rank holds its rows of the batch and its loss is its share of the global
loss: its numerators over the global counts (a global batch's masked
mean), and rulsif's penalty on the global mean of w through a
differentiable all-reduce, divided by the number of ranks; the metrics
are the global batch's (summed over the ranks).
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


def _dp_counts(real: torch.Tensor, dp):
    """Global (real, fake) counts, each clamped at 1 (no gradient)."""
    n = dp.total(torch.stack([real.sum(), (1.0 - real).sum()]))
    return n.clamp_min(1.0).unbind()


def disc_loss_dp(scores: torch.Tensor, is_real: torch.Tensor,
                 dp) -> LossOut:
    """`disc_loss` of the global batch, as this rank's share."""
    s = scores.to(torch.float32)
    real = is_real.to(torch.float32)
    fake = 1.0 - real
    n_real, n_fake = _dp_counts(real, dp)
    share = ((F.softplus(-s) * real).sum() / n_real
             + (F.softplus(s) * fake).sum() / n_fake)
    acc = torch.stack([((s > 0).to(torch.float32) * real).sum() / n_real,
                       ((s < 0).to(torch.float32) * fake).sum() / n_fake])
    tot = dp.total(torch.cat([share.detach()[None], acc]))
    return share, {"loss": tot[0], "acc_real": tot[1], "acc_fake": tot[2]}


def rulsif_loss_dp(scores: torch.Tensor, is_real: torch.Tensor, dp,
                   alpha: float = 0.2, lambda_penalty: float = 0.1
                   ) -> LossOut:
    """`rulsif_loss` of the global batch, as this rank's share: the
    penalty λ(E_mix[w] − 1)² squares the global mean (a differentiable
    all-reduce of Σw), and each rank carries 1/P of it."""
    s = scores.to(torch.float32)
    real = is_real.to(torch.float32)
    w = F.softplus(s)
    n = w.numel() * dp.size
    n_real, n_fake = _dp_counts(real, dp)
    constraint = lambda_penalty * (dp.sum_grad(w.sum()) / n - 1.0) ** 2
    share = (0.5 * (w ** 2).sum() / n - (w * real).sum() / n_real
             + constraint / dp.size)
    tot = dp.total(torch.stack([share.detach(), (w * real).sum() / n_real,
                                (w * (1.0 - real)).sum() / n_fake]))
    return share, {"loss": tot[0], "mean_w_real": tot[1],
                   "mean_w_fake": tot[2],
                   "constraint_term": constraint.detach()}


def get_ratio_loss(loss_type: str = "disc", dp=None, **kwargs) -> Callable:
    """f(scores, is_real) -> (loss, metrics) for 'disc' or 'rulsif'
    (`alpha`, `lambda_penalty` from kwargs); with `dp` the data-parallel
    share of the global batch's loss."""
    if loss_type == "disc":
        if dp is not None:
            return lambda s, m: disc_loss_dp(s, m, dp)
        return disc_loss
    if loss_type == "rulsif":
        alpha = kwargs.get("alpha", 0.2)
        lam = kwargs.get("lambda_penalty", 0.1)
        if dp is not None:
            return lambda s, m: rulsif_loss_dp(s, m, dp, alpha=alpha,
                                               lambda_penalty=lam)
        return lambda s, m: rulsif_loss(s, m, alpha=alpha, lambda_penalty=lam)
    raise ValueError(f"Unknown loss type: {loss_type}")


def masked_ratio_loss(scores, is_real, loss_type: str = "disc",
                      **kwargs) -> LossOut:
    return get_ratio_loss(loss_type, **kwargs)(scores, is_real)
