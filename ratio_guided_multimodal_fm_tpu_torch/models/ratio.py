"""Density-ratio estimators r̂(x,y) (port of models/ratio.py), NCHW.

* `FlexibleRatioEstimator` (experiment 1, `RatioEstimatorMNIST` /
  `RatioEstimator`): twin GroupNorm conv encoders and a score MLP, 943,745
  params for 1x28x28 pairs; keys of the JAX exporter's `export_ratio_gn`.
  Each encoder stage is conv3x3 → GroupNorm(8)+SiLU (the
  `ops.groupnorm.group_norm_silu` kernel on the card) → 2x2 max-pool,
  which floors 7 → 3 like flax's VALID `max_pool`.
* `RatioEstimatorMNISTSVHN` (experiment 2): asymmetric BatchNorm conv
  encoders and a deep score MLP, 3,327,617 params, keys of
  `export_ratio_mnist_svhn` (including BatchNorm running stats and
  `num_batches_tracked`). Its BatchNorm has flax's semantics: batch
  statistics in train mode, running statistics in eval mode.

Score is terminal-time only (t=1). `log_ratio` follows the training loss:
  disc:   log r̂ = T
  rulsif: log r̂ = log(softplus(T) + 1e-8)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
    Conv2d,
    GroupNormSiLU,
    Linear,
    flax_init_,
)


def log_ratio_from_scores(scores: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Map raw scores T(x,y) to log r̂(x,y)."""
    if loss_type == "disc":
        # logsigmoid(T) - logsigmoid(-T) == T exactly.
        return scores
    if loss_type == "rulsif":
        return torch.log(F.softplus(scores) + 1e-8)
    raise ValueError(f"Unknown loss_type: {loss_type}")


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics (`nn.BatchNorm(momentum=0.9)`, eps
    1e-5 as in both frameworks), in float32, output in the compute dtype:
    (x − mean)·rsqrt(var + eps)·scale + bias.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch's mean and biased variance over (N, H, W), computed as
    flax computes them (E[x²] − E[x]², clamped at 0), and then, outside
    autograd, running = 0.9·running + 0.1·batch with the biased variance
    (torch's own BatchNorm would feed the unbiased one) and
    `num_batches_tracked` counts the step.

    In a data-parallel run (`dp`, set by cli/common.py:multihost_adapt)
    the batch statistics are the global batch's: Σx and Σx² over every
    rank's rows through one differentiable all-reduce, as the JAX
    package's SPMD program computes them."""

    dp = None     # parallel/multihost.py:DataParallel in a DP run

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(ch, eps=1e-5)
        self.dtype = dtype

    def forward(self, x):
        xf = x.to(torch.float32)
        if self.training and self.dp is not None:
            C = xf.shape[1]
            n = xf.numel() // C * self.dp.size
            sums = self.dp.sum_grad(torch.cat([xf.sum(dim=(0, 2, 3)),
                                               (xf * xf).sum(dim=(0, 2, 3))]))
            mean = sums[:C] / n
            var = (sums[C:] / n - mean * mean).clamp_min(0.0)
        elif self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        if self.training:
            with torch.no_grad():
                for run, new in ((self.running_mean, mean),
                                 (self.running_var, var)):
                    run.copy_(0.9 * run + 0.1 * new)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
             + self.bias[None, :, None, None])
        return y.to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in the compute dtype."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.normalized_shape,
                            self.weight, self.bias, self.eps).to(self.dtype)


class _GNEncoder(nn.Module):
    """conv3x3 → GroupNorm(8)+SiLU, max-pooled after the first three
    stages, global average pool, fc (JAX _GNEncoder)."""

    def __init__(self, in_ch: int, feature_dim: int, dtype: torch.dtype,
                 norm_eps: float):
        super().__init__()
        for i, (cin, cout) in enumerate(
                [(in_ch, 32), (32, 64), (64, 128), (128, 128)], start=1):
            self.add_module(f"conv{i}",
                            Conv2d(cin, cout, 3, padding=1, dtype=dtype))
            self.add_module(f"gn{i}", GroupNormSiLU(cout, norm_eps, dtype))
        self.fc = Linear(128, feature_dim, dtype=dtype)

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
            if i < 4:
                x = F.max_pool2d(x, 2)
        return self.fc(x.mean(dim=(2, 3)))


def _score_mlp(feature_dim: int, h: int, dtype: torch.dtype, norm_eps: float):
    """[2F → H → H/2 → 1] with LayerNorm+SiLU+Dropout (JAX _ScoreMLP);
    Sequential indices 0/1/4/5/8 carry the reference's keys."""
    return nn.Sequential(
        Linear(2 * feature_dim, h, dtype), LayerNorm(h, norm_eps, dtype),
        nn.SiLU(), nn.Dropout(0.1),
        Linear(h, h // 2, dtype), LayerNorm(h // 2, norm_eps, dtype),
        nn.SiLU(), nn.Dropout(0.1),
        Linear(h // 2, 1, dtype))


class FlexibleRatioEstimator(nn.Module):
    """Scores T(x, y) [B] for x [B,x_channels,H,W] and y [B,y_channels,H,W],
    NCHW, from two GroupNorm encoders and a score MLP."""

    def __init__(self, x_channels: int = 1, y_channels: int = 1,
                 feature_dim: int = 256, hidden_dim: int = 512,
                 loss_type: str = "disc", dtype: torch.dtype = torch.float32,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.loss_type = loss_type
        self.dtype = dtype
        self.encoder_x = _GNEncoder(x_channels, feature_dim, dtype, norm_eps)
        self.encoder_y = _GNEncoder(y_channels, feature_dim, dtype, norm_eps)
        self.score_net = _score_mlp(feature_dim, hidden_dim, dtype, norm_eps)
        flax_init_(self)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        z = torch.cat([self.encoder_x(x.to(self.dtype)),
                       self.encoder_y(y.to(self.dtype))], dim=-1)
        return self.score_net(z).squeeze(-1)

    def log_ratio(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return log_ratio_from_scores(self(x, y), self.loss_type)


def RatioEstimatorMNIST(loss_type: str = "disc",
                        **kw) -> FlexibleRatioEstimator:
    """MNIST-transform ratio net, 1x28x28 both streams (943,745 params)."""
    return FlexibleRatioEstimator(x_channels=1, y_channels=1, feature_dim=256,
                                  hidden_dim=512, loss_type=loss_type, **kw)


# Alias of the reference's experiment-1 class name.
RatioEstimator = RatioEstimatorMNIST


class _BNEncoder(nn.Module):
    """conv3x3 → BN → SiLU blocks (max-pooled where `pool_after`), global
    average pool, fc. `spec` lists (name, in_ch, out_ch, pool_after)."""

    def __init__(self, spec, feature_dim: int, dtype: torch.dtype):
        super().__init__()
        self.spec = [(name, pool) for name, _, _, pool in spec]
        for name, cin, cout, _ in spec:
            self.add_module(f"conv{name}",
                            Conv2d(cin, cout, 3, padding=1, dtype=dtype))
            self.add_module(f"bn{name}", BatchNorm2d(cout, dtype=dtype))
        self.fc = Linear(spec[-1][2], feature_dim, dtype=dtype)

    def forward(self, x):
        for name, pool in self.spec:
            x = F.silu(getattr(self, f"bn{name}")(
                getattr(self, f"conv{name}")(x)))
            if pool:
                x = F.max_pool2d(x, 2)
        return self.fc(x.mean(dim=(2, 3)))


def _mnist_encoder(feature_dim: int, dtype: torch.dtype) -> _BNEncoder:
    """Light encoder for 1x32x32 (ref ratio_flexible.py:185-232)."""
    return _BNEncoder([("1", 1, 32, True), ("2", 32, 64, True),
                       ("3", 64, 128, True), ("4", 128, 128, False)],
                      feature_dim, dtype)


def _svhn_encoder(feature_dim: int, dtype: torch.dtype) -> _BNEncoder:
    """VGG-ish double-conv encoder 3x32x32 -> 2x2 (ref :235-302)."""
    spec, cin = [], 3
    for i, ch in enumerate([64, 128, 256, 256], start=1):
        spec += [(f"{i}a", cin, ch, False), (f"{i}b", ch, ch, True)]
        cin = ch
    return _BNEncoder(spec, feature_dim, dtype)


class RatioEstimatorMNISTSVHN(nn.Module):
    """Scores T(x, y) [B] for x [B,1,32,32] (MNIST) and y [B,3,32,32]
    (SVHN), NCHW."""

    def __init__(self, feature_dim: int = 256, hidden_dim: int = 512,
                 loss_type: str = "disc", dtype: torch.dtype = torch.float32,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.loss_type = loss_type
        self.dtype = dtype
        self.encoder_mnist = _mnist_encoder(feature_dim, dtype)
        self.encoder_svhn = _svhn_encoder(feature_dim, dtype)
        h = hidden_dim
        # Sequential indices 0/1/4/5/8/9/11 carry the reference's keys.
        self.score_net = nn.Sequential(
            Linear(2 * feature_dim, h, dtype), LayerNorm(h, norm_eps, dtype),
            nn.SiLU(), nn.Dropout(0.1),
            Linear(h, h, dtype), LayerNorm(h, norm_eps, dtype),
            nn.SiLU(), nn.Dropout(0.1),
            Linear(h, h // 2, dtype), LayerNorm(h // 2, norm_eps, dtype),
            nn.SiLU(), Linear(h // 2, 1, dtype))
        flax_init_(self)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        z = torch.cat([self.encoder_mnist(x), self.encoder_svhn(y)], dim=-1)
        return self.score_net(z).squeeze(-1)

    def log_ratio(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return log_ratio_from_scores(self(x, y), self.loss_type)
