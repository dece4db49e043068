"""Shared model layers (port of models/layers.py), NCHW `nn.Module`s.

Every module takes a compute `dtype` (float32 or bfloat16) like flax's
`dtype=`: params stay float32 and are cast to the compute dtype at use;
normalisation statistics are float32. Inside the U-Nets, tensors are NCHW
in `channels_last` memory on the card (cuDNN's native layout for bf16).

* `timestep_embedding`   — cos-first, exp(-log(P)·i/half)   (JAX :48-62)
* `sinusoidal_embedding` — sin-first, denominator (half-1)  (JAX :65-71)
* `GroupNormSiLU`        — GroupNorm(min(8, C)) + SiLU through the
  `ops.groupnorm.group_norm_silu` kernel on CUDA (JAX :85-142); the
  factories `group_norm` and `gn_silu`                      (JAX :74, :135)
* `ResBlock`, `Downsample`, `Upsample`                        (JAX :226-323)
* `flax_init_`           — flax's default initialisers, with which every
  JAX net starts

The decoder's skip concat is materialised (`torch.cat([h, skip], 1)`, the
JAX `split_skip=False` graph): same math and same params as the JAX
default split-skip form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import group_norm_silu


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos-first variant: t [B] -> [B, dim] float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, sin-first variant: t [B] -> [B, dim] float32."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32,
                                            device=t.device))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated at ±2


@torch.no_grad()
def flax_init_(module: nn.Module) -> nn.Module:
    """Re-initialise every convolution, transposed convolution and Linear of
    `module` in place as flax's defaults do, as the JAX package's nets
    start: kernels from lecun_normal (a normal truncated at ±2 std,
    variance 1 / fan_in, fan_in = input channels × kernel taps), biases
    zero; normalisation layers already start as flax's (scale 1, bias 0).
    torch's own defaults (kaiming-uniform kernels with a third of that
    variance, uniform biases) left the experiment-1 ratio net on the 2 ln 2
    plateau for 22 epochs of 20k synthetic digits; with these it left it in
    the second epoch (PERF.md). Every port net calls it in its constructor,
    before any init of its own (the U-Nets' zero out_conv). Returns
    `module`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # weight [out, in, kh, kw] ([in, out, kh, kw] transposed)
            fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0]).numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                m.bias.zero_()
    return module


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 params are cast to the compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d),
                        self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear whose float32 params are cast to the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class GroupNormSiLU(nn.Module):
    """silu(GroupNorm(min(8, C))(x)): float32 statistics, fast variance
    E[x²]−E[x]², eps 1e-6 by default (the JAX convention; pass 1e-5 for
    torch's). Params `weight`/`bias` [C] as in torch's nn.GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = min(8, channels)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x.to(self.dtype), self.weight, self.bias,
                               self.num_groups, self.eps)


def group_norm(ch: int, eps: float = 1e-6) -> nn.GroupNorm:
    """GroupNorm(min(8, ch)) as the reference U-Nets use it (JAX :74),
    eps 1e-6 by the JAX convention (1e-5 is torch's)."""
    return nn.GroupNorm(min(8, ch), ch, eps=eps)


def gn_silu(ch: int, eps: float = 1e-6,
            dtype: torch.dtype = torch.float32) -> GroupNormSiLU:
    """GroupNorm(min(8, ch)) followed by SiLU on kernel B (JAX :135)."""
    return GroupNormSiLU(ch, eps, dtype)


class ResBlock(nn.Module):
    """GN→SiLU→conv3x3 → (+ time-MLP bias) → GN→SiLU→dropout→conv3x3, with
    a 1x1 skip conv when the channel counts differ (JAX :226-296)."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_ch, norm_eps, dtype)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.time_mlp = nn.Sequential(nn.SiLU(),
                                      Linear(time_dim, out_ch, dtype=dtype))
        self.norm2 = GroupNormSiLU(out_ch, norm_eps, dtype)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.skip: Optional[Conv2d] = (
            Conv2d(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch
            else None)

    def forward(self, x, t_emb):
        h = self.conv1(self.norm1(x))
        h = h + self.time_mlp(t_emb)[:, :, None, None]
        h = self.conv2(self.dropout(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class Downsample(nn.Module):
    """2x downsample via a stride-2 conv3x3."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """2x nearest upsample, then conv3x3."""

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
