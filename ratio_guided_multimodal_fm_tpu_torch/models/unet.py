"""Flexible U-Net velocity networks (port of models/unet.py), NCHW.

Submodule names give exactly the reference torch state-dict keys that the
JAX package's exporter emits (interop/torch_export.py:export_unet), so a
reference-layout .pth loads with `load_state_dict(strict=True)`:

* MNIST  (in=1, ch=32, mult=(1,2)):     901,121 params
* SVHN   (in=3, ch=64, mult=(1,2,2)): 6,074,371 params

Skip bookkeeping: the encoder pushes the input-conv feature, every ResBlock
output and every Downsample output; the decoder pops num_res_blocks+1
skips per level and concatenates them after h. out_conv is zero-initialised.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNormSiLU,
    Linear,
    ResBlock,
    Upsample,
    flax_init_,
    timestep_embedding,
)


class FlexibleUNet(nn.Module):
    """U-Net predicting the CFM velocity v = f(x_t, t): x [B, C, H, W],
    t [B] in [0, 1] -> v [B, C, H, W] in the compute dtype."""

    def __init__(self, in_channels: int = 1, img_size: int = 28,
                 model_channels: int = 32,
                 channel_mult: Tuple[int, ...] = (1, 2),
                 num_res_blocks: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, norm_eps: float = 1e-6):
        super().__init__()
        self.in_channels = in_channels
        self.img_size = img_size
        self.model_channels = mc = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.dtype = dtype
        self.norm_eps = norm_eps
        time_dim = mc * 4
        kw = dict(dtype=dtype)
        rb = dict(time_dim=time_dim, dropout=dropout, dtype=dtype,
                  norm_eps=norm_eps)

        self.time_embed = nn.Sequential(Linear(mc, time_dim, **kw), nn.SiLU(),
                                        Linear(time_dim, time_dim, **kw))
        self.input_conv = Conv2d(in_channels, mc, 3, padding=1, **kw)

        self.encoder_blocks = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        chans = [mc]
        ch = mc
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                self.encoder_blocks.append(ResBlock(ch, mc * mult, **rb))
                ch = mc * mult
                chans.append(ch)
            if level < len(self.channel_mult) - 1:
                self.downsamplers.append(Downsample(ch, **kw))
                chans.append(ch)

        self.middle_block1 = ResBlock(ch, ch, **rb)
        self.middle_block2 = ResBlock(ch, ch, **rb)

        self.decoder_blocks = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        for level in reversed(range(len(self.channel_mult))):
            out = mc * self.channel_mult[level]
            for _ in range(num_res_blocks + 1):
                self.decoder_blocks.append(ResBlock(ch + chans.pop(), out,
                                                    **rb))
                ch = out
            if level > 0:
                self.upsamplers.append(Upsample(ch, **kw))

        self.out_norm = GroupNormSiLU(ch, norm_eps, dtype)
        self.out_conv = Conv2d(ch, in_channels, 3, padding=1, **kw)
        flax_init_(self)
        nn.init.zeros_(self.out_conv.weight)
        nn.init.zeros_(self.out_conv.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # time embedding in float32, then cast (JAX unet.py:65-67)
        t_emb = self.time_embed(
            timestep_embedding(t, self.model_channels).to(self.dtype))
        h = self.input_conv(x)
        hs = [h]
        blocks = iter(self.encoder_blocks)
        n_levels = len(self.channel_mult)
        for level in range(n_levels):
            for _ in range(self.num_res_blocks):
                h = next(blocks)(h, t_emb)
                hs.append(h)
            if level < n_levels - 1:
                h = self.downsamplers[level](h)
                hs.append(h)

        h = self.middle_block2(self.middle_block1(h, t_emb), t_emb)

        blocks = iter(self.decoder_blocks)
        ups = iter(self.upsamplers)
        for level in reversed(range(n_levels)):
            for _ in range(self.num_res_blocks + 1):
                h = next(blocks)(torch.cat([h, hs.pop()], dim=1), t_emb)
            if level > 0:
                h = next(ups)(h)
        return self.out_conv(self.out_norm(h))


def FlowMatchingUNet(**kw) -> FlexibleUNet:
    """Default MNIST-28 FM net: ch=32, mult=(1,2)."""
    return FlexibleUNet(in_channels=1, img_size=28, model_channels=32,
                        channel_mult=(1, 2), num_res_blocks=2, dropout=0.1,
                        **kw)


def FlowMatchingUNetMNIST(img_size: int = 28, **kw) -> FlexibleUNet:
    """MNIST FM net, 28 or 32 px."""
    return FlexibleUNet(in_channels=1, img_size=img_size, model_channels=32,
                        channel_mult=(1, 2), num_res_blocks=2, dropout=0.1,
                        **kw)


def FlowMatchingUNetSVHN(**kw) -> FlexibleUNet:
    """SVHN FM net: in=3, ch=64, mult=(1,2,2)."""
    return FlexibleUNet(in_channels=3, img_size=32, model_channels=64,
                        channel_mult=(1, 2, 2), num_res_blocks=2, dropout=0.1,
                        **kw)


def FlowMatchingUNet64(in_channels: int = 3, **kw) -> FlexibleUNet:
    """64x64 FM net: ch=96, mult=(1,2,2,4)."""
    return FlexibleUNet(in_channels=in_channels, img_size=64,
                        model_channels=96, channel_mult=(1, 2, 2, 4),
                        num_res_blocks=2, dropout=0.1, **kw)
