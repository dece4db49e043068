"""The encoder-decoder flow-matching model, `--model original` (port of
models/flow_matching.py), NCHW.

`FlowMatchingModel` (9,104,513 params): the sin-first sinusoidal time
embedding, a 4-conv encoder to a 256-d feature and an MLP + deconv decoder
back to a 1x28x28 velocity field. Submodule names are the reference torch
state-dict keys that the JAX package's exporter emits
(interop/torch_export.py:export_flow_matching_model), so a
reference-layout .pth loads with `load_state_dict(strict=True)`.

Each `silu(gn(conv(x)))` of the JAX module is a conv followed by one
`GroupNormSiLU` (the `ops.groupnorm.group_norm_silu` kernel on the card):
4 sites in the encoder (C 32/64/128/256 at 28/14/7/7 px) and 3 in the
decoder (128/64/32 at 14/28/28 px). flax's `ConvTranspose(4, 2, 'SAME')`
is torch's `ConvTranspose2d(k=4, s=2, p=1)` on the exporter's flipped
kernel. The encoder flattens and the decoder's fc1 unflattens in torch's
(C, H, W) order; the weight bridge permutes flax's (H, W, C) order
(interop/from_jax.py:flow_matching_state_dict).
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
    sinusoidal_embedding,
)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d whose float32 params are cast to the compute
    dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int, padding: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        return F.conv_transpose2d(x.to(d), self.weight.to(d),
                                  self.bias.to(d), self.stride, self.padding)


class _Encoder(nn.Module):
    """conv → GroupNorm(8)+SiLU ×4, 28 → 14 → 7 px, flatten, fc."""

    def __init__(self, in_ch: int, feature_dim: int, dtype: torch.dtype,
                 norm_eps: float):
        super().__init__()
        for i, (cin, cout, stride) in enumerate(
                [(in_ch, 32, 1), (32, 64, 2), (64, 128, 2), (128, 256, 1)],
                start=1):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=stride,
                                               padding=1, dtype=dtype))
            self.add_module(f"gn{i}", GroupNormSiLU(cout, norm_eps, dtype))
        self.fc = Linear(256 * 7 * 7, feature_dim, dtype=dtype)

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
        return self.fc(x.flatten(1))


class _Decoder(nn.Module):
    """fc1 to a 256x7x7 map, two deconvs 7 → 14 → 28, conv3, conv_out;
    GroupNorm(8)+SiLU after each of the deconvs and conv3."""

    def __init__(self, in_features: int, out_channels: int,
                 dtype: torch.dtype, norm_eps: float):
        super().__init__()
        self.fc1 = Linear(in_features, 256 * 7 * 7, dtype=dtype)
        self.deconv1 = ConvTranspose2d(256, 128, 4, 2, 1, dtype=dtype)
        self.deconv2 = ConvTranspose2d(128, 64, 4, 2, 1, dtype=dtype)
        self.conv3 = Conv2d(64, 32, 3, padding=1, dtype=dtype)
        self.conv_out = Conv2d(32, out_channels, 3, padding=1, dtype=dtype)
        for i, c in enumerate((128, 64, 32), start=1):
            self.add_module(f"gn{i}", GroupNormSiLU(c, norm_eps, dtype))

    def forward(self, features, t_emb):
        x = self.fc1(torch.cat([features, t_emb], dim=-1))
        x = x.reshape(x.shape[0], 256, 7, 7)
        x = self.gn1(self.deconv1(x))
        x = self.gn2(self.deconv2(x))
        x = self.gn3(self.conv3(x))
        return self.conv_out(x)


class FlowMatchingModel(nn.Module):
    """Velocity net v = f(x_t, t): x [B, C, 28, 28], t [B] in [0, 1] ->
    v [B, C, 28, 28] in the compute dtype."""

    def __init__(self, img_channels: int = 1, feature_dim: int = 256,
                 time_emb_dim: int = 128,
                 dtype: torch.dtype = torch.float32, norm_eps: float = 1e-6):
        super().__init__()
        self.img_channels = img_channels
        self.time_emb_dim = time_emb_dim
        self.dtype = dtype
        self.norm_eps = norm_eps
        self.encoder = _Encoder(img_channels, feature_dim, dtype, norm_eps)
        self.decoder = _Decoder(feature_dim + time_emb_dim, img_channels,
                                dtype, norm_eps)
        flax_init_(self)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # the embedding in float32, then cast (JAX flow_matching.py:75)
        t_emb = sinusoidal_embedding(t, self.time_emb_dim).to(self.dtype)
        return self.decoder(self.encoder(x.to(self.dtype)), t_emb)
