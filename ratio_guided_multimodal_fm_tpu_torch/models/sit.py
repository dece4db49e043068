"""SiT, the Scalable Interpolant Transformer (Ma et al., arXiv:2401.08740;
github.com/willisma/SiT models.py), on the DiT backbone (Peebles & Xie,
arXiv:2212.09748): a class-conditional velocity net over latents.

x [B, C, H, W] is cut into p×p patches (a stride-p convolution) and gets
the fixed 2-D sin-cos position table; the conditioning vector is
c = t_emb + y_emb, with t_emb = MLP(the cos-first 256-d embedding of t,
`layers.timestep_embedding`) and y_emb a row of a (num_classes + 1)-row
table whose last row is the null class. In train mode each label is
dropped to the null class with probability `class_dropout_prob`, drawn
as SiT draws it: `torch.rand(B) < p` from the device's default generator
(the fused trainer seeds it once a macro step, and a CUDA graph replays
the draw).

Each block is adaLN-Zero: SiLU and a hidden → 6·hidden linear on c give
shift, scale and gate for attention and for the MLP, and each branch is
x + gate·f(LN(x)·(1 + scale) + shift), LayerNorm without affine at eps
1e-6; f is multi-head attention (qkv with bias, `ops.attention.sdpa`,
the memory-efficient backend on the card) or the tanh-GELU MLP. The four
token projections are `TokenLinear`: in float32 the 3×TF32 kernel of
`ops.linear` on the card. The final
layer modulates the same way and projects each token to p·p·C_out values;
unpatchify gives [B, C_out, H, W] and, with `learn_sigma`, C_out = 2·C and
`forward` keeps the first C channels.

State-dict keys are SiT's own (`x_embedder.proj.*`, `t_embedder.mlp.{0,2}.*`,
`y_embedder.embedding_table.weight`, `blocks.{i}.attn.qkv.*`,
`blocks.{i}.attn.proj.*`, `blocks.{i}.mlp.fc1.*`, `blocks.{i}.mlp.fc2.*`,
`blocks.{i}.adaLN_modulation.1.*`, `final_layer.linear.*`,
`final_layer.adaLN_modulation.1.*`), with one departure: SiT stores
`pos_embed` as a `requires_grad=False` Parameter; here the fixed table is a
non-persistent buffer, out of the state dict, rebuilt on the model's
device whenever the module's tensors are replaced or moved (`_apply`:
`to`, `to_empty`, `cuda`). A SiT checkpoint loads with `strict=True` once
its `pos_embed` key is dropped.

The initialisation is SiT's (`initialize_weights`): xavier-uniform linears
with zero biases, the patch projection xavier-uniform over its flattened
kernel, N(0, 0.02²) label table and time MLP, zero adaLN modulations and
a zero final linear. Every module computes in `dtype` (float32 or
bfloat16; params stay float32), LayerNorm in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    timestep_embedding,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.attention import sdpa
from ratio_guided_multimodal_fm_tpu_torch.ops.linear import linear_tf32x3

FREQ_DIM = 256     # the time embedding's sinusoid width (SiT's default)
LN_EPS = 1e-6


def sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """SiT's get_2d_sincos_pos_embed: [grid², dim] float64, the first half
    the sin-cos embedding of each token's column, the second of its row
    (np.meshgrid(w, h) order), each half sin then cos over frequencies
    1 / 10000^(i / (dim/4))."""
    g = np.arange(grid, dtype=np.float32)
    ww, hh = np.meshgrid(g, g)

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        out = np.einsum("m,d->md", pos.reshape(-1), 1.0 / 10000 ** omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one_d(dim // 2, ww), one_d(dim // 2, hh)],
                          axis=1)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis without affine, eps 1e-6, in float32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)


class PatchEmbed(nn.Module):
    """[B, C, H, W] -> [B, (H/p)·(W/p), hidden] (timm's PatchEmbed)."""

    def __init__(self, patch_size: int, in_channels: int, hidden: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(in_channels, hidden, patch_size,
                           stride=patch_size, dtype=dtype)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.mlp = nn.Sequential(Linear(FREQ_DIM, hidden, dtype=dtype),
                                 nn.SiLU(), Linear(hidden, hidden,
                                                   dtype=dtype))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, FREQ_DIM))


class LabelEmbedder(nn.Module):
    """The label table, with a null-class row where labels may drop."""

    def __init__(self, num_classes: int, hidden: int, dropout_prob: float,
                 dtype: torch.dtype):
        super().__init__()
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden)
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.dtype = dtype

    def forward(self, labels, train: bool):
        if train and self.dropout_prob > 0:
            drop = torch.rand(labels.shape[0],
                              device=labels.device) < self.dropout_prob
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels).to(self.dtype)


class TokenLinear(Linear):
    """A block's token projection (attn.qkv, attn.proj, mlp.fc1, mlp.fc2):
    in float32 `ops.linear.linear_tf32x3`, the 3×TF32 tensor-core kernel
    on the card (F.linear on the CPU), forward and backward; in bfloat16
    `layers.Linear`'s F.linear, which cuBLAS already runs on the tensor
    cores. The skinny products (adaLN, the time MLP, the final layer) stay
    `layers.Linear`."""

    def forward(self, x):
        d = self.dtype
        if d != torch.float32:
            return super().forward(x)
        return linear_tf32x3(x.to(d), self.weight.to(d), self.bias.to(d))


class Attention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = TokenLinear(hidden, 3 * hidden, dtype=dtype)
        self.proj = TokenLinear(hidden, hidden, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads,
                                      C // self.num_heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        return self.proj(sdpa(q, k, v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = TokenLinear(hidden, mlp_hidden, dtype=dtype)
        self.fc2 = TokenLinear(mlp_hidden, hidden, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiTBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype):
        super().__init__()
        self.attn = Attention(hidden, num_heads, dtype)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden, 6 * hidden, dtype=dtype))

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=1)
        x = x + gate_msa.unsqueeze(1) * self.attn(
            modulate(_layer_norm(x), shift_msa, scale_msa))
        return x + gate_mlp.unsqueeze(1) * self.mlp(
            modulate(_layer_norm(x), shift_mlp, scale_mlp))


class FinalLayer(nn.Module):
    def __init__(self, hidden: int, patch_size: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.linear = Linear(hidden, patch_size * patch_size * out_channels,
                             dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden, 2 * hidden, dtype=dtype))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(_layer_norm(x), shift, scale))


class SiT(nn.Module):
    """forward(x [B, C, H, W], t [B] in [0, 1], y [B] int64) -> v
    [B, C, H, W]."""

    def __init__(self, input_size: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, class_dropout_prob: float = 0.1,
                 num_classes: int = 1000, learn_sigma: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.patch_size = patch_size
        self.grid = input_size // patch_size
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size,
                                     dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size,
                                        class_dropout_prob, dtype)
        self.register_buffer("pos_embed", torch.empty(
            1, self.grid * self.grid, hidden_size), persistent=False)
        self.blocks = nn.ModuleList([
            SiTBlock(hidden_size, num_heads, mlp_ratio, dtype)
            for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size,
                                      self.out_channels, dtype)
        self.initialize_weights()
        self._fill_pos_embed()

    @torch.no_grad()
    def initialize_weights(self) -> None:
        """SiT's initialize_weights (pos_embed aside: `_fill_pos_embed`)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.constant_(m.bias, 0)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.constant_(self.x_embedder.proj.bias, 0)
        nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02)
        nn.init.normal_(self.t_embedder.mlp[0].weight, std=0.02)
        nn.init.normal_(self.t_embedder.mlp[2].weight, std=0.02)
        for layer in [b.adaLN_modulation[-1] for b in self.blocks] + [
                self.final_layer.adaLN_modulation[-1],
                self.final_layer.linear]:
            nn.init.constant_(layer.weight, 0)
            nn.init.constant_(layer.bias, 0)

    @torch.no_grad()
    def _fill_pos_embed(self) -> None:
        """The fixed position table, built on the host and copied onto the
        buffer's device (nothing to fill on `meta`)."""
        pos = self.pos_embed
        if pos.device.type != "meta":
            pos.copy_(torch.from_numpy(sincos_pos_embed(
                pos.shape[-1], self.grid)).float().unsqueeze(0))

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._fill_pos_embed()
        return out

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, p·p·C] -> [B, C, H, W]."""
        c, p, h = self.out_channels, self.patch_size, self.grid
        x = x.reshape(x.shape[0], h, h, p, p, c)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(
            x.shape[0], c, h * p, h * p)

    def forward(self, x, t, y):
        x = self.x_embedder(x) + self.pos_embed.to(x.dtype)
        c = self.t_embedder(t) + self.y_embedder(y, self.training)
        for block in self.blocks:
            x = block(x, c)
        x = self.unpatchify(self.final_layer(x, c))
        return x[:, :self.in_channels]


def SiT_XL_2(**kwargs) -> SiT:
    """SiT-XL/2: depth 28, hidden 1,152, 16 heads of 72, patch 2
    (674,834,720 parameters at 32×32×4 latents and 1,000 classes)."""
    return SiT(depth=28, hidden_size=1152, patch_size=2, num_heads=16,
               **kwargs)


def SiT_S_2(**kwargs) -> SiT:
    """SiT-S/2: depth 12, hidden 384, 6 heads of 64, patch 2."""
    return SiT(depth=12, hidden_size=384, patch_size=2, num_heads=6,
               **kwargs)
