"""Merged-pair U-Net evaluation (port of models/merged.py): the sampler's
two velocity nets run as one network of grouped convolutions.

Two FlexibleUNets of identical topology (weights may differ) evaluate as
one: every conv pair runs as `F.conv2d(groups=2)` with the two weights
concatenated on torch's out axis (dim 0), which is exact block-diagonal
math with half the launches. Activations are part-major channel concats
[B, 2C, H, W] (part x first). Each GroupNorm+SiLU site is one launch of the
`ops.groupnorm.group_norm_silu` kernel with 2g groups over the 2C channels:
exact, because each part's C divides by its g = min(8, C) groups, so no
group straddles the part boundary. The time MLPs run per part on stacked
[2, O, I] weights. The decoder's skip concat interleaves per part
([h_x, s_x, h_y, s_y]), so the stored concat-form ResBlock weights apply
unchanged. Deterministic (dropout off): sampling only.

Public API (NHWC in and out, like the samplers' velocity closures):
  can_merge(model_x, model_y)            -> bool
  merge_unet_params(sd_x, sd_y, dtype)   -> merged state dict
  make_merged_velocity_fn(model)         -> fn(merged, x, y, t) -> (vx, vy)
  merged_pair_apply(model)               -> bind(model_x, model_y)
                                            -> pair_fn(x, y, t) -> (vx, vy)

The JAX package measured the merged program 31% slower than two nets on
v5e and keeps it opt-in (`--merged_unet`); so does the port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.models.layers import (
    timestep_embedding,
)
from ratio_guided_multimodal_fm_tpu_torch.ops.groupnorm import group_norm_silu

StateDict = Dict[str, torch.Tensor]

_MERGE_FIELDS = ("in_channels", "img_size", "model_channels",
                 "channel_mult", "num_res_blocks", "norm_eps")
_NORMS = ("norm1", "norm2", "out_norm")


def can_merge(model_x, model_y) -> bool:
    """True when the two FlexibleUNets have identical topology (weights may
    differ), so that their pair evaluation can run as one network."""
    try:
        return all(getattr(model_x, f) == getattr(model_y, f)
                   for f in _MERGE_FIELDS)
    except AttributeError:
        return False


def _is_dense(key: str) -> bool:
    return key.startswith("time_embed.") or ".time_mlp." in key


def merge_unet_params(sd_x: StateDict, sd_y: StateDict,
                      dtype: Optional[torch.dtype] = None) -> StateDict:
    """Merge two same-topology FlexibleUNet state dicts:

    conv weights (O, I, kh, kw) -> (2O, I, kh, kw)   [out-axis concat: the
        grouped-conv layout; group g reads input slice g]
    dense weights (O, I) and biases (O,) -> (2, O, I) and (2, O) stacked
    conv biases, GroupNorm weights and biases -> per-part concat

    With `dtype`, every tensor but the GroupNorm affine (float32 in the
    kernel) is cast to it once here instead of at every use."""
    out = {}
    for k, a in sd_x.items():
        b = sd_y[k]
        m = torch.stack([a, b]) if _is_dense(k) else torch.cat([a, b])
        if dtype is not None and k.split(".")[-2] not in _NORMS:
            m = m.to(dtype)
        out[k] = m
    return out


def _gconv(h, p: StateDict, name: str, *, stride=1, pad=1):
    """Grouped conv over the merged layout (part x = group 0)."""
    w = p[f"{name}.weight"]
    return F.conv2d(h, w.to(h.dtype), p[f"{name}.bias"].to(h.dtype), stride,
                    pad, groups=2)


def _gn_silu(h, p: StateDict, name: str, g_part: int, eps: float):
    """Per-part GroupNorm+SiLU: 2·g_part groups over the 2C channels."""
    return group_norm_silu(h, p[f"{name}.weight"], p[f"{name}.bias"],
                           2 * g_part, eps)


def _dense(e, p: StateDict, name: str):
    """Per-part Linear on [2, B, I] -> [2, B, O]."""
    w, b = p[f"{name}.weight"].to(e.dtype), p[f"{name}.bias"].to(e.dtype)
    return torch.baddbmm(b[:, None, :], e, w.transpose(1, 2))


def _interleave(h, s):
    """[B, 2Ch, ...] + [B, 2Cs, ...] -> [B, 2(Ch + Cs), ...] ordered
    [h_x, s_x, h_y, s_y]."""
    ch, cs = h.shape[1] // 2, s.shape[1] // 2
    return torch.cat([h[:, :ch], s[:, :cs], h[:, ch:], s[:, cs:]], dim=1)


def _resblock(h, t_embs, p: StateDict, name: str, out_ch: int, eps: float):
    """Merged ResBlock (models/layers.py:ResBlock, dropout off)."""
    in_ch = h.shape[1] // 2
    z = _gn_silu(h, p, f"{name}.norm1", min(8, in_ch), eps)
    z = _gconv(z, p, f"{name}.conv1")
    tb = _dense(F.silu(t_embs), p, f"{name}.time_mlp.1")    # [2, B, O]
    z = z + tb.transpose(0, 1).reshape(h.shape[0], -1)[:, :, None, None]
    z = _gn_silu(z, p, f"{name}.norm2", min(8, out_ch), eps)
    z = _gconv(z, p, f"{name}.conv2")
    if in_ch != out_ch:
        h = _gconv(h, p, f"{name}.skip", pad=0)
    return z + h


def make_merged_velocity_fn(model) -> Callable:
    """fn(merged, x, y, t) -> (v_x, v_y) for a pair of nets with `model`'s
    topology (any FlexibleUNet; the weights are the merged state dict of
    `merge_unet_params`). x, y NHWC [B, H, W, C], t [B]; outputs NHWC in
    the model's compute dtype."""
    mc = model.model_channels
    cmult = tuple(model.channel_mult)
    nrb = model.num_res_blocks
    cin = model.in_channels
    dtype = model.dtype
    eps = model.norm_eps

    def fn(p: StateDict, x, y, t):
        # NHWC concat: its NCHW view is channels_last memory, as the single
        # nets' velocity closures see it
        h = torch.cat([x, y], dim=-1).to(dtype).permute(0, 3, 1, 2)
        t_emb = timestep_embedding(t, mc).to(dtype)
        t_embs = t_emb.unsqueeze(0).expand(2, -1, -1)
        t_embs = _dense(F.silu(_dense(t_embs, p, "time_embed.0")), p,
                        "time_embed.2")

        h = _gconv(h, p, "input_conv")
        hs = [h]
        blk = 0
        for level, mult in enumerate(cmult):
            for _ in range(nrb):
                h = _resblock(h, t_embs, p, f"encoder_blocks.{blk}",
                              mc * mult, eps)
                hs.append(h)
                blk += 1
            if level < len(cmult) - 1:
                h = _gconv(h, p, f"downsamplers.{level}.conv", stride=2)
                hs.append(h)

        ch = h.shape[1] // 2
        h = _resblock(h, t_embs, p, "middle_block1", ch, eps)
        h = _resblock(h, t_embs, p, "middle_block2", ch, eps)

        blk = 0
        for rev_idx, level in enumerate(reversed(range(len(cmult)))):
            for _ in range(nrb + 1):
                h = _resblock(_interleave(h, hs.pop()), t_embs, p,
                              f"decoder_blocks.{blk}", mc * cmult[level], eps)
                blk += 1
            if level > 0:
                h = _gconv(F.interpolate(h, scale_factor=2, mode="nearest"),
                           p, f"upsamplers.{rev_idx}.conv")

        h = _gn_silu(h, p, "out_norm", min(8, mc), eps)
        h = _gconv(h, p, "out_conv").permute(0, 2, 3, 1)
        return h[..., :cin].contiguous(), h[..., cin:].contiguous()

    return fn


def merged_pair_apply(model) -> Callable:
    """bind(model_x, model_y) -> pair_fn(x, y, t) -> (v_x, v_y): merges the
    two nets' weights once per bind (the samplers bind once per call, where
    JAX's jit hoists the merge out of its scan)."""
    fn = make_merged_velocity_fn(model)

    def bind(model_x, model_y):
        merged = merge_unet_params(model_x.state_dict(),
                                   model_y.state_dict(), model.dtype)
        return lambda x, y, t: fn(merged, x, y, t)

    return bind
