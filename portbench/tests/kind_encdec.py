"""A kind of net as one file, the worked example of PERF.md §4: the
encoder-decoder velocity net of `--model original`
(foubari/ratio_guided_Multimodal_FM `src/models/flow_matching.py`; the
port's `FlowMatchingModel`, 9,104,513 parameters at the defaults), written
from the published architecture against the contract of
`portbench/reference/kinds/`. The tests register it as
`portbench.reference.kinds.encdec`; a kind of the benchmark's own would be
this file under `portbench/reference/kinds/`.

x [B, C, S, S], t [B] -> v [B, C, S, S]: the sin-first sinusoidal time
embedding (frequencies exp(-ln(10^4) i / (half - 1))); an encoder of four
conv3x3 + GroupNorm(min(8, C))+SiLU stages (32, 64, 128, 256 channels,
strides 1, 2, 2, 1: S → S/2 → S/4), flattened in (C, H, W) order to a
`feature_dim` fc; a decoder fc1 from [features, t_emb] to a 256 × S/4 ×
S/4 map, two 4x4 stride-2 transposed convolutions (padding 1) to 128 and
64 channels, conv3x3 to 32 and conv3x3 out, with GroupNorm+SiLU after each
but the last. No dropout.

Arch keys: img_channels, img_size, feature_dim, time_emb_dim, norm_eps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ENCODER = ((32, 1), (64, 2), (128, 2), (256, 1))   # (channels, stride)
DECODER = (128, 64)                                 # the deconvs' outputs
LAST = 32                                           # conv3's output


def _pair(pre, w_shape):
    return [(f"{pre}.weight", w_shape), (f"{pre}.bias", (w_shape[0],))]


def layout(arch):
    c_img, s = arch["img_channels"], arch["img_size"] // 4
    feat, temb = arch["feature_dim"], arch["time_emb_dim"]
    lay, cin = [], c_img
    for i, (cout, _) in enumerate(ENCODER, start=1):
        lay += _pair(f"encoder.conv{i}", (cout, cin, 3, 3))
        lay += [(f"encoder.gn{i}.weight", (cout,)),
                (f"encoder.gn{i}.bias", (cout,))]
        cin = cout
    lay += _pair("encoder.fc", (feat, cin * s * s))
    lay += _pair("decoder.fc1", (cin * s * s, feat + temb))
    for i, cout in enumerate(DECODER, start=1):
        # ConvTranspose2d keeps its weight as (in, out, k, k)
        lay += [(f"decoder.deconv{i}.weight", (cin, cout, 4, 4)),
                (f"decoder.deconv{i}.bias", (cout,))]
        cin = cout
    lay += _pair("decoder.conv3", (LAST, cin, 3, 3))
    lay += _pair("decoder.conv_out", (c_img, LAST, 3, 3))
    for i, c in enumerate(DECODER + (LAST,), start=1):
        lay += [(f"decoder.gn{i}.weight", (c,)),
                (f"decoder.gn{i}.bias", (c,))]
    return lay


def time_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1) * torch.arange(
        half, dtype=torch.float32, device=t.device))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _deconv(o, pre, x):
    w, b = o.P[f"{pre}.weight"], o.P[f"{pre}.bias"]
    if o.r is not None:
        x, w = o.r(x), o.r(w)
    return F.conv_transpose2d(x, w, b, stride=2, padding=1)


def forward(o, arch, x, t):
    eps = arch["norm_eps"]
    for i, (_, stride) in enumerate(ENCODER, start=1):
        x = o.gn_silu(f"encoder.gn{i}", o.conv(f"encoder.conv{i}", x,
                                               stride), eps)
    feats = o.dense("encoder.fc", x.flatten(1))
    temb = time_embedding(t, arch["time_emb_dim"])
    s = arch["img_size"] // 4
    h = o.dense("decoder.fc1", torch.cat([feats, temb], -1))
    h = h.reshape(h.shape[0], ENCODER[-1][0], s, s)
    for i in range(1, len(DECODER) + 1):
        h = o.gn_silu(f"decoder.gn{i}", _deconv(o, f"decoder.deconv{i}", h),
                      eps)
    h = o.gn_silu(f"decoder.gn{len(DECODER) + 1}",
                  o.conv("decoder.conv3", h), eps)
    return o.conv("decoder.conv_out", h)


def flops(arch, batch):
    """2 × MACs: a convolution k·k·cin·cout a pixel out, a transposed one
    k·k·cin·cout a pixel in."""
    size, cin, fl = arch["img_size"], arch["img_channels"], 0.0
    for cout, stride in ENCODER:
        size //= stride
        fl += 2.0 * size * size * 9 * cin * cout
        cin = cout
    flat = cin * size * size
    fl += 2.0 * flat * arch["feature_dim"]
    fl += 2.0 * (arch["feature_dim"] + arch["time_emb_dim"]) * flat
    for cout in DECODER:
        fl += 2.0 * size * size * 16 * cin * cout
        cin, size = cout, 2 * size
    fl += 2.0 * size * size * 9 * (cin * LAST + LAST * arch["img_channels"])
    return batch * fl


def gn_sites(arch):
    size, sites = arch["img_size"], []
    for cout, stride in ENCODER:
        size //= stride
        sites.append((cout, size))
    for cout in DECODER:
        size *= 2
        sites.append((cout, size))
    return sites + [(LAST, size)]
