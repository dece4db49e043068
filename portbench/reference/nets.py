"""Plain PyTorch nets of the two configurations, as functions of a dict of
parameters keyed in the published torch layout (the state-dict keys of
foubari/ratio_guided_Multimodal_FM's models).

* `unet`: FlexibleUNet (src/models/unet_flexible.py): sinusoidal time
  embedding (cos first) through Linear-SiLU-Linear; ResBlocks
  GN-SiLU-conv3x3, + time bias, GN-SiLU-dropout-conv3x3, 1x1 skip where
  the channels change; stride-2 conv downsampling, nearest upsampling +
  conv; the decoder concatenates [h, skip]; GN-SiLU-conv3x3 out.
  GroupNorm has min(8, C) groups and eps 1e-6.
* `ratio_gn`: FlexibleRatioEstimator (src/models/ratio_flexible.py:69-182):
  two encoders conv3x3-GN-SiLU (2x2 max-pool after the first three),
  global mean, fc; score MLP Linear-LN-SiLU-Dropout twice, then Linear.
* `ratio_bn`: RatioEstimatorMNISTSVHN (src/models/ratio_flexible.py:
  305-385): BatchNorm encoders (MNIST: 4 convs; SVHN: 4 double convs),
  score MLP of three LN stages. BatchNorm with flax's semantics: batch
  mean and E[x²]-E[x]² in train mode, running = 0.9 running + 0.1 batch.

Any other kind is one file, `kinds/<kind>.py` (see `kinds/__init__.py`),
found by its name.

Everything is float32 NCHW. `Net.forward(..., train=True)` applies
dropout from the device's default generator and updates BatchNorm's
running statistics. The masks depend on the memory layout of the dropout's
input, so it is laid out as the GroupNorm+SiLU of the nets under test
leaves it: channels_last on the card, contiguous on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import kinds
from portbench.reference.precision import rounder

Layout = List[Tuple[str, Tuple[int, ...]]]


def _conv(pre: str, cin: int, cout: int, k: int) -> Layout:
    return [(f"{pre}.weight", (cout, cin, k, k)), (f"{pre}.bias", (cout,))]


def _dense(pre: str, cin: int, cout: int) -> Layout:
    return [(f"{pre}.weight", (cout, cin)), (f"{pre}.bias", (cout,))]


def _norm(pre: str, c: int) -> Layout:
    return [(f"{pre}.weight", (c,)), (f"{pre}.bias", (c,))]


def _bn(pre: str, c: int) -> Layout:
    return _norm(pre, c) + [(f"{pre}.running_mean", (c,)),
                            (f"{pre}.running_var", (c,)),
                            (f"{pre}.num_batches_tracked", ())]


# --------------------------------------------------------------- layouts

def _unet_plan(arch):
    """(encoder blocks, decoder blocks, levels) as (cin, cout) lists."""
    mc, mult, nrb = (arch["model_channels"], arch["channel_mult"],
                     arch["num_res_blocks"])
    enc, chans, ch = [], [mc], mc
    for level, m in enumerate(mult):
        for _ in range(nrb):
            enc.append((ch, mc * m))
            ch = mc * m
            chans.append(ch)
        if level < len(mult) - 1:
            chans.append(ch)
    mid = ch
    dec = []
    for level in reversed(range(len(mult))):
        out = mc * mult[level]
        for _ in range(nrb + 1):
            dec.append((ch + chans.pop(), out))
            ch = out
    return enc, mid, dec


def _resblock_layout(pre, cin, cout, tdim) -> Layout:
    lay = (_norm(f"{pre}.norm1", cin) + _conv(f"{pre}.conv1", cin, cout, 3)
           + _dense(f"{pre}.time_mlp.1", tdim, cout)
           + _norm(f"{pre}.norm2", cout)
           + _conv(f"{pre}.conv2", cout, cout, 3))
    if cin != cout:
        lay += _conv(f"{pre}.skip", cin, cout, 1)
    return lay


def unet_layout(arch) -> Layout:
    mc, mult, cin = arch["model_channels"], arch["channel_mult"], \
        arch["in_channels"]
    tdim = 4 * mc
    enc, mid, dec = _unet_plan(arch)
    lay = _dense("time_embed.0", mc, tdim) + _dense("time_embed.2", tdim,
                                                     tdim)
    lay += _conv("input_conv", cin, mc, 3)
    for i, (a, b) in enumerate(enc):
        lay += _resblock_layout(f"encoder_blocks.{i}", a, b, tdim)
    ch = mc
    for level, m in enumerate(mult[:-1]):
        ch = mc * m
        lay += _conv(f"downsamplers.{level}.conv", ch, ch, 3)
    lay += _resblock_layout("middle_block1", mid, mid, tdim)
    lay += _resblock_layout("middle_block2", mid, mid, tdim)
    for i, (a, b) in enumerate(dec):
        lay += _resblock_layout(f"decoder_blocks.{i}", a, b, tdim)
    for j, level in enumerate(reversed(range(1, len(mult)))):
        ch = mc * mult[level]
        lay += _conv(f"upsamplers.{j}.conv", ch, ch, 3)
    lay += _norm("out_norm", mc * mult[0]) + _conv("out_conv", mc * mult[0],
                                                     cin, 3)
    return lay


GN_STAGES = ((32, True), (64, True), (128, True), (128, False))
BN_MNIST = (("1", 1, 32, True), ("2", 32, 64, True), ("3", 64, 128, True),
            ("4", 128, 128, False))
BN_SVHN = tuple((f"{i}{ab}", cin if ab == "a" else ch, ch, ab == "b")
                for i, (cin, ch) in enumerate(
                    [(3, 64), (64, 128), (128, 256), (256, 256)], start=1)
                for ab in "ab")


def _score_layout(feat, h, stages) -> Layout:
    """Score MLP [2F -> h -> ... -> 1]: `stages` hidden widths, each a
    Linear and a LayerNorm at Sequential indices 4i and 4i+1 (the BN net's
    last stage has no dropout, so its final Linear sits at 4i+3)."""
    lay, cin = [], 2 * feat
    for i, w in enumerate(stages):
        lay += _dense(f"score_net.{4 * i}", cin, w) + _norm(
            f"score_net.{4 * i + 1}", w)
        cin = w
    return lay, cin


def ratio_gn_layout(arch) -> Layout:
    feat, h = arch["feature_dim"], arch["hidden_dim"]
    lay = []
    for enc, cin in (("encoder_x", arch["x_channels"]),
                     ("encoder_y", arch["y_channels"])):
        for i, (cout, _) in enumerate(GN_STAGES, start=1):
            lay += _conv(f"{enc}.conv{i}", cin, cout, 3) + _norm(
                f"{enc}.gn{i}", cout)
            cin = cout
        lay += _dense(f"{enc}.fc", 128, feat)
    score, cin = _score_layout(feat, h, (h, h // 2))
    return lay + score + _dense("score_net.8", cin, 1)


def ratio_bn_layout(arch) -> Layout:
    feat, h = arch["feature_dim"], arch["hidden_dim"]
    lay = []
    for enc, spec in (("encoder_mnist", BN_MNIST), ("encoder_svhn",
                                                     BN_SVHN)):
        for name, cin, cout, _ in spec:
            lay += _conv(f"{enc}.conv{name}", cin, cout, 3) + _bn(
                f"{enc}.bn{name}", cout)
        lay += _dense(f"{enc}.fc", spec[-1][2], feat)
    score, cin = _score_layout(feat, h, (h, h, h // 2))
    return lay + score + _dense("score_net.11", cin, 1)


LAYOUTS = {"unet": unet_layout, "ratio_gn": ratio_gn_layout,
           "ratio_bn": ratio_bn_layout}


# --------------------------------------------------------------- layers

class _Ops:
    """conv / dense / norms in one precision, dropout and BatchNorm in one
    mode."""

    def __init__(self, P: Dict[str, torch.Tensor], precision: str,
                 device: torch.device, train: bool):
        self.P = P
        self.r = rounder(precision, device)
        self.train = train
        self.cuda = device.type == "cuda"

    def conv(self, pre, x, stride=1):
        w, b = self.P[f"{pre}.weight"], self.P[f"{pre}.bias"]
        if self.r is not None:
            x, w = self.r(x), self.r(w)
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)

    def dense(self, pre, x):
        w, b = self.P[f"{pre}.weight"], self.P[f"{pre}.bias"]
        if self.r is not None:
            x, w = self.r(x), self.r(w)
        return F.linear(x, w, b)

    def gn_silu(self, pre, x, eps):
        C = x.shape[1]
        return F.silu(F.group_norm(x, min(8, C), self.P[f"{pre}.weight"],
                                   self.P[f"{pre}.bias"], eps))

    def layer_norm(self, pre, x, eps):
        return F.layer_norm(x, x.shape[-1:], self.P[f"{pre}.weight"],
                            self.P[f"{pre}.bias"], eps)

    def dropout(self, x, p):
        if not self.train or p == 0.0:
            return x
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last if self.cuda
                             else torch.contiguous_format)
        return F.dropout(x, p, training=True)

    def batch_norm(self, pre, x, eps=1e-5):
        P = self.P
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                for key, new in (("running_mean", mean),
                                 ("running_var", var)):
                    run = P[f"{pre}.{key}"]
                    run.copy_(0.9 * run + 0.1 * new)
                P[f"{pre}.num_batches_tracked"].add_(1)
        else:
            mean, var = P[f"{pre}.running_mean"], P[f"{pre}.running_var"]
        mul = torch.rsqrt(var + eps) * P[f"{pre}.weight"]
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + P[f"{pre}.bias"][None, :, None, None])


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unet_forward(o: _Ops, arch, x, t):
    eps, p = arch.get("norm_eps", 1e-6), arch["dropout"]
    mc, mult, nrb = (arch["model_channels"], arch["channel_mult"],
                     arch["num_res_blocks"])
    temb = o.dense("time_embed.2", F.silu(o.dense(
        "time_embed.0", timestep_embedding(t, mc))))
    tact = F.silu(temb)

    def block(pre, h, cin, cout):
        a = o.conv(f"{pre}.conv1", o.gn_silu(f"{pre}.norm1", h, eps))
        a = a + o.dense(f"{pre}.time_mlp.1", tact)[:, :, None, None]
        a = o.conv(f"{pre}.conv2", o.dropout(o.gn_silu(f"{pre}.norm2", a,
                                                       eps), p))
        return a + (o.conv(f"{pre}.skip", h) if cin != cout else h)

    enc, mid, dec = _unet_plan(arch)
    h = o.conv("input_conv", x)
    hs, i = [h], 0
    for level in range(len(mult)):
        for _ in range(nrb):
            h = block(f"encoder_blocks.{i}", h, *enc[i])
            hs.append(h)
            i += 1
        if level < len(mult) - 1:
            h = o.conv(f"downsamplers.{level}.conv", h, stride=2)
            hs.append(h)
    h = block("middle_block1", h, mid, mid)
    h = block("middle_block2", h, mid, mid)
    i, j = 0, 0
    for level in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            h = block(f"decoder_blocks.{i}", torch.cat([h, hs.pop()], 1),
                      *dec[i])
            i += 1
        if level > 0:
            h = o.conv(f"upsamplers.{j}.conv",
                       F.interpolate(h, scale_factor=2, mode="nearest"))
            j += 1
    return o.conv("out_conv", o.gn_silu("out_norm", h, eps))


def _score(o: _Ops, z, n_stages, eps, last):
    for i in range(n_stages):
        z = F.silu(o.layer_norm(f"score_net.{4 * i + 1}",
                                o.dense(f"score_net.{4 * i}", z), eps))
        if i < 2:
            z = o.dropout(z, 0.1)
    return o.dense(f"score_net.{last}", z).squeeze(-1)


def ratio_gn_forward(o: _Ops, arch, x, y):
    eps = arch.get("norm_eps", 1e-6)
    feats = []
    for enc, v in (("encoder_x", x), ("encoder_y", y)):
        for i, (_, pool) in enumerate(GN_STAGES, start=1):
            v = o.gn_silu(f"{enc}.gn{i}", o.conv(f"{enc}.conv{i}", v), eps)
            if pool:
                v = F.max_pool2d(v, 2)
        feats.append(o.dense(f"{enc}.fc", v.mean(dim=(2, 3))))
    return _score(o, torch.cat(feats, -1), 2, eps, 8)


def ratio_bn_forward(o: _Ops, arch, x, y):
    eps = arch.get("norm_eps", 1e-6)
    feats = []
    for enc, spec, v in (("encoder_mnist", BN_MNIST, x),
                         ("encoder_svhn", BN_SVHN, y)):
        for name, _, _, pool in spec:
            v = F.silu(o.batch_norm(f"{enc}.bn{name}",
                                    o.conv(f"{enc}.conv{name}", v)))
            if pool:
                v = F.max_pool2d(v, 2)
        feats.append(o.dense(f"{enc}.fc", v.mean(dim=(2, 3))))
    return _score(o, torch.cat(feats, -1), 3, eps, 11)


FORWARDS = {"unet": unet_forward, "ratio_gn": ratio_gn_forward,
            "ratio_bn": ratio_bn_forward}


class Net:
    """One reference net: `kind` (a key of LAYOUTS, or a file of
    `kinds/`), its `arch` and its parameters P (float32, keyed as the
    published state dict)."""

    def __init__(self, kind: str, arch: dict, P: Dict[str, torch.Tensor]):
        self.forward = (FORWARDS[kind] if kind in FORWARDS
                        else kinds.load(kind).forward)
        self.kind, self.arch, self.P = kind, dict(arch), P

    def __call__(self, a, b, precision: str = "fp32", train: bool = False):
        """unet: (x NCHW, t [B]) -> v NCHW; ratio nets: (x, y NCHW) ->
        scores [B] (log r̂ for the disc loss)."""
        o = _Ops(self.P, precision, a.device, train)
        return self.forward(o, self.arch, a, b)

    def trainable(self) -> List[str]:
        """Keys of the parameters (not BatchNorm's buffers)."""
        return [k for k, _ in layout(self.kind, self.arch)
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))]


def layout(kind: str, arch: dict) -> Layout:
    if kind in LAYOUTS:
        return LAYOUTS[kind](arch)
    return kinds.load(kind).layout(arch)


def param_count(kind: str, arch: dict) -> int:
    """Trainable parameters (BatchNorm buffers left out)."""
    return sum(math.prod(s) for k, s in layout(kind, arch)
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked")))


def nhwc_velocity(net: Net, x_nhwc: torch.Tensor, t: torch.Tensor,
                  precision: str = "fp32",
                  train: bool = False) -> torch.Tensor:
    return net(x_nhwc.permute(0, 3, 1, 2), t, precision,
               train).permute(0, 2, 3, 1)


def nhwc_scores(net: Net, x_nhwc, y_nhwc, precision: str = "fp32",
                train: bool = False) -> torch.Tensor:
    return net(x_nhwc.permute(0, 3, 1, 2), y_nhwc.permute(0, 3, 1, 2),
               precision, train)

