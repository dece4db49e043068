"""Frozen operation and byte counts: the yardstick the per-layer metrics
divide by. FLOPs are 2 × MACs of convolutions and dense layers
(normalisations and elementwise ops are bandwidth, not counted), copied
from the port's `core/flops.py` and extended with the two ratio nets and
the GroupNorm+SiLU sites. Bytes count each input read once and each output
written once, at the cell's shapes and dtypes. A kind of net beyond the
three here brings its counts in its own file
(`portbench/reference/kinds/<kind>.py`: `flops`, and `gn_sites` where it
has any)."""
from __future__ import annotations

from typing import Callable, List, Tuple

from portbench.reference import kinds

# (C, H) of one GroupNorm+SiLU site of a net's forward, per example
Site = Tuple[int, int]

TRAIN_FLOP_FACTOR = 3.0   # forward + backward (two products a layer)


def flexible_unet_flops_per_call(batch, img_size, in_channels,
                                 model_channels, channel_mult,
                                 num_res_blocks=2) -> float:
    """FLOPs of one FlexibleUNet forward (copy of core/flops.py)."""
    B = batch
    fl = 0.0

    def conv(h, cin, cout, stride=1, k=3):
        nonlocal fl
        ho = h // stride
        fl += 2.0 * B * ho * ho * k * k * cin * cout

    def dense(cin, cout):
        nonlocal fl
        fl += 2.0 * B * cin * cout

    mc = model_channels
    time_dim = mc * 4
    dense(mc, time_dim)
    dense(time_dim, time_dim)

    def resblock(h, cin, cout):
        conv(h, cin, cout)
        dense(time_dim, cout)
        conv(h, cout, cout)
        if cin != cout:
            conv(h, cin, cout, k=1)

    conv(img_size, in_channels, mc)
    chans = [mc]
    h, c = img_size, mc
    for lvl, m in enumerate(channel_mult):
        out = mc * m
        for _ in range(num_res_blocks):
            resblock(h, c, out)
            c = out
            chans.append(c)
        if lvl < len(channel_mult) - 1:
            conv(h, c, c, stride=2)
            h //= 2
            chans.append(c)
    resblock(h, c, c)
    resblock(h, c, c)
    for lvl in reversed(range(len(channel_mult))):
        out = mc * channel_mult[lvl]
        for _ in range(num_res_blocks + 1):
            skip = chans.pop()
            resblock(h, c + skip, out)
            c = out
        if lvl > 0:
            h *= 2
            conv(h, c, c)
    conv(img_size, c, in_channels)
    return fl


def unet_flops(arch: dict, batch: int) -> float:
    return flexible_unet_flops_per_call(
        batch, arch["img_size"], arch["in_channels"], arch["model_channels"],
        tuple(arch["channel_mult"]), arch["num_res_blocks"])


def unet_gn_sites(arch: dict) -> List[Site]:
    """Every GroupNorm+SiLU site of one FlexibleUNet forward: each
    ResBlock's norm1 (its input channels) and norm2 (its output channels),
    then out_norm."""
    mc, mult, nrb = (arch["model_channels"], arch["channel_mult"],
                     arch["num_res_blocks"])
    h, c = arch["img_size"], mc
    sites, chans = [], [mc]

    def block(cin, cout):
        sites.extend([(cin, h), (cout, h)])

    for lvl, m in enumerate(mult):
        for _ in range(nrb):
            block(c, mc * m)
            c = mc * m
            chans.append(c)
        if lvl < len(mult) - 1:
            h //= 2
            chans.append(c)
    block(c, c)
    block(c, c)
    for lvl in reversed(range(len(mult))):
        out = mc * mult[lvl]
        for _ in range(nrb + 1):
            block(c + chans.pop(), out)
            c = out
        if lvl > 0:
            h *= 2
    sites.append((c, h))
    return sites


GN_ENCODER = ((32, True), (64, True), (128, True), (128, False))


def ratio_gn_flops(arch: dict, batch: int, img_size: int) -> float:
    """FlexibleRatioEstimator: two conv-GN encoders (3x3 convs, 2x2 pools
    after the first three, flooring), fc to feature_dim, score MLP
    2F -> h -> h/2 -> 1."""
    fl, feat, hid = 0.0, arch["feature_dim"], arch["hidden_dim"]
    for cin in (arch["x_channels"], arch["y_channels"]):
        h = img_size
        for cout, pool in GN_ENCODER:
            fl += 2.0 * h * h * 9 * cin * cout
            cin = cout
            if pool:
                h //= 2
        fl += 2.0 * 128 * feat
    fl += 2.0 * (2 * feat * hid + hid * (hid // 2) + hid // 2)
    return batch * fl


def ratio_gn_sites(arch: dict, img_size: int) -> List[Site]:
    sites = []
    for _ in (arch["x_channels"], arch["y_channels"]):
        h = img_size
        for cout, pool in GN_ENCODER:
            sites.append((cout, h))
            if pool:
                h //= 2
    return sites


BN_MNIST = ((1, 32, True), (32, 64, True), (64, 128, True),
            (128, 128, False))
BN_SVHN = ((3, 64, False), (64, 64, True), (64, 128, False),
           (128, 128, True), (128, 256, False), (256, 256, True),
           (256, 256, False), (256, 256, True))


def ratio_bn_flops(arch: dict, batch: int, img_size: int = 32) -> float:
    """RatioEstimatorMNISTSVHN: BatchNorm conv encoders (MNIST 4 convs,
    SVHN 8), fc to feature_dim each, score MLP 2F -> h -> h -> h/2 -> 1."""
    fl, feat, hid = 0.0, arch["feature_dim"], arch["hidden_dim"]
    for spec in (BN_MNIST, BN_SVHN):
        h = img_size
        for cin, cout, pool in spec:
            fl += 2.0 * h * h * 9 * cin * cout
            if pool:
                h //= 2
        fl += 2.0 * spec[-1][1] * feat
    fl += 2.0 * (2 * feat * hid + hid * hid + hid * (hid // 2) + hid // 2)
    return batch * fl


def net_flops(kind: str, arch: dict, batch: int) -> float:
    if kind == "unet":
        return unet_flops(arch, batch)
    if kind == "ratio_gn":
        return ratio_gn_flops(arch, batch, arch["img_size"])
    if kind == "ratio_bn":
        return ratio_bn_flops(arch, batch, arch["img_size"])
    return kinds.load(kind).flops(arch, batch)


def net_gn_sites(kind: str, arch: dict) -> List[Site]:
    if kind == "unet":
        return unet_gn_sites(arch)
    if kind == "ratio_gn":
        return ratio_gn_sites(arch, arch["img_size"])
    if kind == "ratio_bn":
        return []
    sites = getattr(kinds.load(kind), "gn_sites", None)
    return [] if sites is None else sites(arch)


def pair_sampler_flops(flops_x: Callable[[int], float],
                       flops_y: Callable[[int], float], batch: int,
                       mc_batch: int, num_steps: int, d: int,
                       with_phase_a: bool = True) -> float:
    """Euler steps of both velocity nets (phase B at `batch`, phase A at
    `mc_batch`) plus the guidance's two products a step (copy of
    core/flops.py: the terminal ratio scores are not counted here)."""
    fl = num_steps * (flops_x(batch) + flops_y(batch))
    if with_phase_a:
        fl += num_steps * (flops_x(mc_batch) + flops_y(mc_batch))
    fl += num_steps * (2.0 * batch * mc_batch * d) * 2
    return fl


def gn_forward_bytes(sites: List[Site], batch: int, itemsize: int) -> float:
    """x read once and y written once at every site (weight and bias, C
    float32 each, read once)."""
    return sum(2.0 * batch * c * h * h * itemsize + 2.0 * c * 4
               for c, h in sites)


def gn_backward_bytes(sites: List[Site], batch: int, itemsize: int) -> float:
    """x and dy read once, dx written once; the statistics (mean, rstd:
    B × min(8, C) float32 each), weight and bias read once; dγ and dβ (C
    float32 each) written once."""
    return sum(3.0 * batch * c * h * h * itemsize
               + 2.0 * batch * min(8, c) * 4 + 4.0 * c * 4
               for c, h in sites)
