"""Analytic FLOP counts of the framework's models (port of core/flops.py).

They turn a measured call time into a FLOP rate, and that into a share of
the card's peak. Counts follow the JAX package's convention: 2 × MACs,
convolutions, transposed convolutions and dense layers only
(normalisations and elementwise ops are bandwidth, not counted).
"""
from __future__ import annotations

from typing import Callable, Tuple


def flexible_unet_flops_per_call(
    batch: int,
    img_size: int,
    in_channels: int,
    model_channels: int,
    channel_mult: Tuple[int, ...],
    num_res_blocks: int = 2,
) -> float:
    """FLOPs of one FlexibleUNet forward (models/unet.py architecture)."""
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


def mnist_unet_flops(batch: int, img_size: int = 32) -> float:
    return flexible_unet_flops_per_call(batch, img_size, 1, 32, (1, 2))


def svhn_unet_flops(batch: int) -> float:
    return flexible_unet_flops_per_call(batch, 32, 3, 64, (1, 2, 2))


def unet64_flops(batch: int, model_channels: int = 96) -> float:
    """FlowMatchingUNet64 (in=3, mult=(1,2,2,4)) at `model_channels`."""
    return flexible_unet_flops_per_call(batch, 64, 3, model_channels,
                                        (1, 2, 2, 4))


def flow_matching_model_flops(batch: int) -> float:
    """FLOPs of one FlowMatchingModel forward (`--model original`,
    models/flow_matching.py: 1x28x28, a 256-d feature, a 128-d time
    embedding): the 4-conv encoder, its fc, the decoder's fc1, two 4x4
    stride-2 transposed convolutions, conv3 and conv_out. A transposed
    convolution does k·k MACs per input pixel and channel pair."""
    B = batch
    fl = 0.0

    def conv(h_out, cin, cout, k=3):
        nonlocal fl
        fl += 2.0 * B * h_out * h_out * k * k * cin * cout

    def dense(cin, cout):
        nonlocal fl
        fl += 2.0 * B * cin * cout

    conv(28, 1, 32)
    conv(14, 32, 64)
    conv(7, 64, 128)
    conv(7, 128, 256)
    dense(256 * 7 * 7, 256)
    dense(256 + 128, 256 * 7 * 7)
    conv(7, 256, 128, k=4)          # deconv1: 7x7 input pixels
    conv(14, 128, 64, k=4)          # deconv2: 14x14 input pixels
    conv(28, 64, 32)
    conv(28, 32, 1)
    return fl


def guided_sampler_flops(
    batch: int,
    mc_batch: int,
    num_steps: int,
    with_phase_a: bool = True,
) -> float:
    """Total FLOPs of the MNIST-SVHN guided sampler: phase A (two
    mc_batch-chain Euler scans) + main loop (both U-Nets per step at
    `batch`). Guidance matmuls contribute [B,D]x[D,N] + [B,N]x[N,D] per
    step at f32 (counted; ~1% of total)."""
    return pair_sampler_flops(mnist_unet_flops, svhn_unet_flops, batch,
                              mc_batch, num_steps, 32 * 32 * 1 + 32 * 32 * 3,
                              with_phase_a)


def pair_sampler_flops(
    flops_x: Callable[[int], float],
    flops_y: Callable[[int], float],
    batch: int,
    mc_batch: int,
    num_steps: int,
    d: int,
    with_phase_a: bool = True,
) -> float:
    """`guided_sampler_flops` for any pair of velocity nets: flops_*(b) is
    one forward at batch b, d the summed feature width of a pair. Euler
    steps; the terminal ratio scores are not counted."""
    fl = num_steps * (flops_x(batch) + flops_y(batch))
    if with_phase_a:
        fl += num_steps * (flops_x(mc_batch) + flops_y(mc_batch))
    fl += num_steps * (2.0 * batch * mc_batch * d) * 2   # cross + weighted
    return fl
