"""Weights and data made on the device from a seed, in a few large calls.

A net's parameters are one `torch.randn` of the summed size on a
generator of the run's device, cut into the leaves of the published
layout and scaled: kernels by 1/sqrt(fan_in) (LeCun normal), norm scales
1 + 0.1·N, biases and running means 0.1·N, running variances
exp(0.2·N), BatchNorm's step counters 0. The program and the reference
each get a fresh copy from the same seed."""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.nets import layout


def make_params(kind: str, arch: dict, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    lay = layout(kind, arch)
    floats = [(k, s) for k, s in lay if not k.endswith("num_batches_tracked")]
    total = sum(math.prod(s) for _, s in floats)
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=g, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for k, s in floats:
        n = math.prod(s)
        v = flat[off:off + n].view(s)
        off += n
        if len(s) >= 2:
            v.mul_(1.0 / math.sqrt(math.prod(s[1:])))
        elif k.endswith("running_var"):
            v.mul_(0.2).exp_()
        elif k.endswith(".weight"):
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.1)
        out[k] = v.clone()   # a leaf of its own: in-place updates stay apart
    for k, s in lay:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return out


def make_images(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Images uniform in [-1, 1] (the data's range after normalisation)."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    return x.mul_(2.0).sub_(1.0)
