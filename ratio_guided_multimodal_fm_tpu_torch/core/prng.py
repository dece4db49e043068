"""Seeding (port of core/prng.py).

JAX threads explicit keys; torch draws from `torch.Generator`s. The port
keeps JAX's discipline of position-addressed randomness: every random
draw of a training step comes from a generator seeded by
`derive_seed(seed, epoch, step)`, a pure function of the position, so a
process that resumes at (epoch, step) draws what the uninterrupted run
drew there (JAX: fold_in(fold_in(root, epoch), step), train/loop.py).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from `seed` and a position `path` (e.g. epoch
    and step). numpy's SeedSequence keeps the streams of two positions
    apart."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def set_seed(seed: int = 42) -> int:
    """Seed the host RNGs (python, numpy) and torch's default generators,
    as the reference's set_seed does; returns `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class RNG:
    """Position-addressed generators for the epoch driver: `generator(
    epoch, step)` is a fresh `torch.Generator` on `device` seeded by
    `derive_seed(seed, epoch, step)`; nothing is consumed in between, so
    the same position always gives the same stream."""

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def generator(self, *path: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            derive_seed(self.seed, *path))
