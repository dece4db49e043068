"""Seeds derived from the run's `--seed` and a position: a pure function,
so the same seed gives the same weights, data and draws."""
from __future__ import annotations

import zlib

import numpy as np


def _word(tag) -> int:
    if isinstance(tag, str):
        return zlib.crc32(tag.encode())
    return int(tag) % (1 << 64)


def derive(seed: int, *path) -> int:
    """A 63-bit seed from `seed` (any integer) and a path of ints and
    strings."""
    words = [_word(seed)] + [_word(p) for p in path]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def draw_steps(seed: int, tag: str, n: int, count: int, last: bool = True):
    """`count` distinct indices in [0, n) drawn from the seed, sorted, with
    n - 1 among them when `last`."""
    rng = np.random.default_rng(derive(seed, tag))
    pool = n - 1 if last else n
    k = min(count - int(last), pool)
    picked = set(int(i) for i in rng.choice(pool, size=k, replace=False))
    if last:
        picked.add(n - 1)
    return sorted(picked)
