"""The part of data/pipeline.py that the port's loaders use: fixed-shape
(drop-last) epoch orders and flow batches.

A loader's images may be a numpy array (batches stay on the host) or a
tensor on the device (`to_device`): then the whole dataset lives there
as one tensor, each batch is gathered there from the epoch's index order,
and the host moves only the indices. The order is numpy's either way, so
the batches equal the JAX package's for the same seed and epoch.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def to_unit_range(imgs_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [-1,1] (reference Normalize(0.5, 0.5))."""
    return imgs_u8.astype(np.float32) / 127.5 - 1.0


def to_device(arr: np.ndarray, device=None):
    """`arr` itself for device None, else one tensor on `device`."""
    if device is None:
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def gather(data, idx: np.ndarray):
    """data[idx] along the first axis; for a tensor the gather runs on its
    device (only `idx` crosses from the host)."""
    if isinstance(data, torch.Tensor):
        return data.index_select(0, torch.from_numpy(idx).to(
            data.device, non_blocking=True))
    return data[idx]


def _epoch_order(n: int, batch_size: int, shuffle: bool,
                 rng: np.random.RandomState) -> np.ndarray:
    order = rng.permutation(n) if shuffle else np.arange(n)
    n_batches = n // batch_size
    return order[: n_batches * batch_size].reshape(n_batches, batch_size)


def flow_batches(images, labels: np.ndarray, batch_size: int,
                 rng: np.random.RandomState, shuffle: bool = True,
                 ) -> Iterator[Dict[str, object]]:
    """Single-modality flow batches {'x', 'label'} (ref D4 semantics)."""
    for idx in _epoch_order(len(images), batch_size, shuffle, rng):
        yield {"x": gather(images, idx), "label": labels[idx]}
