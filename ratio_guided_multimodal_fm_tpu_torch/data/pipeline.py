"""The part of data/pipeline.py that the port's loaders use: fixed-shape
(drop-last) epoch orders, flow batches, the label pairing and the paired
and ratio (real/fake) batches.

A loader's images may be a numpy array (batches stay on the host) or a
tensor on the device (`to_device`): then the whole dataset lives there
as one tensor, each batch is gathered there from the epoch's index order,
and the host moves only the indices. The order is numpy's either way, so
the batches equal the JAX package's for the same seed and epoch.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

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


def _beside(data, arr: np.ndarray):
    """`arr` as a tensor on `data`'s device where `data` is a tensor (a
    small host-to-device copy), else `arr` itself."""
    if isinstance(data, torch.Tensor):
        return torch.from_numpy(arr).to(data.device, non_blocking=True)
    return arr


class Pairing:
    """Per-label index tables for label-aligned and label-mismatched
    pairing: each epoch draws every pairing in a few vectorised numpy
    calls, in the JAX package's order (so with the same RandomState the
    partners are the JAX package's)."""

    def __init__(self, labels: np.ndarray, num_classes: int = 10):
        self.num_classes = num_classes
        self.by_label = [np.flatnonzero(labels == c)
                         for c in range(num_classes)]
        for c, idxs in enumerate(self.by_label):
            if len(idxs) == 0:
                raise ValueError(f"No samples for class {c}")
        self.labels = labels

    def _draw(self, labels: np.ndarray, rng: np.random.RandomState):
        out = np.empty(len(labels), np.int64)
        for c in range(self.num_classes):
            m = labels == c
            n = int(m.sum())
            if n:
                out[m] = self.by_label[c][rng.randint(
                    0, len(self.by_label[c]), n)]
        return out

    def same_label(self, labels: np.ndarray,
                   rng: np.random.RandomState) -> np.ndarray:
        """For each query label, a random partner index with the SAME
        label."""
        return self._draw(labels, rng)

    def different_label(self, labels: np.ndarray,
                        rng: np.random.RandomState
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """A random partner with a DIFFERENT label: (partner indices,
        partner labels)."""
        shift = rng.randint(1, self.num_classes, len(labels))
        tgt = (labels + shift) % self.num_classes
        return self._draw(tgt, rng), tgt


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


def paired_batches(x_images, x_labels: np.ndarray, y_images,
                   y_pairing: Pairing, batch_size: int,
                   rng: np.random.RandomState, shuffle: bool = True,
                   ) -> Iterator[Dict[str, object]]:
    """Label-aligned cross-modality batches {'x', 'y', 'label'}: each x
    with a random same-label y (ref D1)."""
    for idx in _epoch_order(len(x_images), batch_size, shuffle, rng):
        lbl = x_labels[idx]
        y_idx = y_pairing.same_label(lbl, rng)
        yield {"x": gather(x_images, idx), "y": gather(y_images, y_idx),
               "label": lbl}


def ratio_batches(x_images, x_labels: np.ndarray, y_images,
                  y_pairing: Pairing, batch_size: int,
                  rng: np.random.RandomState, real_fake_ratio: float = 0.5,
                  shuffle: bool = True) -> Iterator[Dict[str, object]]:
    """Real-vs-fake ratio batches {'x', 'y', 'is_real', 'label_x',
    'label_y'}: Bernoulli(real_fake_ratio) real per item, a real pair takes
    a same-label partner, a fake one a different-label partner (ref D2).
    Per batch the draws come in JAX's order: the Bernoulli uniforms, the
    same-label partners, then the different-label shifts and partners.
    With images on a device, 'is_real' is a float32 tensor there too."""
    for idx in _epoch_order(len(x_images), batch_size, shuffle, rng):
        lbl = x_labels[idx]
        is_real = rng.rand(len(idx)) < real_fake_ratio
        y_same = y_pairing.same_label(lbl, rng)
        y_diff, lbl_diff = y_pairing.different_label(lbl, rng)
        yield {
            "x": gather(x_images, idx),
            "y": gather(y_images, np.where(is_real, y_same, y_diff)),
            "is_real": _beside(x_images, is_real.astype(np.float32)),
            "label_x": lbl,
            "label_y": np.where(is_real, lbl, lbl_diff).astype(lbl.dtype),
        }
