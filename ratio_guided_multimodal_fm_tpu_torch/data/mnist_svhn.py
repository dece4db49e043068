"""Experiment-2 data (the part of data/mnist_svhn.py that the evaluation
CLI reads): MNIST resized 28 → 32 and SVHN, both in [-1, 1], as numpy
batches, the same as the JAX package's for the same seed."""
from __future__ import annotations

import numpy as np

from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    _EpochLoader,
)
from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import to_unit_range
from ratio_guided_multimodal_fm_tpu_torch.data.sources import (
    load_mnist,
    load_svhn,
    resize_images,
)

_CACHE = {}


def _mnist32(root, train):
    key = ("mnist32", root, train)
    if key not in _CACHE:
        imgs, labels = load_mnist(root, train)
        _CACHE[key] = (to_unit_range(resize_images(imgs, 32)), labels)
    return _CACHE[key]


def _svhn(root, train):
    key = ("svhn", root, train)
    if key not in _CACHE:
        imgs, labels = load_svhn(root, train)
        _CACHE[key] = (to_unit_range(imgs), labels)
    return _CACHE[key]


def get_svhn_flow_dataloader(batch_size: int = 128, train: bool = True,
                             root: str = "./data", seed: int = 0,
                             **_ignored) -> _EpochLoader:
    """SVHN-only batches {'x','y'(same),'label'} (ref D3 loop-compat)."""
    y, yl = _svhn(root, train)
    n_batches = len(y) // batch_size

    def make_iter(rng):
        order = rng.permutation(len(y)) if train else np.arange(len(y))
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield {"x": y[idx], "y": y[idx], "label": yl[idx]}

    return _EpochLoader(make_iter, n_batches, seed)


def get_mnist32_flow_dataloader(batch_size: int = 128, train: bool = True,
                                root: str = "./data", seed: int = 0,
                                **_ignored) -> _EpochLoader:
    """MNIST-32 batches {'x','label'} (ref D4)."""
    x, xl = _mnist32(root, train)
    n_batches = len(x) // batch_size

    def make_iter(rng):
        order = rng.permutation(len(x)) if train else np.arange(len(x))
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield {"x": x[idx], "label": xl[idx]}

    return _EpochLoader(make_iter, n_batches, seed)
