"""Experiment-1 data (the part of data/mnist_dataset.py that the evaluation
CLIs read): the epoch loader and the MNIST-28 classifier batches. numpy
batches, the same as the JAX package's for the same seed (the JAX loaders
may also keep the arrays on the device; here they stay on the host)."""
from __future__ import annotations

import numpy as np

from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import to_unit_range
from ratio_guided_multimodal_fm_tpu_torch.data.sources import load_mnist


class _EpochLoader:
    """Iterable over epochs of fixed-shape dict batches (drop-last)."""

    def __init__(self, make_iter, n_batches: int, seed: int = 0):
        self._make_iter = make_iter
        self._n = n_batches
        self._epoch = 0
        self._seed = seed

    def __len__(self):
        return self._n

    def epoch(self, e: int):
        """Iterator for epoch `e`: the batch order is a pure function of
        (seed, e)."""
        return self._make_iter(np.random.RandomState(self._seed + e))

    def __iter__(self):
        it = self.epoch(self._epoch)
        self._epoch += 1
        return it


def get_classifier_dataloader(batch_size: int = 128, train: bool = True,
                              root: str = "./data",
                              seed: int = 0) -> _EpochLoader:
    """Plain (image, label) batches for the MNIST-28 eval classifier."""
    imgs_u8, labels = load_mnist(root, train)
    x = to_unit_range(imgs_u8)
    n_batches = len(x) // batch_size

    def make_iter(rng):
        order = rng.permutation(len(x)) if train else np.arange(len(x))
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield {"x": x[idx], "label": labels[idx]}

    return _EpochLoader(make_iter, n_batches, seed)
