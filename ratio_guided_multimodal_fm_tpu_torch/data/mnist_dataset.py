"""Experiment-1 data (port of the parts of data/mnist_dataset.py that the
training, sampling and evaluation CLIs read): the epoch loader, the flow
batches of MNIST-28 and of its transformed twin, the ratio (real/fake
pair) batches and the classifier batches, and the fused K-step trainer's
index loaders (int32 [K, B] chunks; the dataset goes to the device once
and the K batches are gathered there, train/steps.py). The batch order is
numpy's, the same as the JAX package's for the same seed; with a
`device`, the dataset lives there as one tensor and the batches are
gathered there (data/pipeline.py)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
    Pairing,
    _epoch_order,
    gather,
    ratio_batches,
    to_device,
    to_unit_range,
)
from ratio_guided_multimodal_fm_tpu_torch.data.sources import load_mnist
from ratio_guided_multimodal_fm_tpu_torch.data.transforms import (
    apply_transform,
)


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
        (seed, e), whatever this process iterated before (the preemption
        resume contract, train/loop.py)."""
        return self._make_iter(np.random.RandomState(self._seed + e))

    def __iter__(self):
        it = self.epoch(self._epoch)
        self._epoch += 1
        return it


def _modalities(transform_type: Optional[str], train: bool, root: str):
    imgs_u8, labels = load_mnist(root, train)
    x = to_unit_range(imgs_u8)
    y = (np.ascontiguousarray(apply_transform(transform_type, x))
         if transform_type else x)
    return x, y, labels


def get_flow_dataloader(transform_type: Optional[str] = None,
                        batch_size: int = 128, train: bool = True,
                        root: str = "./data", seed: int = 0,
                        device=None) -> _EpochLoader:
    """Batches {'x': [B,28,28,1], 'y': T(x) (x without a transform),
    'label'} in [-1, 1]; on `device` when given."""
    x, y, labels = _modalities(transform_type, train, root)
    xd = to_device(x, device)
    yd = xd if y is x else to_device(y, device)
    n_batches = len(x) // batch_size

    def make_iter(rng):
        for idx in _epoch_order(len(x), batch_size, train, rng):
            bx = gather(xd, idx)
            yield {"x": bx, "y": bx if yd is xd else gather(yd, idx),
                   "label": labels[idx]}

    return _EpochLoader(make_iter, n_batches, seed)


def get_flow_dataset(transform_type: Optional[str] = None,
                     train: bool = True, root: str = "./data", device=None):
    """The whole modality ([N,28,28,1] in [-1, 1], transformed where
    `transform_type` says), on `device` when given."""
    _, y, _ = _modalities(transform_type, train, root)
    return to_device(y, device)


def get_index_chunk_loader(n: int, batch_size: int, fused_steps: int,
                           train: bool = True, seed: int = 0) -> _EpochLoader:
    """Epoch loader of int32 [K, B] index chunks for the fused trainer
    (train/steps.py:make_fm_train_multistep), equal to the JAX loader's
    for the same seed: epoch e permutes with RandomState(seed + e), and the
    trailing batches that do not fill a K-chunk are dropped (with K = 1 the
    chunks are the plain loader's batches)."""
    k, b = int(fused_steps), int(batch_size)
    n_chunks = n // (k * b)

    def make_iter(rng):
        order = rng.permutation(n) if train else np.arange(n)
        for c in range(n_chunks):
            idx = order[c * k * b:(c + 1) * k * b]
            yield np.ascontiguousarray(idx.reshape(k, b).astype(np.int32))

    return _EpochLoader(make_iter, n_chunks, seed)


def ratio_index_chunks(labels: np.ndarray, pairing: Pairing, batch_size: int,
                       fused_steps: int, real_fake_ratio: float, train: bool,
                       seed: int) -> _EpochLoader:
    """Epoch loader of {'xidx', 'yidx': int32 [K, B], 'is_real': float32
    [K, B]} chunks: per chunk the K·B x rows of the epoch's order, the
    Bernoulli real/fake draws, then the same-label and the different-label
    partners (the JAX index loaders' draws, in their order)."""
    k, b = int(fused_steps), int(batch_size)
    n = len(labels)
    n_chunks = n // (k * b)

    def make_iter(rng):
        order = rng.permutation(n) if train else np.arange(n)
        for c in range(n_chunks):
            idx = order[c * k * b:(c + 1) * k * b]
            lbl = labels[idx]
            is_real = rng.rand(k * b) < real_fake_ratio
            y_same = pairing.same_label(lbl, rng)
            y_diff, _ = pairing.different_label(lbl, rng)
            y_idx = np.where(is_real, y_same, y_diff)
            yield {
                "xidx": np.ascontiguousarray(
                    idx.reshape(k, b).astype(np.int32)),
                "yidx": np.ascontiguousarray(
                    y_idx.reshape(k, b).astype(np.int32)),
                "is_real": is_real.reshape(k, b).astype(np.float32),
            }

    return _EpochLoader(make_iter, n_chunks, seed)


def get_ratio_index_loader(transform_type: str = "rotate90",
                           batch_size: int = 128, fused_steps: int = 1,
                           real_fake_ratio: float = 0.5, train: bool = True,
                           root: str = "./data", seed: int = 0, device=None):
    """Fused-trainer twin of `get_ratio_dataloader` (train/steps.py:
    make_ratio_train_multistep): (x_all, y_all, loader), the two whole
    modalities (on `device` when given) and the loader of index chunks
    (`ratio_index_chunks`), equal to the JAX loader's for the same seed."""
    imgs_u8, labels = load_mnist(root, train)
    x = to_unit_range(imgs_u8)
    y_all = to_device(np.ascontiguousarray(apply_transform(transform_type,
                                                           x)), device)
    return (to_device(x, device), y_all,
            ratio_index_chunks(labels, Pairing(labels), batch_size,
                               fused_steps, real_fake_ratio, train, seed))


def get_ratio_dataloader(transform_type: str = "rotate90",
                         batch_size: int = 128, real_fake_ratio: float = 0.5,
                         train: bool = True, root: str = "./data",
                         seed: int = 0, device=None) -> _EpochLoader:
    """Ratio batches {'x', 'y', 'is_real', 'label_x', 'label_y'}: x an
    MNIST-28 image, y = T(a same-label image) for a real pair and T(a
    different-label image) for a fake one (JAX get_ratio_dataloader; per
    batch the draws are rand, same_label, different_label, as
    pipeline.ratio_batches draws them). With `device`, both modalities live
    there and the batches are gathered there."""
    imgs_u8, labels = load_mnist(root, train)
    x = to_unit_range(imgs_u8)
    y_all = to_device(np.ascontiguousarray(apply_transform(transform_type,
                                                           x)), device)
    x = to_device(x, device)
    pairing = Pairing(labels)

    def make_iter(rng):
        return ratio_batches(x, labels, y_all, pairing, batch_size, rng,
                             real_fake_ratio=real_fake_ratio, shuffle=train)

    return _EpochLoader(make_iter, len(labels) // batch_size, seed)


def get_classifier_dataloader(batch_size: int = 128, train: bool = True,
                              root: str = "./data", seed: int = 0,
                              device=None) -> _EpochLoader:
    """Plain {'x', 'label'} batches for the MNIST-28 eval classifier; with
    `device`, the images live there and the batches are gathered there."""
    imgs_u8, labels = load_mnist(root, train)
    x = to_device(to_unit_range(imgs_u8), device)

    def make_iter(rng):
        for idx in _epoch_order(len(labels), batch_size, train, rng):
            yield {"x": gather(x, idx), "label": labels[idx]}

    return _EpochLoader(make_iter, len(labels) // batch_size, seed)
