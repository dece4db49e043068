"""Evaluation classifiers (port of models/classifiers.py), for the coherence
metric P(label(x) == label(y)) and the classifier-feature FID.

* `MNISTClassifier`   — 2-conv CNN for 1x28x28 (421,642 params)
* `MNISTClassifier32` — 3-conv CNN for 1x32x32 (581,450 params)
* `SVHNClassifier`    — 4-conv BatchNorm CNN for 3x32x32 (2,341,514 params;
  BatchNorm with flax's semantics, eps 1e-5: models/ratio.py:BatchNorm2d)
* `Classifier64`      — 3-conv CNN for RGB 64x64, the evaluation classifier
  of the 64-px stretch config (cli/config5_demo.py)

The layers are the reference torch modules (state-dict keys of the JAX
exporter's `export_*_classifier`); the activations flatten in NCHW order
before `fc1`, as the reference does. `forward` takes NHWC images in
[-1, 1], like the JAX modules, and returns logits [B, 10]; `features`
returns the `fc1` activations (the classifier-FID features). In train
mode dropout (0.25 for the MNIST classifiers, 0.3 for SVHN, as in JAX)
follows fc1's ReLU; it adds no state-dict key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ratio_guided_multimodal_fm_tpu_torch.models.layers import flax_init_
from ratio_guided_multimodal_fm_tpu_torch.models.ratio import BatchNorm2d


class _ConvClassifier(nn.Module):
    """conv3x3 → (BN) → ReLU blocks, max-pooled where `pool_after`, flatten
    (C, H, W), fc1 → ReLU → dropout → fc2. `spec` lists (in, out,
    pool_after)."""

    def __init__(self, spec, flat: int, hidden: int, batch_norm: bool,
                 dropout: float):
        super().__init__()
        self.pools = [pool for _, _, pool in spec]
        for i, (cin, cout, _) in enumerate(spec, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))
            if batch_norm:
                self.add_module(f"bn{i}", BatchNorm2d(cout))
        self.batch_norm = batch_norm
        self.fc1 = nn.Linear(flat, hidden)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(hidden, 10)
        flax_init_(self)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """fc1 activations (after ReLU) [B, hidden] of NHWC images."""
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for i, pool in enumerate(self.pools, start=1):
            h = getattr(self, f"conv{i}")(h)
            if self.batch_norm:
                h = getattr(self, f"bn{i}")(h)
            h = F.relu(h)
            if pool:
                h = F.max_pool2d(h, 2)
        return F.relu(self.fc1(h.flatten(1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits [B, 10] of NHWC images."""
        return self.fc2(self.dropout(self.features(x)))


def MNISTClassifier() -> _ConvClassifier:
    """2-conv CNN for 1x28x28 (ref classifier.py:9-52)."""
    return _ConvClassifier([(1, 32, True), (32, 64, True)], 64 * 7 * 7, 128,
                           batch_norm=False, dropout=0.25)


def MNISTClassifier32() -> _ConvClassifier:
    """3-conv CNN for 1x32x32 (ref svhn_classifier.py:74-116)."""
    return _ConvClassifier([(1, 32, True), (32, 64, True), (64, 64, False)],
                           64 * 8 * 8, 128, batch_norm=False, dropout=0.25)


def SVHNClassifier() -> _ConvClassifier:
    """4-conv BatchNorm CNN for 3x32x32, two max-pools 32 -> 8
    (ref svhn_classifier.py:11-71)."""
    return _ConvClassifier([(3, 32, True), (32, 64, True), (64, 128, False),
                            (128, 128, False)], 128 * 8 * 8, 256,
                           batch_norm=True, dropout=0.3)


def Classifier64() -> _ConvClassifier:
    """3-conv CNN for RGB 64x64, three max-pools 64 -> 8 (JAX
    classifiers.py:73-91; no reference equivalent)."""
    return _ConvClassifier([(3, 32, True), (32, 64, True), (64, 64, True)],
                           64 * 8 * 8, 128, batch_norm=False, dropout=0.25)
