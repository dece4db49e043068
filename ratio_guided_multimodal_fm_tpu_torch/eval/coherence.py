"""Coherence metric P(label(x) == label(y)) (port of eval/coherence.py).

Parity with ref evaluate.py:56-90 (one classifier, y inverse-transformed
first) and evaluate_mnist_svhn.py:28-57 (two classifiers). Samples are NHWC
torch tensors or numpy arrays; `classify_*` map them to logits [B, 10].
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.data.transforms import (
    inverse_transform,
)


def _predict(classify_fn: Callable, samples) -> np.ndarray:
    logits = classify_fn(samples)
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    return np.asarray(logits).argmax(-1)


def label_entropy(preds, num_classes: int = 10) -> float:
    """Shannon entropy (nats) of the empirical predicted-label distribution:
    ln(10) ≈ 2.303 for a uniform class mix, → 0 under mode collapse."""
    counts = np.bincount(np.asarray(preds), minlength=num_classes)
    p = counts / max(counts.sum(), 1)
    nz = p[p > 0]
    return float(max(0.0, -(nz * np.log(nz)).sum()))


def _metrics(pred_x: np.ndarray, pred_y: np.ndarray) -> Dict:
    return {
        "coherence_acc": float((pred_x == pred_y).mean()),
        "num_samples": int(len(pred_x)),
        "label_entropy_x": label_entropy(pred_x),
        "label_entropy_y": label_entropy(pred_y),
        "pred_x": pred_x,
        "pred_y": pred_y,
    }


def evaluate_coherence(samples_x, samples_y, classify_fn: Callable,
                       transform_type: str = "rotate90") -> Dict:
    """Single-classifier coherence; y is inverse-transformed first so the
    classifier sees both modalities in the same orientation
    (ref evaluate.py:74-76)."""
    y_inv = inverse_transform(transform_type, samples_y)
    return _metrics(_predict(classify_fn, samples_x),
                    _predict(classify_fn, y_inv))


def evaluate_coherence_dual(samples_x, samples_y, classify_x: Callable,
                            classify_y: Callable) -> Dict:
    """Dual-classifier coherence for cross-modality pairs
    (ref evaluate_mnist_svhn.py:28-57)."""
    return _metrics(_predict(classify_x, samples_x),
                    _predict(classify_y, samples_y))
