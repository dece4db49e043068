"""Modality transforms of experiment 1 (the port's copy of
data/transforms.py), on NHWC images in [-1, 1]: numpy arrays stay numpy,
torch tensors stay torch.

inverse(rotate90) = +90° counter-clockwise, so forward rotate90 = 90°
clockwise, as in the JAX package and the reference's evaluate.py:30-53.
"""
from __future__ import annotations

import numpy as np
import torch

TRANSFORM_NAMES = ("rotate90", "rotate180", "rotate270", "invert",
                   "flip_h", "flip_v", "none")


def _rot90(imgs, k, axes):
    if isinstance(imgs, np.ndarray):
        return np.rot90(imgs, k=k, axes=axes)
    return torch.rot90(imgs, k, dims=axes)


def _flip(imgs, axis):
    if isinstance(imgs, np.ndarray):
        return np.flip(imgs, axis=axis)
    return torch.flip(imgs, dims=(axis,))


def apply_transform(name, imgs):
    """Forward transform y = T(x). imgs: [..., H, W, C]."""
    h_ax, w_ax = imgs.ndim - 3, imgs.ndim - 2
    if name == "rotate90":      # 90° clockwise
        return _rot90(imgs, -1, (h_ax, w_ax))
    if name == "rotate180":
        return _rot90(imgs, 2, (h_ax, w_ax))
    if name == "rotate270":     # 270° clockwise = 90° counter-clockwise
        return _rot90(imgs, 1, (h_ax, w_ax))
    if name == "invert":        # [-1, 1] negate (ref evaluate.py:47)
        return -imgs
    if name == "flip_h":
        return _flip(imgs, w_ax)
    if name == "flip_v":
        return _flip(imgs, h_ax)
    return imgs                 # 'none'/unknown -> identity (ref :53)


def inverse_transform(name, imgs):
    """Inverse map used before classifying y (ref evaluate.py:30-53)."""
    inverse_of = {
        "rotate90": "rotate270",
        "rotate270": "rotate90",
        "rotate180": "rotate180",
        "invert": "invert",
        "flip_h": "flip_h",
        "flip_v": "flip_v",
    }
    return apply_transform(inverse_of.get(name, "none"), imgs)
