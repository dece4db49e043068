"""Procedural digit datasets (the port's copy of data/synthetic.py: the same
digits for the same seed where the DejaVu fonts are installed; offline
substitute for MNIST/SVHN).

The reference downloads torchvision MNIST/SVHN at import time
(mnist_svhn_dataset.py:41-53). This environment has zero egress, so the
framework ships a deterministic procedural generator: PIL-rendered digits
with font/scale/rotation/shift/contrast jitter. MNIST-like = 28x28
grayscale; SVHN-like = 32x32 RGB with colored background, a centered digit
and edge distractors. Real data is used automatically when present (see
sources.py); everything downstream is source-agnostic.

Generated arrays are cached as .npz under <root>/synthetic_cache/.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_FONT_PATHS = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
]


_FONT_CACHE: dict = {}


def _font(path_idx: int, size: int):
    """DejaVu face `path_idx` at `size` px. Where the DejaVu files are
    missing, Pillow's own scalable face at the same size (Pillow >= 10.1).
    The JAX module falls back to Pillow's 10-px default there, whose digits
    keep ~0.1 pixels above half intensity at 28 px (~58 with DejaVu): on
    them the MNIST classifier reached 0.58 held-out accuracy in 3 epochs
    (PERF.md)."""
    key = (path_idx, size)
    if key not in _FONT_CACHE:
        from PIL import ImageFont

        try:
            _FONT_CACHE[key] = ImageFont.truetype(
                _FONT_PATHS[path_idx % len(_FONT_PATHS)], size)
        except OSError:
            _FONT_CACHE[key] = ImageFont.load_default(size)
    return _FONT_CACHE[key]


def _render_digit_gray(rng: np.random.RandomState, digit: int, out_px: int) -> np.ndarray:
    """One MNIST-like grayscale digit, uint8 [out_px, out_px]."""
    from PIL import Image, ImageDraw

    canvas = 48
    img = Image.new("L", (canvas, canvas), 0)
    draw = ImageDraw.Draw(img)
    size = int(rng.randint(26, 40))
    font = _font(rng.randint(0, len(_FONT_PATHS)), size)
    # center the glyph
    bbox = draw.textbbox((0, 0), str(digit), font=font)
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    dx = (canvas - w) // 2 - bbox[0] + rng.randint(-3, 4)
    dy = (canvas - h) // 2 - bbox[1] + rng.randint(-3, 4)
    fill = int(rng.randint(180, 256))
    draw.text((dx, dy), str(digit), fill=fill, font=font)
    angle = float(rng.uniform(-14, 14))
    img = img.rotate(angle, resample=Image.BILINEAR)
    img = img.resize((out_px, out_px), Image.BILINEAR)
    arr = np.asarray(img, np.float32)
    arr += rng.normal(0, 4.0, arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def _render_digit_rgb(rng: np.random.RandomState, digit: int, out_px: int) -> np.ndarray:
    """One SVHN-like RGB digit, uint8 [out_px, out_px, 3]."""
    from PIL import Image, ImageDraw

    canvas = 48
    bg = tuple(int(v) for v in rng.randint(20, 140, 3))
    img = Image.new("RGB", (canvas, canvas), bg)
    draw = ImageDraw.Draw(img)

    # edge distractor digits (SVHN crops contain neighbors)
    for _ in range(rng.randint(0, 3)):
        d2 = rng.randint(0, 10)
        f2 = _font(rng.randint(0, len(_FONT_PATHS)), int(rng.randint(22, 34)))
        col = tuple(int(v) for v in rng.randint(60, 200, 3))
        side = rng.choice([-1, 1])
        draw.text((canvas // 2 + side * rng.randint(20, 30), rng.randint(0, 16)),
                  str(d2), fill=col, font=f2)

    size = int(rng.randint(26, 40))
    font = _font(rng.randint(0, len(_FONT_PATHS)), size)
    bbox = draw.textbbox((0, 0), str(digit), font=font)
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    dx = (canvas - w) // 2 - bbox[0] + rng.randint(-3, 4)
    dy = (canvas - h) // 2 - bbox[1] + rng.randint(-3, 4)
    # foreground with guaranteed contrast against bg
    fg = tuple(int(min(255, b + rng.randint(70, 150))) for b in bg)
    draw.text((dx, dy), str(digit), fill=fg, font=font)
    angle = float(rng.uniform(-10, 10))
    img = img.rotate(angle, resample=Image.BILINEAR)
    img = img.resize((out_px, out_px), Image.BILINEAR)
    arr = np.asarray(img, np.float32)
    arr += rng.normal(0, 5.0, arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def generate_digits(
    kind: str,           # 'mnist' (28 gray) | 'svhn' (32 rgb)
    n: int,
    seed: int,
    root: str = "./data",
    cache: bool = True,
    px: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images uint8 NHWC, labels int32). Deterministic in
    (kind,n,seed,px). `px` overrides the kind's default resolution (e.g.
    64 for the CIFAR/CelebA-class stretch config)."""
    cache_dir = os.path.join(root, "synthetic_cache")
    suffix = f"_{px}px" if px else ""
    path = os.path.join(cache_dir, f"{kind}_{n}_{seed}{suffix}.npz")
    if cache and os.path.exists(path):
        z = np.load(path)
        return z["images"], z["labels"]

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int32)
    if kind == "mnist":
        imgs = np.stack([_render_digit_gray(rng, int(d), px or 28)
                         for d in labels])
        imgs = imgs[..., None]
    elif kind == "svhn":
        imgs = np.stack([_render_digit_rgb(rng, int(d), px or 32)
                         for d in labels])
    else:
        raise ValueError(kind)

    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, images=imgs, labels=labels)
    return imgs, labels
