"""Dataset sources (the port's copy of data/sources.py): real MNIST (IDX) /
SVHN (.mat) when present, synthetic procedural digits otherwise.

The reference relies on torchvision downloads (mnist_svhn_dataset.py:41-53).
Here:
* MNIST: reads the standard IDX files if found under <root>/MNIST/raw/ or
  <root>/ (names train-images-idx3-ubyte[.gz] etc.).
* SVHN: reads train_32x32.mat / test_32x32.mat via scipy.io if found under
  <root>/ or <root>/svhn/.
* Otherwise: deterministic synthetic digits (synthetic.py), sized by the
  RGMF_SYNTH_N env var (default 20000 train / 4000 test) so the full
  pipeline runs offline.

All loaders return (images uint8 NHWC, labels int32 in 0..9).
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from ratio_guided_multimodal_fm_tpu_torch.data.synthetic import (
    generate_digits,
)


def _synth_sizes():
    n_train = int(os.environ.get("RGMF_SYNTH_N", 20000))
    n_test = max(1000, n_train // 5)
    return n_train, n_test


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def _find(root: str, names) -> Optional[str]:
    for sub in ("", "MNIST/raw", "mnist", "svhn", "SVHN"):
        for name in names:
            for ext in ("", ".gz"):
                p = os.path.join(root, sub, name + ext)
                if os.path.exists(p):
                    return p
    return None


def load_mnist(root: str = "./data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST 28x28 grayscale → (images uint8 [N,28,28,1], labels int32)."""
    prefix = "train" if train else "t10k"
    img_p = _find(root, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
    lbl_p = _find(root, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
    if img_p and lbl_p:
        imgs = _read_idx(img_p)[..., None]
        labels = _read_idx(lbl_p).astype(np.int32)
        return imgs, labels
    n_train, n_test = _synth_sizes()
    return generate_digits("mnist", n_train if train else n_test,
                           seed=0 if train else 1, root=root)


def load_svhn(root: str = "./data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """SVHN 32x32 RGB → (images uint8 [N,32,32,3], labels int32, 0..9)."""
    name = "train_32x32.mat" if train else "test_32x32.mat"
    p = _find(root, [name])
    if p:
        from scipy.io import loadmat

        m = loadmat(p)
        imgs = np.transpose(m["X"], (3, 0, 1, 2))  # HWCN → NHWC
        labels = m["y"].squeeze().astype(np.int32)
        labels[labels == 10] = 0  # SVHN convention
        return np.ascontiguousarray(imgs), labels
    n_train, n_test = _synth_sizes()
    return generate_digits("svhn", n_train if train else n_test,
                           seed=2 if train else 3, root=root)


def resize_images(imgs: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize uint8 NHWC via PIL (host-side, one-time prep)."""
    from PIL import Image

    if imgs.shape[1] == size:
        return imgs
    out = np.empty((imgs.shape[0], size, size, imgs.shape[3]), np.uint8)
    for i in range(imgs.shape[0]):
        a = imgs[i].squeeze(-1) if imgs.shape[3] == 1 else imgs[i]
        im = Image.fromarray(a).resize((size, size), Image.BILINEAR)
        r = np.asarray(im, np.uint8)
        out[i] = r[..., None] if imgs.shape[3] == 1 else r
    return out
