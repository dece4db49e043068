"""Experiment-2 data (port of data/mnist_svhn.py's loaders): MNIST
resized 28 → 32 and SVHN, both in [-1, 1]; label-aligned pairs with a
fresh same-label SVHN partner per epoch (D1), ratio batches with
Bernoulli real/fake and different-label fakes (D2), and the SVHN-only and
MNIST-32-only flow loaders (D3/D4), in the JAX package's batch order and
pairings for the same seed; numpy batches, or
with a `device` batches gathered there from the dataset held there as one
tensor (data/pipeline.py); the fused K-step trainer's index loader of the
ratio pairs and the whole modalities on the device (`mnist32_dataset`,
`svhn_dataset`)."""
from __future__ import annotations

from ratio_guided_multimodal_fm_tpu_torch.data.mnist_dataset import (
    _EpochLoader,
    ratio_index_chunks,
)
from ratio_guided_multimodal_fm_tpu_torch.data.pipeline import (
    Pairing,
    flow_batches,
    paired_batches,
    ratio_batches,
    to_device,
    to_unit_range,
)
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


def get_mnist_svhn_dataloader(batch_size: int = 128, train: bool = True,
                              root: str = "./data", seed: int = 0,
                              device=None, **_ignored) -> _EpochLoader:
    """Batches {'x': [B,32,32,1], 'y': [B,32,32,3], 'label': [B]}: each
    MNIST-32 image with a same-label SVHN image."""
    x, xl = _mnist32(root, train)
    y, yl = _svhn(root, train)
    xd, yd = to_device(x, device), to_device(y, device)
    pairing = Pairing(yl)

    def make_iter(rng):
        return paired_batches(xd, xl, yd, pairing, batch_size, rng,
                              shuffle=train)

    return _EpochLoader(make_iter, len(x) // batch_size, seed)


def get_mnist_svhn_ratio_dataloader(batch_size: int = 128,
                                    real_fake_ratio: float = 0.5,
                                    train: bool = True, root: str = "./data",
                                    seed: int = 0, device=None,
                                    **_ignored) -> _EpochLoader:
    """Ratio batches {'x', 'y', 'is_real', 'label_x', 'label_y'} of
    MNIST-32 / SVHN pairs (pipeline.ratio_batches)."""
    x, xl = _mnist32(root, train)
    y, yl = _svhn(root, train)
    xd, yd = to_device(x, device), to_device(y, device)
    pairing = Pairing(yl)

    def make_iter(rng):
        return ratio_batches(xd, xl, yd, pairing, batch_size, rng,
                             real_fake_ratio=real_fake_ratio, shuffle=train)

    return _EpochLoader(make_iter, len(x) // batch_size, seed)


def get_svhn_flow_dataloader(batch_size: int = 128, train: bool = True,
                             root: str = "./data", seed: int = 0,
                             device=None, **_ignored) -> _EpochLoader:
    """SVHN-only batches {'x','y'(same),'label'} (ref D3 loop-compat)."""
    y, yl = _svhn(root, train)
    yd = to_device(y, device)
    n_batches = len(y) // batch_size

    def make_iter(rng):
        for batch in flow_batches(yd, yl, batch_size, rng, shuffle=train):
            yield {**batch, "y": batch["x"]}

    return _EpochLoader(make_iter, n_batches, seed)


def get_mnist32_flow_dataloader(batch_size: int = 128, train: bool = True,
                                root: str = "./data", seed: int = 0,
                                device=None, **_ignored) -> _EpochLoader:
    """MNIST-32 batches {'x','label'} (ref D4)."""
    x, xl = _mnist32(root, train)
    xd = to_device(x, device)
    n_batches = len(x) // batch_size

    def make_iter(rng):
        return flow_batches(xd, xl, batch_size, rng, shuffle=train)

    return _EpochLoader(make_iter, n_batches, seed)


def mnist32_dataset(train: bool = True, root: str = "./data", device=None):
    """The whole MNIST-32 modality [N, 32, 32, 1] (on `device`)."""
    return to_device(_mnist32(root, train)[0], device)


def svhn_dataset(train: bool = True, root: str = "./data", device=None):
    """The whole SVHN modality [N, 32, 32, 3] (on `device`)."""
    return to_device(_svhn(root, train)[0], device)


def get_mnist_svhn_ratio_index_loader(batch_size: int = 128,
                                      fused_steps: int = 1,
                                      real_fake_ratio: float = 0.5,
                                      train: bool = True,
                                      root: str = "./data", seed: int = 0,
                                      device=None):
    """Fused-trainer twin of `get_mnist_svhn_ratio_dataloader`: (x_all,
    y_all, loader) with MNIST-32 and SVHN whole (on `device` when given)
    and the index chunks of their ratio pairs (the partners drawn among
    the SVHN labels), equal to the JAX loader's for the same seed."""
    x, xl = _mnist32(root, train)
    y, yl = _svhn(root, train)
    return (to_device(x, device), to_device(y, device),
            ratio_index_chunks(xl, Pairing(yl), batch_size, fused_steps,
                               real_fake_ratio, train, seed))
