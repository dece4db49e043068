"""Fréchet distance on classifier features, "classifier-FID" (port of
eval/fid.py): the eval classifier's `fc1` activations, then
FID = ||mu1-mu2||² + Tr(C1 + C2 - 2(C1 C2)^{1/2}) in float64 with scipy's
sqrtm, as the JAX package computes it. It is not Inception-FID:
`compute_inception_fid` gives that from an Inception network file the
user supplies (none ships with the repository, and none is fetched).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device


def extract_features(model, images) -> np.ndarray:
    """`fc1` activations [B, F] (float32 numpy) of NHWC images (numpy or a
    tensor) from a models/classifiers.py classifier, on its device."""
    device = next(model.parameters()).device
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(device, torch.float32)
        return model.features(x).float().cpu().numpy()


def fid_from_features(f1: np.ndarray, f2: np.ndarray,
                      eps: float = 1e-6) -> float:
    from scipy import linalg

    f1 = np.asarray(f1, np.float64)
    f2 = np.asarray(f2, np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    c1 = np.cov(f1, rowvar=False)
    c2 = np.cov(f2, rowvar=False)
    diff = mu1 - mu2
    # sqrtm's `disp` (JAX package: disp=False) is gone from newer scipy
    covmean = linalg.sqrtm(c1 @ c2)
    if not np.isfinite(covmean).all():
        offset = np.eye(c1.shape[0]) * eps
        covmean = linalg.sqrtm((c1 + offset) @ (c2 + offset))
    covmean = covmean.real
    return float(diff @ diff + np.trace(c1) + np.trace(c2)
                 - 2 * np.trace(covmean))


def compute_fid(model, real_images, gen_images,
                batch_size: int = 256) -> float:
    """Classifier-FID between real and generated image sets (NHWC, [-1,1]),
    features taken in batches of `batch_size` (the last one partial)."""
    def feats(imgs):
        return np.concatenate([extract_features(model,
                                                 imgs[i:i + batch_size])
                               for i in range(0, len(imgs), batch_size)])

    return fid_from_features(feats(real_images), feats(gen_images))


def _inception(weights_path: str, device: torch.device) -> torch.nn.Module:
    """A TorchScript module, else a torchvision inception_v3 state dict
    (its pool3 features: `fc` replaced by the identity), on `device`."""
    try:
        return torch.jit.load(weights_path, map_location=device)
    except (RuntimeError, ValueError):          # not a TorchScript file
        from torchvision.models import inception_v3   # may ImportError

        net = inception_v3(weights=None, aux_logits=True, init_weights=False)
        net.load_state_dict(torch.load(weights_path, map_location="cpu"))
        net.fc = torch.nn.Identity()
        return net.to(device)


def compute_inception_fid(real_images, gen_images, weights_path: str,
                          batch_size: int = 64, device=None) -> float:
    """Inception-FID from a user-supplied Inception network file (JAX
    eval/fid.py:compute_inception_fid): a TorchScript module (e.g. the
    clean-fid or pytorch-fid scripted Inception) or a torchvision
    inception_v3 state dict (needs torchvision). It runs on `device` (the
    card unless asked for the CPU). Images: NHWC in [-1, 1] (numpy or
    tensors), grayscale tiled to RGB, resized bilinearly to 299×299 in
    batches of `batch_size`; the features' Fréchet distance as
    `fid_from_features`. Raises FileNotFoundError without the file: it
    never substitutes another network."""
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"Inception weights not found: {weights_path} (provide a "
            "TorchScript Inception or a torchvision inception_v3 .pth; "
            "none is downloaded)")
    dev = resolve_device(device)
    net = _inception(weights_path, dev).eval()

    @torch.no_grad()
    def feats(imgs):
        imgs = torch.as_tensor(imgs).to(dev, torch.float32)
        out = []
        for i in range(0, len(imgs), batch_size):
            b = imgs[i:i + batch_size]
            if b.shape[-1] == 1:
                b = b.repeat(1, 1, 1, 3)
            t = F.interpolate(b.permute(0, 3, 1, 2), size=(299, 299),
                              mode="bilinear", align_corners=False)
            f = net(t)
            if not torch.is_tensor(f):      # torchvision InceptionOutputs
                f = f[0] if isinstance(f, (tuple, list)) else f.logits
            out.append(f.reshape(len(b), -1).float().cpu().numpy())
        return np.concatenate(out)

    return fid_from_features(feats(real_images), feats(gen_images))
