"""Fréchet distance on classifier features, "classifier-FID" (port of
eval/fid.py): the eval classifier's `fc1` activations, then
FID = ||mu1-mu2||² + Tr(C1 + C2 - 2(C1 C2)^{1/2}) in float64 with scipy's
sqrtm, as the JAX package computes it. It is not Inception-FID (the port's
`compute_inception_fid` waits for Inception weights in the repository).
"""
from __future__ import annotations

import numpy as np
import torch


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
