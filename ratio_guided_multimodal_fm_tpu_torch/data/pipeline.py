"""The part of data/pipeline.py that the port's loaders use."""
from __future__ import annotations

import numpy as np


def to_unit_range(imgs_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [-1,1] (reference Normalize(0.5, 0.5))."""
    return imgs_u8.astype(np.float32) / 127.5 - 1.0
