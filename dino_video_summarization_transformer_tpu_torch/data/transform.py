"""The two frame transforms the scoring dataset uses, copied from the JAX
package's ``data/transform.py``."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def tensor_normalize(frames: np.ndarray, mean, std) -> np.ndarray:
    """uint8 -> float/255, subtract mean, divide std
    (ref: datasets_custom/data_utils.py:308-325). frames (..., C)
    channels-last like the reference call sites (T, H, W, C)."""
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (frames - mean) / std


def uniform_crop(
    images: np.ndarray, size: int, spatial_idx: int
) -> Tuple[np.ndarray, None]:
    """Left/center/right (or top/center/bottom) crop with ceil-centering
    (ref: datasets_custom/transform.py:206-250). images (T, C, H, W)."""
    assert spatial_idx in (0, 1, 2)
    height, width = images.shape[2], images.shape[3]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = height - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = width - size
    cropped = images[:, :, y_offset:y_offset + size, x_offset:x_offset + size]
    return cropped, None
