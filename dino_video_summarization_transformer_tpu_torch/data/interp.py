"""Torch-parity resize kernels in numpy: a copy of the JAX package's
``data/interp.py`` (nearest, bilinear and bicubic with ``align_corners=False``
as ``torch.nn.functional.interpolate`` computes them), used by the DINO
multi-crop augmentation."""

from __future__ import annotations

import numpy as np


def _source_coords(out_len: int, in_len: int) -> np.ndarray:
    """Pixel-center mapping for align_corners=False."""
    scale = in_len / out_len
    return (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch 'nearest': src = floor(dst * in/out)."""
    in_h, in_w = img.shape[-2:]
    ys = np.floor(np.arange(out_h) * (in_h / out_h)).astype(np.int64)
    xs = np.floor(np.arange(out_w) * (in_w / out_w)).astype(np.int64)
    return img[..., ys[:, None], xs[None, :]]


def _linear_weights(out_len: int, in_len: int):
    src = _source_coords(out_len, in_len)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i0c = np.clip(i0, 0, in_len - 1)
    i1c = np.clip(i0 + 1, 0, in_len - 1)
    return i0c, i1c, frac.astype(np.float64)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(..., H, W) -> (..., out_h, out_w), float64 accumulation."""
    in_h, in_w = img.shape[-2:]
    y0, y1, fy = _linear_weights(out_h, in_h)
    x0, x1, fx = _linear_weights(out_w, in_w)
    imgf = img.astype(np.float64)
    top = imgf[..., y0, :] * (1 - fy)[:, None] + imgf[..., y1, :] * fy[:, None]
    out = top[..., :, x0] * (1 - fx) + top[..., :, x1] * fx
    return out.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def _cubic_weights(out_len: int, in_len: int):
    src = _source_coords(out_len, in_len)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    idx = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=1)  # (out, 4)
    offs = np.stack([frac + 1, frac, 1 - frac, 2 - frac], axis=1)
    w = _cubic_kernel(np.stack([-(frac + 1), -frac, 1 - frac, 2 - frac], axis=1))
    del offs
    idx = np.clip(idx, 0, in_len - 1)
    return idx, w


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(..., H, W) -> (..., out_h, out_w); matches torch bicubic
    (a=-0.75, align_corners=False, clamped border replication)."""
    in_h, in_w = img.shape[-2:]
    yi, yw = _cubic_weights(out_h, in_h)  # (out_h, 4)
    xi, xw = _cubic_weights(out_w, in_w)  # (out_w, 4)
    imgf = img.astype(np.float64)
    # rows: (..., out_h, 4, W) -> weighted sum over the 4 taps
    rows = imgf[..., yi, :] * yw[..., :, :, None]
    rows = rows.sum(axis=-2)  # (..., out_h, W)
    cols = rows[..., :, xi] * xw  # (..., out_h, out_w, 4)
    out = cols.sum(axis=-1)
    return out.astype(np.float32)


def resize(img: np.ndarray, size, mode: str = "bilinear") -> np.ndarray:
    """torch-interpolate-compatible dispatcher; img (..., H, W)."""
    if isinstance(size, int):
        out_h = out_w = size
    else:
        out_h, out_w = size
    if mode == "nearest":
        return resize_nearest(img, out_h, out_w)
    if mode == "bilinear":
        return resize_bilinear(img, out_h, out_w)
    if mode == "bicubic":
        return resize_bicubic(img, out_h, out_w)
    raise ValueError(f"unknown resize mode {mode}")
