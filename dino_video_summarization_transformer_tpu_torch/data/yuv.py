"""Planar YUV 4:2:0 frame wire (counterpart of the JAX package's
``data/yuv.py``): the host-side numpy helpers, copied, and the plain torch
versions of its device unpack, ``unpack_normalize`` and
``unpack_normalize_q``.

Video codecs store frames as subsampled planar YUV (4:2:0, 1.5 B/px). The
wire keeps that layout from the decoder to the card: the native decoder
emits packed I420 (``data/video.py`` ``read_video_yuv420``), the host never
touches the pixels, and the card gathers, unpacks, colour-converts and
normalizes the frames in one pass (``ops/wire.py``, whose plain version is
built on the torch functions here).

Layout ("packed I420"): a (T, H*3//2, W) uint8 array per clip viewing the
decoder's contiguous byte stream (native/decoder.cc packs Y then U then V
with no padding):
  rows [0, H)        Y plane (full resolution)
  rows [H, H*3//2)   chroma bytes: U plane (H//2 * W//2 bytes) immediately
                     followed by V plane (likewise), flattened row-major
H and W must be even. The chroma planes are sliced from the FLAT byte
stream, not from whole rows: for H % 4 == 0 the U plane happens to occupy
exactly rows [H, H+H//4), but for H == 2 (mod 4) (e.g. 480x270 video) it
ends mid-row.

"yuv420q" keeps Y and box-averages the chroma a further 4x per axis (1/8
resolution per axis, ~1.03 B/px): U then V, byte-flat after the Y rows,
zero-padded to whole rows of width W; H % 8 == 0 and W % 8 == 0. It is an
experimental knob (16-27% relative score error on the JAX package's
synthetic validators), not a production mode.

Colour math: BT.601 limited range, chroma upsampled nearest-neighbour.
The torch functions compute in f32 in the JAX order (c, d, e, the three
channel sums, clip to [0, 255], / 255, (x - mean) / std, the cast), each
operation rounded on its own, so the hand-written kernel, which rounds at
the same points, can equal them bit for bit.
"""

from __future__ import annotations

import numpy as np

# BT.601 luma weights.
_KR, _KG, _KB = 0.299, 0.587, 0.114
# Limited-range excursions: Y spans 219 steps from 16, chroma 224 from 128.
_YSCALE = 219.0 / 255.0
_CSCALE = 224.0 / 255.0
# Inverse-matrix coefficients.
_Y_GAIN = 255.0 / 219.0                      # 1.1643836
_R_V = (255.0 / 224.0) * 2.0 * (1.0 - _KR)   # 1.5960267
_B_U = (255.0 / 224.0) * 2.0 * (1.0 - _KB)   # 2.0172321
_G_U = _B_U * _KB / _KG                      # 0.3917623
_G_V = _R_V * _KR / _KG                      # 0.8129676


def packed_height(h: int) -> int:
    """Rows of the packed I420 image for a frame height ``h`` (even)."""
    return h + h // 2


def frame_height(packed_rows: int) -> int:
    """Frame height from packed I420 row count."""
    return (packed_rows * 2) // 3


def pack_rgb(frames: np.ndarray) -> np.ndarray:
    """RGB (T, H, W, 3) uint8 -> packed I420 (T, H*3//2, W) uint8.

    Host-side fallback for sources that are already RGB (synthetic bench
    corpora, .npy fixtures); real videos come out of the native decoder
    already packed (data/video.py read_video_yuv420). Chroma is box-averaged
    over each 2x2 block before subsampling.
    """
    frames = np.asarray(frames)
    assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
    T, H, W, _ = frames.shape
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y_full = _KR * r + _KG * g + _KB * b
    y = 16.0 + _YSCALE * y_full
    u = 128.0 + _CSCALE * 0.5 / (1.0 - _KB) * (b - y_full)
    v = 128.0 + _CSCALE * 0.5 / (1.0 - _KR) * (r - y_full)
    # 2x2 box average then subsample (4:2:0 chroma siting)
    u = u.reshape(T, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    v = v.reshape(T, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    out = np.empty((T, packed_height(H), W), np.uint8)
    out[:, :H] = np.clip(np.rint(y), 16, 235)
    chroma = np.concatenate(
        [np.clip(np.rint(u), 16, 240).reshape(T, -1),
         np.clip(np.rint(v), 16, 240).reshape(T, -1)], axis=1)
    out[:, H:] = chroma.reshape(T, H // 2, W)
    return out


def _planes(packed: np.ndarray):
    rows, W = packed.shape[-2:]
    H = frame_height(rows)
    lead = packed.shape[:-2]
    y = packed[..., :H, :]
    # chroma planes are byte-flat after the Y rows (see module docstring) —
    # row-based slicing would only be correct for H % 4 == 0
    chroma = packed[..., H:, :].reshape(*lead, (H // 2) * W)
    q = (H // 2) * (W // 2)
    u = chroma[..., :q].reshape(*lead, H // 2, W // 2)
    v = chroma[..., q:].reshape(*lead, H // 2, W // 2)
    return y, u, v, H, W


def unpack_to_rgb(packed: np.ndarray) -> np.ndarray:
    """Packed I420 (..., H*3//2, W) uint8 -> RGB (..., H, W, 3) uint8.

    Host mirror of the device math in ``unpack_normalize`` (nearest-neighbor
    chroma upsample + BT.601 limited-range inverse), used by tests and by
    CPU-side consumers of YUV-decoded frames.
    """
    y, u, v, H, W = _planes(np.asarray(packed))
    c = (y.astype(np.float32) - 16.0) * _Y_GAIN
    d = np.repeat(np.repeat(u, 2, axis=-2), 2, axis=-1).astype(np.float32) - 128.0
    e = np.repeat(np.repeat(v, 2, axis=-2), 2, axis=-1).astype(np.float32) - 128.0
    rgb = np.stack([c + _R_V * e,
                    c - _G_U * d - _G_V * e,
                    c + _B_U * d], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def crop(packed: np.ndarray, y0: int, x0: int, ch: int, cw: int) -> np.ndarray:
    """Spatial crop of a packed I420 buffer.

    Offsets are rounded DOWN to even so the chroma grid stays aligned (a
    half-chroma-pixel shift vs an exact-odd RGB crop — visually and
    numerically negligible, quantified in the JAX package's
    tests/test_yuv_wire.py).
    ``ch``/``cw`` must be even.
    """
    assert ch % 2 == 0 and cw % 2 == 0, (ch, cw)
    y0 &= ~1
    x0 &= ~1
    y, u, v, H, W = _planes(np.asarray(packed))
    lead = packed.shape[:-2]
    yc = y[..., y0:y0 + ch, x0:x0 + cw]
    uc = u[..., y0 // 2:(y0 + ch) // 2, x0 // 2:(x0 + cw) // 2]
    vc = v[..., y0 // 2:(y0 + ch) // 2, x0 // 2:(x0 + cw) // 2]
    chroma = np.concatenate(
        [np.ascontiguousarray(uc).reshape(*lead, -1),
         np.ascontiguousarray(vc).reshape(*lead, -1)], axis=-1)
    out = np.concatenate(
        [yc, chroma.reshape(*lead, ch // 2, cw)], axis=-2)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# yuv420q: quarter-resolution chroma
#
# U/V box-averaged a further 4x per axis (1/64th the chroma samples; 1.5 ->
# ~1.03 B/px, a 224-px frame 75.3 -> 51.7 KB). Invalidated on quality in
# the JAX package (16-27% relative score error at 1/8 per axis on its
# synthetic validators); kept as an experimental knob (`--wire_format
# yuv420q`) for revalidation against trained checkpoints.
#
# Layout: Y rows [0, H) as in I420; then U (H//8 * W//8 bytes) followed by
# V (likewise), byte-flat, zero-padded to whole rows of width W. Requires
# H % 8 == 0 and W % 8 == 0 (scoring crops to 224 first).
# ---------------------------------------------------------------------------


def packed_q_height(h: int, w: int) -> int:
    """Rows of the packed yuv420q image for an (h, w) frame."""
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    return h + -(-2 * (h // 8) * (w // 8) // w)


def frame_height_q(rows: int, w: int) -> int:
    """Frame height from packed yuv420q row count (H % 8 == 0)."""
    h = (32 * rows // 33) // 8 * 8
    while packed_q_height(h, w) < rows:
        h += 8
    assert packed_q_height(h, w) == rows, (rows, w)
    return h


def _chroma_q(u: np.ndarray, v: np.ndarray):
    """Half-res chroma planes -> 4x4 box-averaged eighth-res planes."""
    lead = u.shape[:-2]
    h2, w2 = u.shape[-2:]
    assert h2 % 4 == 0 and w2 % 4 == 0, (h2, w2)
    uq = u.astype(np.float32).reshape(
        *lead, h2 // 4, 4, w2 // 4, 4).mean(axis=(-3, -1))
    vq = v.astype(np.float32).reshape(
        *lead, h2 // 4, 4, w2 // 4, 4).mean(axis=(-3, -1))
    return (np.clip(np.rint(uq), 16, 240).astype(np.uint8),
            np.clip(np.rint(vq), 16, 240).astype(np.uint8))


def _assemble_q(y: np.ndarray, uq: np.ndarray, vq: np.ndarray) -> np.ndarray:
    lead = y.shape[:-2]
    H, W = y.shape[-2:]
    rows = packed_q_height(H, W)
    chroma = np.concatenate([uq.reshape(*lead, -1),
                             vq.reshape(*lead, -1)], axis=-1)
    pad = (rows - H) * W - chroma.shape[-1]
    if pad:
        chroma = np.concatenate(
            [chroma, np.zeros((*lead, pad), np.uint8)], axis=-1)
    return np.ascontiguousarray(np.concatenate(
        [y, chroma.reshape(*lead, rows - H, W)], axis=-2))


def quarter_chroma(packed: np.ndarray) -> np.ndarray:
    """Packed I420 (..., H*3//2, W) -> packed yuv420q (the host-side step
    applied to the native decoder's planes; Y bytes are untouched)."""
    y, u, v, H, W = _planes(np.asarray(packed))
    uq, vq = _chroma_q(u, v)
    return _assemble_q(y, uq, vq)


def pack_rgb_q(frames: np.ndarray) -> np.ndarray:
    """RGB (T, H, W, 3) uint8 -> packed yuv420q, via the I420 pack (so the
    chroma siting matches what quarter_chroma produces from the codec)."""
    return quarter_chroma(pack_rgb(frames))


def _planes_q(packed, w: int):
    rows = packed.shape[-2]
    H = frame_height_q(rows, w)
    lead = packed.shape[:-2]
    y = packed[..., :H, :]
    chroma = packed[..., H:, :].reshape(*lead, (rows - H) * w)
    q = (H // 8) * (w // 8)
    u = chroma[..., :q].reshape(*lead, H // 8, w // 8)
    v = chroma[..., q:2 * q].reshape(*lead, H // 8, w // 8)
    return y, u, v, H


def unpack_q_to_rgb(packed: np.ndarray) -> np.ndarray:
    """Packed yuv420q -> RGB uint8 (host mirror of unpack_normalize_q)."""
    packed = np.asarray(packed)
    y, u, v, H = _planes_q(packed, packed.shape[-1])
    c = (y.astype(np.float32) - 16.0) * _Y_GAIN
    d = np.repeat(np.repeat(u, 8, axis=-2), 8, axis=-1).astype(np.float32) - 128.0
    e = np.repeat(np.repeat(v, 8, axis=-2), 8, axis=-1).astype(np.float32) - 128.0
    rgb = np.stack([c + _R_V * e,
                    c - _G_U * d - _G_V * e,
                    c + _B_U * d], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def crop_q(packed: np.ndarray, y0: int, x0: int, ch: int, cw: int) -> np.ndarray:
    """Spatial crop of a packed yuv420q buffer (offsets rounded down to a
    multiple of 8 so the eighth-res chroma grid stays aligned; ch/cw must
    be multiples of 8)."""
    assert ch % 8 == 0 and cw % 8 == 0, (ch, cw)
    y0 &= ~7
    x0 &= ~7
    packed = np.asarray(packed)
    y, u, v, H = _planes_q(packed, packed.shape[-1])
    yc = np.ascontiguousarray(y[..., y0:y0 + ch, x0:x0 + cw])
    uc = np.ascontiguousarray(
        u[..., y0 // 8:(y0 + ch) // 8, x0 // 8:(x0 + cw) // 8])
    vc = np.ascontiguousarray(
        v[..., y0 // 8:(y0 + ch) // 8, x0 // 8:(x0 + cw) // 8])
    return _assemble_q(yc, uc, vc)


# ---------------------------------------------------------------------------
# The device unpack, plain torch (the JAX package's jnp versions)
# ---------------------------------------------------------------------------


def normalize(rgb, mean, std, dtype):
    """f32 (..., 3) RGB in [0, 255] -> (rgb / 255 - mean) / std in ``dtype``.
    Each divisor is a tensor on ``rgb``'s device: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal, which rounds
    differently from a true division."""
    import torch

    dev = rgb.device
    rgb = rgb / torch.tensor(255.0, device=dev)
    m = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    s = torch.as_tensor(std, dtype=torch.float32, device=dev)
    return ((rgb - m) / s).to(dtype)


def _to_rgb(y, u, v, up: int):
    """Y (..., H, W) and chroma (..., H/up, W/up) uint8 -> f32 RGB
    (..., H, W, 3) clipped to [0, 255]."""
    import torch

    c = (y.float() - 16.0) * _Y_GAIN
    d = u.repeat_interleave(up, -2).repeat_interleave(up, -1).float() - 128.0
    e = v.repeat_interleave(up, -2).repeat_interleave(up, -1).float() - 128.0
    rgb = torch.stack([c + _R_V * e,
                       c - _G_U * d - _G_V * e,
                       c + _B_U * d], dim=-1)
    return rgb.clamp(0.0, 255.0)


def _torch_planes(packed, H: int, ch: int, cw: int):
    """Y and the byte-flat U, V planes of (ch, cw) from packed uint8."""
    lead = packed.shape[:-2]
    y = packed[..., :H, :]
    chroma = packed[..., H:, :].reshape(*lead, -1)
    q = ch * cw
    u = chroma[..., :q].reshape(*lead, ch, cw)
    v = chroma[..., q:2 * q].reshape(*lead, ch, cw)
    return y, u, v


def unpack_normalize(packed, mean, std, dtype):
    """Packed I420 (..., H*3//2, W) uint8 tensor -> normalized (..., H, W, 3)
    in ``dtype`` (JAX ``data/yuv.py`` ``unpack_normalize``)."""
    rows, W = packed.shape[-2:]
    H = frame_height(rows)
    y, u, v = _torch_planes(packed, H, H // 2, W // 2)
    return normalize(_to_rgb(y, u, v, 2), mean, std, dtype)


def unpack_normalize_q(packed, mean, std, dtype):
    """Packed yuv420q (..., rows, W) uint8 tensor -> normalized
    (..., H, W, 3) in ``dtype`` (JAX ``unpack_normalize_q``)."""
    rows, W = packed.shape[-2:]
    H = frame_height_q(rows, W)
    y, u, v = _torch_planes(packed, H, H // 8, W // 8)
    return normalize(_to_rgb(y, u, v, 8), mean, std, dtype)
