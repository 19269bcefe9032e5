"""The frame wire's gather, for Hopper, with its plain twin.

``gather_normalize(frames, idx, dtype, layout)`` gathers frames from a
uint8 buffer on the card by index and returns them unpacked,
colour-converted and normalized, (M, H, W, 3) channels-last in f32 or
bf16. Layouts:

* ``rgb8``: (N, H, W, 3) RGB bytes, ``(x / 255 - mean) / std``;
* ``yuv420``: packed I420 (N, H*3//2, W), the codec's planar 4:2:0
  (``data/yuv.py``);
* ``yuv420q``: packed I420 with eighth-resolution chroma (N, rows, W).

It replaces no Pallas kernel: in the JAX package XLA fuses the gather
(``jnp.take``) with ``data/yuv.py``'s ``unpack_normalize`` /
``unpack_normalize_q`` (:288 / :265), or the RGB wire's normalization,
inside ``engine/scoring.py``'s ``_gather_views`` and ``_gather_frames``.
The scorer calls it for every view gather of a uint8 buffer, in each
forward's own dtype (the mixed teacher's f32 views and the students' bf16
views from the one buffer).

The kernel (``csrc/wire.cu``) runs on a CUDA buffer, the twin
(``gather_normalize_plain``, built on ``data/yuv.py``'s torch functions)
on a CPU buffer; any other device raises and nothing falls back.
``launches`` counts kernel launches. The indices are host arrays (numpy or
a CPU tensor): the wrapper checks them against the buffer's frame count
on the host and copies them to the card itself, so an out-of-range index
raises before anything launches. Kernel and twin round at the same points
(f32 steps in the JAX order, bf16 to nearest even): on the card they agree
bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..data import yuv

# the scorer's normalization (JAX ``engine/scoring.py`` ``FrameScorer``),
# written into csrc/wire.cu as literals
MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)
LAYOUTS = {"rgb8": 0, "yuv420": 1, "yuv420q": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper (the plain twin does not count).
launches: Dict[str, int] = {"gather_normalize": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def frame_geometry(frames: torch.Tensor, layout: str) -> Tuple[int, int]:
    """(H, W) of the frames a uint8 buffer holds in ``layout``; raises on a
    buffer that is not one."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}, expected one of {tuple(LAYOUTS)}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"frames: dtype {frames.dtype}, the wire carries uint8")
    if layout == "rgb8":
        if frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError(f"rgb8 frames: expected (N, H, W, 3), got "
                             f"{tuple(frames.shape)}")
        return frames.shape[1], frames.shape[2]
    if frames.dim() != 3:
        raise ValueError(f"{layout} frames: expected packed (N, rows, W), got "
                         f"{tuple(frames.shape)}")
    rows, W = frames.shape[1:]
    if layout == "yuv420":
        H = yuv.frame_height(rows)
        if H % 2 or W % 2 or yuv.packed_height(H) != rows:
            raise ValueError(f"yuv420 frames: {rows} rows of width {W} are no "
                             "packed I420 frame (even H and W)")
        return H, W
    try:
        H = yuv.frame_height_q(rows, W)
    except AssertionError:
        raise ValueError(f"yuv420q frames: {rows} rows of width {W} are no "
                         "packed yuv420q frame (H and W multiples of 8)") from None
    return H, W


def index_tensor(idx, n_frames: int, device) -> torch.Tensor:
    """The host index array ``idx`` (numpy or a CPU tensor) as int64 on
    ``device``, after checking every index lies in [0, n_frames). On a
    card the copy goes through pinned memory without a host sync."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise TypeError("idx: a host array is expected (the wrapper checks "
                            f"it before the copy), got a tensor on {idx.device}")
        idx = idx.numpy()
    idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= n_frames):
        raise IndexError(f"frame index out of range: [{idx.min()}, {idx.max()}] "
                         f"for a buffer of {n_frames} frames")
    t = torch.from_numpy(idx)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _check(frames, dtype, layout):
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}, expected f32 or bf16")
    if not frames.is_contiguous():
        raise ValueError("frames: must be contiguous")
    return frame_geometry(frames, layout)


def gather_normalize_plain(frames: torch.Tensor, idx, dtype: torch.dtype,
                           layout: str) -> torch.Tensor:
    """Plain twin of ``gather_normalize``: the uint8 gather, then
    ``data/yuv.py``'s unpack (or the RGB normalization) in torch, on the
    buffer's device."""
    _check(frames, dtype, layout)
    v = frames[index_tensor(idx, frames.shape[0], frames.device)]
    if layout == "rgb8":
        return yuv.normalize(v.float(), MEAN, STD, dtype)
    unpack = yuv.unpack_normalize if layout == "yuv420" else yuv.unpack_normalize_q
    return unpack(v, MEAN, STD, dtype)


def gather_normalize(frames: torch.Tensor, idx, dtype: torch.dtype,
                     layout: str) -> torch.Tensor:
    """frames: a uint8 buffer in ``layout``; idx: host int64 indices (any
    shape, flattened; repeats allowed) -> (M, H, W, 3) in ``dtype``
    (f32 or bf16), normalized. Kernel on CUDA, plain twin on CPU."""
    H, W = _check(frames, dtype, layout)
    if frames.device.type == "cpu":
        return gather_normalize_plain(frames, idx, dtype, layout)
    dev = frames.device
    ix = index_tensor(idx, frames.shape[0], dev)
    M = ix.numel()
    if M > 65535:
        raise ValueError(f"{M} frames in one call: the kernel's grid takes at "
                         "most 65535")
    out = torch.empty((M, H, W, 3), dtype=dtype, device=dev)
    if M == 0:
        return out
    from . import _build
    from .fused_block import _run, _stream

    lib = _build.load("wire")
    frame_bytes = math.prod(frames.shape[1:])
    with torch.cuda.device(dev):
        _run(lib.dvst_gather_normalize, frames.data_ptr(), ix.data_ptr(),
             out.data_ptr(), M, H, W, frame_bytes, LAYOUTS[layout], _DTYPES[dtype], _stream(dev))
    launches["gather_normalize"] += 1
    return out


def gather_bytes(frames: torch.Tensor, idx, dtype: torch.dtype,
                 layout: str) -> int:
    """The bytes one call must move: each distinct frame that ``idx``
    gathers read once (repeats and overlapping windows read a frame
    once), the (M, H, W, 3) output written once."""
    H, W = frame_geometry(frames, layout)
    idx = np.asarray(idx).reshape(-1)
    return (np.unique(idx).size * math.prod(frames.shape[1:])
            + idx.size * H * W * 3 * torch.finfo(dtype).bits // 8)
