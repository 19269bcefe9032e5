"""Video decode through the repo's native libav shim (ctypes): RGB24 and
packed I420 (the frame wire, ``data/yuv.py``), the container probe
(``video_info``), selective decode of a PTS range or of given frame
indices, and an mpeg4 encoder for test fixtures.

The counterpart of the JAX package's ``data/video.py``. The shim
(``native/libdvst_decoder.so``, built from ``native/decoder.cc``) is loaded
only when a video is decoded: importing this module needs neither the
library nor libav.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Tuple

import numpy as np

_LIB = None
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdvst_decoder.so")


class DecodeError(RuntimeError):
    pass


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        # the Makefile needs only g++ and the libav dev headers
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            raise DecodeError(
                f"native decoder not built and its build failed: {e}") from e
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        raise DecodeError(f"native decoder failed to load: {e}") from e
    lib.dvst_last_error.restype = ctypes.c_char_p
    lib.dvst_free.argtypes = [ctypes.c_void_p]
    lib.dvst_free.restype = None
    lib.dvst_decode_strided.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.dvst_decode_strided.restype = ctypes.c_int
    lib.dvst_decode_strided_yuv.argtypes = lib.dvst_decode_strided.argtypes
    lib.dvst_decode_strided_yuv.restype = ctypes.c_int
    lib.dvst_video_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.dvst_video_info.restype = ctypes.c_int
    lib.dvst_decode_range.argtypes = lib.dvst_decode_strided.argtypes
    lib.dvst_decode_range.restype = ctypes.c_int
    lib.dvst_decode_indices.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvst_decode_indices.restype = ctypes.c_int
    lib.dvst_encode_video.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
    ]
    lib.dvst_encode_video.restype = ctypes.c_int
    _LIB = lib
    return lib


def _take(ptr, t: int, h: int, w: int, lib) -> np.ndarray:
    """Copy a (T, H, W, 3) RGB24 buffer of the shim into numpy and free it."""
    if t * h * w == 0:
        lib.dvst_free(ptr)
        return np.zeros((0, h, w, 3), np.uint8)
    arr = np.ctypeslib.as_array(ptr, shape=(t, h, w, 3)).copy()
    lib.dvst_free(ptr)
    return arr


def video_info(path: str) -> dict:
    """The container's frame count, fps, width, height and duration; a
    count <= 0 where the container does not report it."""
    lib = _load_lib()
    nframes = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    dur = ctypes.c_double()
    if lib.dvst_video_info(path.encode(), ctypes.byref(nframes), ctypes.byref(fps),
                           ctypes.byref(w), ctypes.byref(h), ctypes.byref(dur)) != 0:
        raise DecodeError(lib.dvst_last_error().decode())
    return {"num_frames": nframes.value, "fps": fps.value, "width": w.value,
            "height": h.value, "duration_sec": dur.value}


def read_video(path: str, stride: int = 1, start: int = 0,
               max_frames: int = -1) -> Tuple[np.ndarray, float]:
    """Decode frames [start::stride][:max_frames] as (T, H, W, 3) uint8.
    ``stride`` is the reference's post-decode pre-sampling
    (``frames[::rate]``, ref: dino_loss_loader.py:85), done in the
    decoder."""
    lib = _load_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int64()
    h = ctypes.c_int()
    w = ctypes.c_int()
    fps = ctypes.c_double()
    rc = lib.dvst_decode_strided(
        path.encode(), start, stride, max_frames,
        ctypes.byref(out), ctypes.byref(t), ctypes.byref(h), ctypes.byref(w),
        ctypes.byref(fps))
    if rc != 0:
        raise DecodeError(lib.dvst_last_error().decode())
    return _take(out, t.value, h.value, w.value, lib), fps.value


def read_video_yuv420(path: str, stride: int = 1, start: int = 0,
                      max_frames: int = -1) -> Tuple[np.ndarray, float]:
    """Decode frames [start::stride][:max_frames] as packed I420
    (T, H*3//2, W) uint8: the codec's own planar 4:2:0 layout, half the
    bytes of RGB24. The colour conversion happens on the card
    (``ops/wire.py``); the host never makes RGB. H and W are rounded down
    to even."""
    lib = _load_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int64()
    h = ctypes.c_int()
    w = ctypes.c_int()
    fps = ctypes.c_double()
    rc = lib.dvst_decode_strided_yuv(
        path.encode(), start, stride, max_frames,
        ctypes.byref(out), ctypes.byref(t), ctypes.byref(h), ctypes.byref(w),
        ctypes.byref(fps))
    if rc != 0:
        raise DecodeError(lib.dvst_last_error().decode())
    shape = (t.value, h.value * 3 // 2, w.value)
    if t.value * shape[1] * shape[2] == 0:
        lib.dvst_free(out)
        return np.zeros(shape, np.uint8), fps.value
    arr = np.ctypeslib.as_array(out, shape=shape).copy()
    lib.dvst_free(out)
    return arr, fps.value


def read_video_range(path: str, start: int, end: int,
                     stride: int = 1) -> Tuple[np.ndarray, float]:
    """Selective PTS-range decode: keyframe-seek to ``start``, decode only
    the display frames in [start, end], keeping every ``stride``-th
    (ref: datasets_custom/decoder.py:217-304, pyav_decode's clip window).
    Returns ((T, H, W, 3) uint8, fps)."""
    lib = _load_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int64()
    h = ctypes.c_int()
    w = ctypes.c_int()
    fps = ctypes.c_double()
    rc = lib.dvst_decode_range(
        path.encode(), int(start), int(end), int(stride),
        ctypes.byref(out), ctypes.byref(t), ctypes.byref(h), ctypes.byref(w),
        ctypes.byref(fps))
    if rc != 0:
        raise DecodeError(lib.dvst_last_error().decode())
    return _take(out, t.value, h.value, w.value, lib), fps.value


def read_video_indices(path: str, indices) -> np.ndarray:
    """Decode only the display-ordered frames in ``indices`` as (T, H, W, 3)
    uint8 (ref: timesformer_evaluation.py:13-31, read_video_pyav)."""
    lib = _load_lib()
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    out = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int64()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.dvst_decode_indices(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), ctypes.byref(out), ctypes.byref(t), ctypes.byref(h),
        ctypes.byref(w))
    if rc != 0:
        raise DecodeError(lib.dvst_last_error().decode())
    return _take(out, t.value, h.value, w.value, lib)


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Encode (T, H, W, 3) uint8 RGB to an mpeg4 file (test fixtures)."""
    lib = _load_lib()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames: expected (T, H, W, 3), got {frames.shape}")
    rc = lib.dvst_encode_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, fps)
    if rc != 0:
        raise DecodeError(lib.dvst_last_error().decode())


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except DecodeError:
        return False
