"""Video decode through the repo's native libav shim (ctypes): RGB24 and
packed I420 (the frame wire, ``data/yuv.py``).

The RGB and I420 subset of the JAX package's ``data/video.py``. The shim
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
    _LIB = lib
    return lib


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
    n = t.value * h.value * w.value * 3
    if n == 0:
        lib.dvst_free(out)
        return np.zeros((0, h.value, w.value, 3), np.uint8), fps.value
    arr = np.ctypeslib.as_array(
        out, shape=(t.value, h.value, w.value, 3)).copy()
    lib.dvst_free(out)
    return arr, fps.value


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


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except DecodeError:
        return False
