"""Build the Hopper kernels with nvcc and load them with ctypes.

One shared library with a plain C interface per source in ``csrc/``,
compiled for ``sm_90a`` into ``build/torch_kernels/`` at the repo root
(listed in ``.gitignore``) at first use. Nothing here runs at import: the
CPU tests import every module on a machine with no nvcc.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/libdvst_fused.so \\
        dino_video_summarization_transformer_tpu_torch/ops/csrc/fused_block.cu
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import time

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_OPS_DIR))
SOURCE = os.path.join(_OPS_DIR, "csrc", "fused_block.cu")
LIB_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
LIB_PATH = os.path.join(LIB_DIR, "libdvst_fused.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


@dataclasses.dataclass
class BuildResult:
    path: str
    seconds: float  # 0.0 when an up-to-date library was found
    log: str        # nvcc's output, with the -Xptxas -v resource lines


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels build on a "
                       "machine with the CUDA toolkit")


def build(force: bool = False) -> BuildResult:
    """Compile ``SOURCE`` unless an up-to-date library exists (or
    ``force``). The library is written under a temporary name and renamed,
    so concurrent builders never load a half-written file."""
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return BuildResult(LIB_PATH, 0.0, "")
    os.makedirs(LIB_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log[-6000:]}")
    os.replace(tmp, LIB_PATH)
    return BuildResult(LIB_PATH, seconds, log)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(LIB_PATH)
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, 8 weights, workspace, out | B, T, N, D, H | stream
    lib.dvst_temporal_phase_tm.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.dvst_temporal_phase_tm.restype = i
    # x1, cls, 12 weights, workspace, x2, out, cls_rows | B, T, N, D, H, Dh | stream
    lib.dvst_spatial_mlp.argtypes = [p] * 18 + [i] * 6 + [p]
    lib.dvst_spatial_mlp.restype = i
    lib.dvst_error_string.argtypes = [i]
    lib.dvst_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return load().dvst_error_string(err).decode()
