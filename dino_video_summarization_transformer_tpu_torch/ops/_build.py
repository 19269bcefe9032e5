"""Build the Hopper kernels with nvcc and load them with ctypes.

One shared library with a plain C interface per source in ``csrc/``
(``fused_block.cu``, ``banded_block.cu``, ``fused_block_bwd.cu``,
``attention.cu``, each including ``dvst_common.cuh``; all also the
tensor-core attention tile ``tc_attention.cuh``, all but ``attention.cu``
the wgmma + TMA GEMM ``wgmma_gemm.cuh``; and the standalone
``smem_probe.cu`` and ``wire.cu``, the frame wire's gather), compiled for ``sm_90a`` into ``build/torch_kernels/``
at the repo root (listed in ``.gitignore``) at first use, one nvcc per
source, all started together. Nothing here runs at import: the CPU tests
import every module on a machine with no nvcc.

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
from typing import Dict, List

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_OPS_DIR))
_CSRC = os.path.join(_OPS_DIR, "csrc")
HEADERS = [os.path.join(_CSRC, h)
           for h in ("dvst_common.cuh", "tc_attention.cuh", "wgmma_gemm.cuh")]
LIB_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
# library name -> source
SOURCES = {"fused": os.path.join(_CSRC, "fused_block.cu"),
           "banded": os.path.join(_CSRC, "banded_block.cu"),
           "bwd": os.path.join(_CSRC, "fused_block_bwd.cu"),
           "attention": os.path.join(_CSRC, "attention.cu"),
           "probe": os.path.join(_CSRC, "smem_probe.cu"),
           "wire": os.path.join(_CSRC, "wire.cu")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# C entry point -> argtypes (pointers, then sizes, then the stream)
_SIGNATURES = {
    "fused": {
        # x, 8 weights, workspace, out | B, T, N, D, H, x_f32, out_bf16 | stream
        "dvst_temporal_phase_tm": [_p] * 11 + [_i] * 7 + [_p],
        # its workspace bytes (returns long) | B, T, N, D
        "dvst_temporal_phase_tm_ws": [_i] * 4,
        # x, cls, 6 weights, workspace, out, cls_rows | B, T, N, D, H,
        # out_f32, x_f32 | stream
        "dvst_spatial_phase": [_p] * 11 + [_i] * 7 + [_p],
        # its workspace bytes (returns long) | B, T, N, D
        "dvst_spatial_phase_ws": [_i] * 4,
        # x1, cls, 12 weights, workspace, out, cls_rows | B, T, N, D, H, Dh,
        # cls_f32, out_f32 | stream
        "dvst_spatial_mlp": [_p] * 17 + [_i] * 7 + [_p],
        # its workspace bytes (returns long) | B, T, N, D, Dh
        "dvst_spatial_mlp_ws": [_i] * 5,
        # x, 6 weights, workspace, out | M | D, Dh, residual, x_f32 | stream
        "dvst_mlp_phase": [_p] * 9 + [_l] + [_i] * 4 + [_p],
        # its workspace bytes (returns long) | M | D, Dh
        "dvst_mlp_phase_ws": [_l] + [_i] * 2,
        # x, 6 weights, workspace, out | S, L, D, H | stream
        "dvst_attn_phase": [_p] * 9 + [_i] * 4 + [_p],
        # x, 8 weights, workspace, out | S, L, D, H | stream
        "dvst_temporal_phase": [_p] * 11 + [_i] * 4 + [_p],
        # qkv, qkv_pre, out, out_pre | S, S_lo, N, D, H | scale | stream
        "dvst_spatial_attn": [_p] * 4 + [_i] * 5 + [_f, _p],
        # shared bytes of one block (returns long) | L, hd
        "dvst_spatial_attn_smem": [_i] * 2,
        # qkv, out | B, T, N, D, H | scale | stream
        "dvst_temporal_attn": [_p] * 2 + [_i] * 5 + [_f, _p],
        # shared bytes of one block (returns long) | S, L, hd
        "dvst_temporal_attn_smem": [_i] * 3,
        # A, W, bias, res, out | M | N, K, epilogue | stream
        "dvst_gemm": [_p] * 5 + [_l] + [_i] * 3 + [_p],
        # the int8 tier: x, 11 weights and scales, workspace, out | B, T,
        # N, D, H, x_f32 | stream
        "dvst_temporal_phase_tm_q8": [_p] * 14 + [_i] * 6 + [_p],
        # its workspace bytes (returns long) | B, T, N, D
        "dvst_temporal_phase_tm_q8_ws": [_i] * 4,
        # x1, cls, 16 weights and scales, workspace, out, cls_rows | B, T,
        # N, D, H, Dh, f32 | stream
        "dvst_spatial_mlp_q8": [_p] * 21 + [_i] * 7 + [_p],
        # its workspace bytes (returns long) | B, T, N, D, Dh
        "dvst_spatial_mlp_q8_ws": [_i] * 5,
        # A, sx, W, sw, bias, res, out | M | N, K, epilogue | stream
        "dvst_gemm_s8": [_p] * 7 + [_l] + [_i] * 3 + [_p],
        # x, codes, scales | M | D | stream
        "dvst_quant_rows": [_p] * 3 + [_l, _i, _p],
        # x, w, b, codes, scales | M | D, x_f32 | stream
        "dvst_ln_quant_rows": [_p] * 5 + [_l] + [_i] * 2 + [_p],
    },
    "banded": {
        # qkv, out | C, N, D, H, t_real, eff | stream
        "dvst_banded_temporal_attn": [_p] * 2 + [_i] * 6 + [_p],
        # shared bytes of one block (returns long) | D, H, eff
        "dvst_banded_temporal_attn_smem": [_i] * 3,
        # x, cls, 6 weights, workspace, out, qkv, qkv_cls | C, N, D, H, x_f32
        # | stream
        "dvst_spatial_pf": [_p] * 12 + [_i] * 5 + [_p],
        # its workspace bytes (returns long) | C, N, D
        "dvst_spatial_pf_ws": [_i] * 3,
        # qkv_cls, qkv, out, workspace | C, N, D, H, t_real, eff | stream
        "dvst_cls_band_attn": [_p] * 4 + [_i] * 6 + [_p],
        # its workspace bytes (returns long) | C, N, D, H, eff
        "dvst_cls_band_attn_ws": [_i] * 5,
        # tests and tools only: the same in a given block shape | ... |
        # strips, warps a strip, splits | stream; the shape a call takes
        # | C, N, D, H, eff | int[3] out
        "dvst_cls_band_attn_shaped": [_p] * 4 + [_i] * 9 + [_p],
        "dvst_cls_band_shape": [_i] * 5 + [_p],
        # shared bytes of one block (returns long) | N, hd
        "dvst_cls_band_smem": [_i] * 2,
        # shared bytes of one block of dvst_spatial_pf's attention (returns
        # long) | L, hd
        "dvst_spatial_attn_smem": [_i] * 2,
    },
    "bwd": {
        # x, dout, 8 weights, workspace, dx, dln, 6 weight grads
        # | B, T, N, D, H, f32 | stream
        "dvst_temporal_phase_tm_bwd": [_p] * 19 + [_i] * 6 + [_p],
        # x, cls, dgo, dco, 6 weights, workspace, dx, dcls, dln, 4 weight
        # grads | B, T, N, D, H, f32 | stream
        "dvst_spatial_phase_bwd": [_p] * 18 + [_i] * 6 + [_p],
        # x, do, 6 weights, workspace, dx, dln, 4 weight grads | M | D, Dh,
        # residual, f32 | stream
        "dvst_mlp_phase_bwd": [_p] * 15 + [_l] + [_i] * 4 + [_p],
        # workspace bytes of the three (returns long) | ..., f32
        "dvst_temporal_phase_tm_bwd_ws": [_i] * 6,
        "dvst_spatial_phase_bwd_ws": [_i] * 6,
        "dvst_mlp_phase_bwd_ws": [_l] + [_i] * 3,
        # qkv, qkv_pre, da, da_pre, dqkv, dqkv_pre | S, S_lo, N, D, H | scale
        # | stream
        "dvst_spatial_attn_bwd": [_p] * 6 + [_i] * 5 + [_f, _p],
        # shared bytes of one block (returns long) | L, hd
        "dvst_spatial_attn_bwd_smem": [_i] * 2,
        # qkv, da, dqkv | B, T, N, D, H | scale | stream
        "dvst_temporal_attn_bwd": [_p] * 3 + [_i] * 5 + [_f, _p],
        # shared bytes of one block (returns long) | S, L, hd
        "dvst_temporal_attn_bwd_smem": [_i] * 3,
        # x, x_tail, dy, w, res, dx, dx_tail, partials, dgb | M, R | D,
        # tail_div, f32 | stream
        "dvst_layer_norm_bwd": [_p] * 9 + [_l] * 2 + [_i] * 3 + [_p],
        # bytes of partials (returns long) | R | D
        "dvst_layer_norm_bwd_ws": [_l, _i],
        # dY, W, aux, out | M | N, K, epilogue | stream
        "dvst_gemm_dx": [_p] * 4 + [_l] + [_i] * 3 + [_p],
        # dY, X, out, partials | rows | n_out, k_in | stream
        "dvst_gemm_dw": [_p] * 4 + [_l] + [_i] * 2 + [_p],
        # bytes of partials (returns long), splits | rows | n_out, k_in
        "dvst_gemm_dw_ws": [_l] + [_i] * 2,
        "dvst_gemm_dw_splits": [_l] + [_i] * 2,
        # A, W, bias, hg, gp | M | N, K | stream
        "dvst_gemm_gelu_grad": [_p] * 5 + [_l] + [_i] * 2 + [_p],
    },
    "attention": {
        # q, k, v, out | BH, L, hd | scale | dtype | stream
        "dvst_fused_attention": [_p] * 4 + [_i] * 3 + [_f, _i, _p],
        # shared bytes of one block (returns long) | BH, L, hd, dtype
        "dvst_fused_attention_smem": [_i] * 4,
        # the instance a call takes (0 tensor cores, 1 CUDA cores, -1 none)
        # | hd, dtype
        "dvst_fused_attention_instance": [_i] * 2,
    },
    "probe": {
        # in, out | nbytes | stream
        "dvst_smem_roundtrip": [_p] * 2 + [_i, _p],
        "dvst_smem_optin_max": [],
    },
    "wire": {
        # frames, idx, out | M, H, W | frame_bytes | layout, out_bf16 | stream
        "dvst_gather_normalize": [_p] * 3 + [_i] * 3 + [_l] + [_i] * 2 + [_p],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    path: str
    seconds: float  # 0.0 when an up-to-date library was found
    log: str        # nvcc's output, with the -Xptxas -v resource lines


def lib_path(name: str) -> str:
    return os.path.join(LIB_DIR, f"libdvst_{name}.so")


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels build on a "
                       "machine with the CUDA toolkit")


def _fresh(name: str) -> bool:
    path = lib_path(name)
    return (os.path.exists(path) and os.path.getmtime(path)
            >= max(os.path.getmtime(p) for p in [SOURCES[name], *HEADERS]))


def build(force: bool = False) -> List[BuildResult]:
    """Compile every library whose source or header is newer than it (all
    of them with ``force``), one nvcc per source, run in parallel. Each
    library is written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    os.makedirs(LIB_DIR, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        if not force and _fresh(name):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results, failed = [], []
    for name in SOURCES:
        if name not in procs:
            results.append(BuildResult(lib_path(name), 0.0, ""))
            continue
        tmp, t0, proc = procs[name]
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name]} failed (exit "
                          f"{proc.returncode}):\n{log[-6000:]}")
            continue
        os.replace(tmp, lib_path(name))
        results.append(BuildResult(lib_path(name), seconds, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str = "fused") -> ctypes.CDLL:
    """One kernel library (a key of ``SOURCES``), built on first use."""
    if name in _libs:
        return _libs[name]
    if not _fresh(name):
        build()
    lib = ctypes.CDLL(lib_path(name))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _l if fn.endswith(("_ws", "_smem")) else _i
    if name == "fused":
        lib.dvst_error_string.argtypes = [_i]
        lib.dvst_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def error_string(err: int) -> str:
    return load("fused").dvst_error_string(err).decode()
