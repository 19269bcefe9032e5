"""Standalone attention for Hopper, with its plain twin.

Counterpart of the JAX package's ``ops/attention.py``:

* ``fused_attention``: q, k, v (BH, L, hd) -> softmax(q k^T * scale) v,
  bf16 or f32, out in the input's dtype — replaces ``_attn_kernel``
  (attention.py:42). ``pack > 1`` means each row holds ``pack``
  independent sequences of L / pack rows (the JAX meaning); the port views
  the input as BH * pack sequences, which is the same memory. JAX's
  ``block_b`` tiles VMEM and has no counterpart here.
* ``mhsa_fused``: the counterpart of ``mhsa_pallas`` (attention.py:120):
  the qkv and proj products stay ``nn.Linear`` calls (XLA ``linear``
  outside the kernel in JAX), the head split and merge are torch
  transposes, and the attention runs in ``fused_attention``. The kernel
  puts several short sequences in one block itself, so no packing is
  needed here.

``TimeSformerConfig.attention_kernel`` swaps ``mhsa_fused`` into the plain
inference block, per model (JAX: the process-wide ``use_pallas_attention``).
Training keeps ``mhsa_train``: ``mhsa_pallas`` has no VJP.

The kernel (``csrc/attention.cu``) runs on a CUDA tensor, the twin
(``fused_attention_plain``) on a CPU tensor; any other device raises and
nothing falls back. ``launches`` counts kernel launches. The kernel has
two instances, fixed by dtype (``kernel_instance``): bf16 runs on the
tensor cores (``csrc/tc_attention.cuh``'s tile), f32 on the CUDA cores
(the tensor cores would take its scores in TF32).

Numerics, shared by kernel and twin: f32 scores, the row max subtracted,
probabilities rounded to bf16 before the PV product (for f32 inputs too,
as the Pallas kernel's P is bf16), an f32 denominator, out rounded to the
input dtype. Not ported: the Pallas kernel's +/-80 clamp in place of the
max and its ones-column denominator, and with them
``attention_logit_margin`` and ``clamp_value`` (attention.py:153-192),
which measure the clamp's margin.
"""

from __future__ import annotations

from typing import Dict

import torch

from .fused_block import (SMEM_LIMIT, _attention, _check_tensor, _device_of,
                          _run, _stream)

# Kernel launches per wrapper (the plain twin does not count).
launches: Dict[str, int] = {"fused_attention": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# csrc: dvst_fused_attention_instance's codes
INSTANCES = {0: "tensor_core", 1: "cuda_core"}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# Plain twin of ``fused_attention`` (pack 1): the twins' shared attention
# arithmetic.
fused_attention_plain = _attention


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, pack: int = 1) -> torch.Tensor:
    """q, k, v (BH, L, hd), all bf16 or all f32 -> softmax(q k^T * scale) v
    as (BH, L, hd) in their dtype, each row ``pack`` independent sequences
    of L / pack rows. Kernel on CUDA, plain twin on CPU."""
    if q.dim() != 3:
        raise ValueError(f"q: expected (BH, L, hd), got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected bf16 or f32")
    BH, L, hd = q.shape
    if pack < 1 or L % pack:
        raise ValueError(f"pack={pack} does not divide the row length {L}")
    dev = _device_of(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, q.dtype, q.shape, dev)
    if hd % 16 or hd > 128:
        raise ValueError(f"head dim {hd}: the kernel needs hd % 16 == 0 and "
                         "hd <= 128")
    BH, L = BH * pack, L // pack
    q3, k3, v3 = (t.view(BH, L, hd) for t in (q, k, v))
    if dev.type == "cpu":
        return fused_attention_plain(q3, k3, v3, scale).view(q.shape)

    from . import _build

    # the bf16 instance copies 16-byte chunks, the f32 one element pairs
    align = 16 if q.dtype == torch.bfloat16 else 2 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel needs a {align}-byte "
                             "aligned start")
    lib = _build.load("attention")
    smem = lib.dvst_fused_attention_smem(BH, L, hd, _DTYPES[q.dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd} in {q.dtype} "
                         f"needs {smem} B of shared memory (limit {SMEM_LIMIT})")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _run(lib.dvst_fused_attention, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), BH, L, hd, float(scale),
             _DTYPES[q.dtype], _stream(dev))
    launches["fused_attention"] += 1
    return out


def kernel_instance(dtype: torch.dtype, hd: int) -> str:
    """The kernel instance ``fused_attention`` launches on a CUDA tensor of
    ``dtype`` at head dim ``hd``, as the library reports it:
    "tensor_core" (bf16) or "cuda_core" (f32)."""
    from . import _build

    code = _build.load("attention").dvst_fused_attention_instance(
        hd, _DTYPES.get(dtype, -1))
    if code not in INSTANCES:
        raise ValueError(f"no kernel instance takes {dtype} at head dim {hd}")
    return INSTANCES[code]


def mhsa_fused(x: torch.Tensor, qkv: torch.nn.Linear, proj: torch.nn.Linear,
               num_heads: int) -> torch.Tensor:
    """Multi-head self-attention over (S, L, D) sequences with the
    attention in ``fused_attention``: the counterpart of ``mhsa_pallas``
    and a drop-in for ``models.timesformer.mhsa``."""
    S, L, C = x.shape
    H = num_heads
    hd = C // H
    # (S, L, 3, H, hd) -> (3, S*H, L, hd)
    q, k, v = qkv(x).reshape(S, L, 3, H, hd).permute(2, 0, 3, 1, 4).reshape(
        3, S * H, L, hd).contiguous().unbind(0)
    out = fused_attention(q, k, v, hd ** -0.5)
    return proj(out.reshape(S, H, L, hd).transpose(1, 2).reshape(S, L, C))
