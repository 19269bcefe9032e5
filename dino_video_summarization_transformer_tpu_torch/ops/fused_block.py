"""The divided space-time block ops for Hopper, with plain twins.

Counterpart of the JAX package's ``ops/fused_block.py`` whole-block path
(``fused_divided_block_wb``): a divided block as two ops,

* ``temporal_phase_tm``: x (B, T, N, D), frame-major ->
  x + temporal_fc(proj(MHSA over T at each position(LN x))), f32 out —
  replaces ``_temporal_phase_tm_kernel`` (fused_block.py:761);
* ``spatial_mlp``: the f32 carry x1 and the CLS row ->
  per frame on [cls, x_t]: LN -> MHSA -> proj -> grid residual -> LN ->
  MLP -> residual, the grid out, plus the raw per-frame CLS rows in f32 —
  replaces ``_spatial_mlp_kernel`` (fused_block.py:1556);

and ``divided_block_wb``, which chains them and updates the CLS row in
plain f32 torch (B rows: negligible), as the JAX package does. Its block
boundaries (x, the grid out, the CLS row) are bf16, or f32 in the mixed
teacher's tier (``engine/scoring.py``'s ``teacher_dtype``; JAX's mixed
tier of the same kernels): ``temporal_phase_tm`` then reads f32 x and
``spatial_mlp`` an f32 CLS row, and it writes an f32 grid; plus

* ``mlp_phase``: rows (M, D) -> [x +] fc2(GELU(fc1(LN x))) in x's dtype:
  bf16 rows round fc2's output to bf16 before the residual add (the Pallas
  order), f32 rows (the mixed teacher's banded grid) add it in f32 —
  replaces ``_mlp_phase_kernel`` (fused_block.py:1191); the banded block's
  grid MLP (``models/banded.py``) and the training path's MLP phase.

Both ops also have an int8 tier (W8A8, the JAX package's ``ops/quant.py``
scheme on its whole-block kernels' int8 refs), picked by the weights' dtype,
with a bf16 and an f32 block boundary (the int8 teacher under the mixed
teacher: f32 x into ``temporal_phase_tm``, an f32 CLS row into
``spatial_mlp`` and an f32 grid out; launch counters ``*_q8_f32``):
``block_params`` of a block whose dense layers are quantized
(``models.timesformer.QuantLinear``) carries s8 (out, in) codes and their
f32 scales (``*_s``), and every product runs as s8 x s8 -> s32 on rows
quantized per row just before it; LN, the attention and GELU stay float.
Its blocks have wrappers of their own: ``ln_quant_rows`` (LN, bf16
rounding, row quantization), ``quant_rows`` (bf16 rows to codes) and
``gemm_s8`` (the s8 wgmma GEMM with the dequantizing epilogue), plain twins
``*_plain``; the first two and the GEMM's f32 output equal their twins bit
for bit on the card. ``divided_block_wb`` takes the CLS row's MLP through
the same math in plain torch (JAX fused_block.py:1694-1706).

The f32 tiers take bf16 matrices and f32 LN weights, as every tier does:
they read their f32 rows straight into LN and add their f32 residual in
the GEMM's epilogue, and stage nothing in f32 but row 2's post-spatial
carry. Each wrapper sizes its workspace from the bytes the library states
for its layout (``dvst_*_ws``), mirrored here (``*_ws``) for the CPU
tests.

The XLA-layout block's per-phase dispatch (the counterpart of JAX
``divided_block(use_fused=True)``, ``models/timesformer.py:278-325``) runs,
over (S, L, D) bf16 sequences in the plain layout:

* ``temporal_phase``: x + fc(proj(MHSA(LN x))) as bf16(x + bf16(fc)) —
  replaces ``_temporal_phase_kernel`` (fused_block.py:642);
* ``attn_phase``: bf16(proj(MHSA(LN x))), no residual — replaces
  ``_attn_phase_kernel`` (fused_block.py:188);

and ``mlp_phase`` for the feed-forward half. ``fused_ok`` is the gate.

Every op here and the banded ``spatial_phase_pf`` run their products on
the wgmma + TMA GEMM (``csrc/wgmma_gemm.cuh``); the spatial ops' attention
runs on the tensor-core tile with the CLS row as prefix key, the temporal
ops' on the same tile reading its rows at stride N, ``attn_phase``'s on it
over contiguous sequences (``csrc/tc_attention.cuh``). The three blocks
also have wrappers of their own, ``gemm``, ``spatial_attention`` and
``temporal_attention`` (plain twins ``gemm_plain``,
``spatial_attention_plain``, ``temporal_attention_plain``), through which
the card tests and ``chip_smoke.py`` hold and time them alone; the model
never calls them.

The per-phase training tier (the counterpart of ``divided_block_fused``)
runs three ops per block, each a ``torch.autograd.Function`` that saves
only its inputs and recomputes in its backward, as the JAX custom VJPs do:

* ``TemporalPhaseTm``: ``temporal_phase_tm(..., out_dtype=bf16)``, the
  bf16 tier of the first op, bf16(x + bf16(fc)) as the Pallas kernel
  rounds (fused_block.py:855-857); backward ``temporal_phase_tm_bwd`` —
  replaces ``_temporal_phase_tm_bwd_kernel`` (fused_block.py:963);
* ``SpatialPhase``: ``spatial_phase``, x (B, T, N, D) and cls (B, 1, D)
  bf16 -> (x + bf16(proj(MHSA(LN [cls, x_t]))) over the grid rows, the raw
  per-frame CLS rows in bf16) — replaces ``_spatial_phase_kernel``
  (fused_block.py:287); backward ``spatial_phase_bwd`` — replaces
  ``_spatial_phase_bwd_kernel`` (fused_block.py:430);
* ``MlpPhase``: ``mlp_phase``; backward ``mlp_phase_bwd`` — replaces
  ``_mlp_phase_bwd_kernel`` (fused_block.py:1233).

Each Function takes the f32 master parameters, casts them to the kernels'
layout inside (bf16 matrices, f32 vectors) and returns f32 gradients in
the parameters' (out, in) layout, as JAX's ``f_bwd`` casts them back
(fused_block.py:629-632). The backwards live in ``csrc/fused_block_bwd.cu``.
All three run every product on the wgmma GEMM (the dX and dW products read
their operands as stored), rows 7 and 8 their attention backward on the
tensor-core tile's backward (at stride N for row 7, with the CLS prefix
for row 8), and all three their LayerNorm backward on one kernel; those
blocks have wrappers of their own for the card tests and ``chip_smoke.py``:
``temporal_attention_bwd``, ``spatial_attention_bwd``, ``layer_norm_bwd``,
``gemm_dx``, ``gemm_dw`` and ``gemm_gelu_grad`` (plain twins ``*_plain``).

The same three Functions on f32 x are the trainer's mixed tier (the
counterpart of ``divided_block_fused`` at f32: f32 activations and
carries, bf16 matmul operands): ``TemporalPhaseTm`` runs row 1's f32 tier
(1f), ``SpatialPhase`` row 4's (4f: f32 x and CLS row in, f32 grid and CLS
rows out), ``MlpPhase`` row 3's (3f); their backwards read f32 x and f32
cotangents and write f32 dx (7f, 8f, 9f): the recompute's LN and the
LayerNorm backward read the f32 rows, the incoming cotangent enters the
products as its bf16 copy and its bias gradient and the residual as f32,
and dx is never rounded (JAX fused_block.py:1033, :1276, :1294-1297). The
dtype of x picks the tier; the ops refuse mixed dtypes, and each f32 tier
counts its launches under its own key (``*_f32``).

Each op's wrapper runs its Hopper kernels (``csrc/fused_block.cu``) on a
CUDA tensor and its plain twin (``*_plain``) on a CPU tensor; it raises on
any other device and never falls back. ``launches`` counts the kernel
launches of each wrapper.

Numerics, shared by kernel and twin (the XLA-path rules, not the Pallas
kernels' TPU workarounds): LayerNorm in f32 (eps 1e-6), bf16 matmul
operands with f32 accumulation, qkv rounded to bf16 after the bias,
softmax in f32 with the row max subtracted, probabilities rounded to bf16
before the PV product, exact erf GELU, f32 intra-block carry, block
boundaries in bf16 (or f32, the mixed tier). The Pallas kernels instead clamp logits to +/-80 without the
max, sum the denominator on the MXU through a ones column and use tanh
GELU; the tests bound the resulting gap.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import quant

LN_EPS = 1e-6
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into on sm_90

# Kernel launches per op wrapper (plain twins do not count).
launches: Dict[str, int] = {
    "temporal_phase_tm": 0, "spatial_mlp": 0, "mlp_phase": 0,
    "temporal_phase_tm_f32": 0, "spatial_mlp_f32": 0, "mlp_phase_f32": 0,
    "temporal_phase_tm_bf16": 0, "spatial_phase": 0,
    "temporal_phase_tm_bwd": 0, "spatial_phase_bwd": 0, "mlp_phase_bwd": 0,
    "attn_phase": 0, "temporal_phase": 0, "gemm": 0, "spatial_attention": 0,
    "temporal_attention": 0, "spatial_attention_bwd": 0, "gemm_dx": 0,
    "gemm_dw": 0, "gemm_gelu_grad": 0, "temporal_attention_bwd": 0,
    "layer_norm_bwd": 0, "temporal_phase_tm_q8": 0, "spatial_mlp_q8": 0,
    "gemm_s8": 0, "quant_rows": 0, "ln_quant_rows": 0,
    # the int8 tier's f32 tier (the int8 teacher under the mixed teacher)
    "temporal_phase_tm_q8_f32": 0, "spatial_mlp_q8_f32": 0,
    # the f32 tiers of the trainer's mixed tier
    "spatial_phase_f32": 0, "temporal_phase_tm_bwd_f32": 0, "spatial_phase_bwd_f32": 0,
    "mlp_phase_bwd_f32": 0, "layer_norm_bwd_f32": 0}

# The int8 tier's launches of its three kernels per call of rows 1 and 2
# (the LN + quantize, the row quantize, the s8 GEMM), in either of its
# tiers: each op's wrapper adds them to those kernels' counters, so the
# counters count every launch of the three kernels, alone or inside the
# ops.
Q8_LAUNCHES = {
    "temporal_phase_tm_q8": {"ln_quant_rows": 1, "quant_rows": 2, "gemm_s8": 3},
    "spatial_mlp_q8": {"ln_quant_rows": 3, "quant_rows": 3, "gemm_s8": 6},
}
Q8_LAUNCHES.update({f"{op}_f32": n for op, n in Q8_LAUNCHES.items()})

# The wgmma GEMM's epilogues (csrc: dvst_common.cuh's Epi): name -> (code,
# the residual's dtype or None, the output's dtype).
GEMM_EPILOGUES = {
    "bf16": (0, None, torch.bfloat16),                     # bf16(acc + b)
    "gelu_bf16": (1, None, torch.bfloat16),                # bf16(gelu(acc + b))
    "res_bf16_f32": (2, torch.bfloat16, torch.float32),    # res + (acc + b)
    "res_f32_f32": (3, torch.float32, torch.float32),      # res + (acc + b)
    "f32": (4, None, torch.float32),                       # acc + b
    "res_f32_bf16": (5, torch.float32, torch.bfloat16),    # bf16(res + (acc + b))
    "add_bf16": (6, torch.bfloat16, torch.bfloat16),       # bf16(res + bf16(acc + b))
}

# The dX GEMM's epilogues (no bias): name -> (code, the aux's dtype or None,
# the output's dtype).
GEMM_DX_EPILOGUES = {
    "bf16": (0, None, torch.bfloat16),                     # bf16(acc)
    "f32": (4, None, torch.float32),                       # acc
    "mul_f32_bf16": (7, torch.float32, torch.bfloat16),    # bf16(aux * acc)
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


TEMPORAL_KEYS = ("ln_w", "ln_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "fc_w", "fc_b")
SPATIAL_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
MLP_KEYS = ("ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
SPATIAL_PHASE_KEYS = SPATIAL_KEYS[:6]
_MATRICES = ("qkv_w", "proj_w", "fc_w", "fc1_w", "fc2_w")
# the int8 tier's: each s8 matrix followed by its f32 scales
TEMPORAL_Q8_KEYS = ("ln_w", "ln_b", "qkv_w", "qkv_s", "qkv_b", "proj_w", "proj_s",
                    "proj_b", "fc_w", "fc_s", "fc_b")
SPATIAL_Q8_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_s", "qkv_b", "proj_w", "proj_s",
                   "proj_b", "ln2_w", "ln2_b", "fc1_w", "fc1_s", "fc1_b", "fc2_w",
                   "fc2_s", "fc2_b")


def block_params(block) -> dict:
    """Kernel-layout weights of one ``models.timesformer.Block``: bf16
    (out, in) matrices and f32 vectors, for both ops; for a quantized block
    (its dense layers ``QuantLinear``) the s8 codes as the matrices and
    their f32 scales under ``*_s``."""
    def mat(lin):
        if lin.weight.dtype == torch.int8:
            return lin.weight.detach().contiguous()
        return lin.weight.detach().to(torch.bfloat16).contiguous()

    def vec(t):
        return t.detach().float().contiguous()

    def bias(lin):
        if lin.bias is None:
            return torch.zeros(lin.out_features, dtype=torch.float32,
                               device=lin.weight.device)
        return vec(lin.bias)

    ta, sa = block.temporal_attn, block.attn
    out = {
        "temporal": {
            "ln_w": vec(block.temporal_norm1.weight),
            "ln_b": vec(block.temporal_norm1.bias),
            "qkv_w": mat(ta.qkv), "qkv_b": bias(ta.qkv),
            "proj_w": mat(ta.proj), "proj_b": bias(ta.proj),
            "fc_w": mat(block.temporal_fc), "fc_b": bias(block.temporal_fc),
        },
        "spatial": {
            "ln1_w": vec(block.norm1.weight), "ln1_b": vec(block.norm1.bias),
            "qkv_w": mat(sa.qkv), "qkv_b": bias(sa.qkv),
            "proj_w": mat(sa.proj), "proj_b": bias(sa.proj),
            "ln2_w": vec(block.norm2.weight), "ln2_b": vec(block.norm2.bias),
            "fc1_w": mat(block.mlp.fc1), "fc1_b": bias(block.mlp.fc1),
            "fc2_w": mat(block.mlp.fc2), "fc2_b": bias(block.mlp.fc2),
        },
    }
    if block.mlp.fc1.weight.dtype == torch.int8:
        for half, layers in (("temporal", {"qkv": ta.qkv, "proj": ta.proj,
                                           "fc": block.temporal_fc}),
                             ("spatial", {"qkv": sa.qkv, "proj": sa.proj,
                                          "fc1": block.mlp.fc1,
                                          "fc2": block.mlp.fc2})):
            for name, lin in layers.items():
                out[half][f"{name}_s"] = vec(lin.qscale)
    return out


def is_q8(p: dict) -> bool:
    """Whether kernel-layout weights (one half of ``block_params``) are the
    int8 tier's."""
    return p["qkv_w"].dtype == torch.int8


# ---------------------------------------------------------------------------
# Plain twins (the kernels' arithmetic in torch)
# ---------------------------------------------------------------------------

def _ln(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm of f32 rows (biased variance)."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * w + b


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: a (..., K) @ w (N, K)^T -> f32."""
    return torch.matmul(a.float(), w.float().t())


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v (..., L, hd) -> (..., L, hd) in q's dtype: f32 scores (scale
    hd^-0.5 unless given), row max subtracted, probabilities rounded to
    bf16 for PV, f32 denominator."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e.to(torch.bfloat16).float()
    o = torch.matmul(p, v.float()) / e.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """(M, V, 32) -> (M, 1): ln_quant_kernel's sum of a row held by a warp,
    lane l's values t[:, i, l] added in order of i, then the lanes' sums
    added in a xor butterfly (16, 8, 4, 2, 1); every lane ends with the
    same sum."""
    s = t[:, 0]
    for i in range(1, t.shape[1]):
        s = s + t[:, i]
    lane = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, :1]


def _ln_lanes(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm of f32 rows (M, D) as ln_quant_kernel computes it, step
    for step and rounding for rounding: value i of lane l is x[l + 32 i];
    mean = sum / D, var = sum((x - mean)^2) / D, ((x - mean) * (1 /
    sqrt(var + eps))) * w + b."""
    M, D = xf.shape
    v = xf.reshape(M, D // 32, 32)
    c = v - quant.div_ieee(_lane_sum(v), D)[:, :, None]
    var = quant.div_ieee(_lane_sum(c * c), D)
    rs = torch.ones_like(var) / torch.sqrt(var + LN_EPS)
    return (c * rs[:, :, None] * w.reshape(-1, 32) + b.reshape(-1, 32)).reshape(M, D)


def quant_rows_plain(x: torch.Tensor):
    """Plain twin of ``quant_rows``: rows (M, D) -> (s8 codes (M, D), f32
    scales (M,))."""
    return quant.quant_rows(x)


def ln_quant_rows_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain twin of ``ln_quant_rows``: the kernel's LayerNorm of rows (M,
    D), rounded to bf16, quantized per row."""
    return quant.quant_rows(_ln_lanes(x.float(), w, b).to(torch.bfloat16))


def _epilogue(v: torch.Tensor, epi: str, res: Optional[torch.Tensor]) -> torch.Tensor:
    """GEMM_EPILOGUES' ``epi`` of the f32 sums v (bias added)."""
    if epi == "gelu_bf16":
        return F.gelu(v).to(torch.bfloat16)
    if epi == "add_bf16":
        return (res.float() + v.to(torch.bfloat16).float()).to(torch.bfloat16)
    if res is not None:  # res_f32_f32, res_f32_bf16, res_bf16_f32
        v = res.float() + v
    return v.to(GEMM_EPILOGUES[epi][2])


def gemm_s8_plain(a_q: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                  sw: torch.Tensor, bias: torch.Tensor, epi: str,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of ``gemm_s8``: ``epi`` of f32(a_q @ w_q^T) * sx[row] *
    sw[col] + bias, the integer sums exact (``quant.s8_product``), each
    step rounded as the kernel rounds it."""
    v = quant.s8_product(a_q, w_q) * sx[:, None] * sw + bias
    return _epilogue(v, epi, res)


def _temporal_phase_tm_q8_plain(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """Row 1's int8 tier in torch: the chain of its blocks' twins; bf16 x
    (row 1q) or f32 x (row 1qf: LN on the f32 rows, the f32 residual)."""
    B, T, N, D = x.shape
    M = B * T * N
    q, sx = ln_quant_rows_plain(x.reshape(M, D), p["ln_w"], p["ln_b"])
    qkv = gemm_s8_plain(q, sx, p["qkv_w"], p["qkv_s"], p["qkv_b"], "bf16")
    a = temporal_attention_plain(qkv.reshape(B, T, N, 3 * D), num_heads)
    q, sx = quant_rows_plain(a.reshape(M, D))
    proj = gemm_s8_plain(q, sx, p["proj_w"], p["proj_s"], p["proj_b"], "bf16")
    q, sx = quant_rows_plain(proj)
    out = gemm_s8_plain(q, sx, p["fc_w"], p["fc_s"], p["fc_b"],
                        "res_f32_f32" if x.dtype == torch.float32 else "res_bf16_f32",
                        x.reshape(M, D))
    return out.reshape(B, T, N, D)


def temporal_phase_tm_plain(x: torch.Tensor, p: dict, num_heads: int,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of ``temporal_phase_tm`` (every tier)."""
    if is_q8(p):
        return _temporal_phase_tm_q8_plain(x, p, num_heads)
    xf = x.float()
    y = _ln(xf, p["ln_w"], p["ln_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    a = temporal_attention_plain(qkv, num_heads)
    proj = (_mm(a, p["proj_w"]) + p["proj_b"]).to(torch.bfloat16)
    fc = _mm(proj, p["fc_w"]) + p["fc_b"]
    if out_dtype == torch.bfloat16:
        return (xf + fc.to(torch.bfloat16).float()).to(torch.bfloat16)
    return xf + fc


def temporal_attention_plain(qkv: torch.Tensor, num_heads: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``temporal_attention``: qkv (B, T, N, 3D) -> (B, T, N,
    D), sequence (b, n) the T rows qkv[b, :, n]."""
    B, T, N, D3 = qkv.shape
    H = num_heads
    # (B, T, N, 3, H, hd) -> (3, B, N, H, T, hd): sequences over T per position
    q, k, v = qkv.reshape(B, T, N, 3, H, D3 // 3 // H).permute(
        3, 0, 2, 4, 1, 5).unbind(0)
    a = _attention(q, k, v) if scale is None else _attention(q, k, v, scale)
    return a.permute(0, 3, 1, 2, 4).reshape(B, T, N, D3 // 3)


def _spatial_mlp_q8_plain(x1: torch.Tensor, cls: torch.Tensor, p: dict,
                          num_heads: int):
    """Row 2's int8 tier in torch: the chain of its blocks' twins; a bf16
    CLS row and grid out (row 2q), or f32 ones (row 2qf)."""
    B, T, N, D = x1.shape
    M = B * T * N
    x1r = x1.reshape(M, D)
    q, sx = ln_quant_rows_plain(x1r, p["ln1_w"], p["ln1_b"])
    qc, sc = ln_quant_rows_plain(cls.reshape(B, D), p["ln1_w"], p["ln1_b"])
    qkv = gemm_s8_plain(q, sx, p["qkv_w"], p["qkv_s"], p["qkv_b"], "bf16")
    qkv_cls = gemm_s8_plain(qc, sc, p["qkv_w"], p["qkv_s"], p["qkv_b"], "bf16")
    a, a_cls = spatial_attention_plain(qkv.reshape(B * T, N, 3 * D), qkv_cls, num_heads)
    q, sx = quant_rows_plain(a.reshape(M, D))
    x2 = gemm_s8_plain(q, sx, p["proj_w"], p["proj_s"], p["proj_b"], "res_f32_f32", x1r)
    qc, sc = quant_rows_plain(a_cls)
    cls_rows = gemm_s8_plain(qc, sc, p["proj_w"], p["proj_s"], p["proj_b"], "f32")
    q, sx = ln_quant_rows_plain(x2, p["ln2_w"], p["ln2_b"])
    hid = gemm_s8_plain(q, sx, p["fc1_w"], p["fc1_s"], p["fc1_b"], "gelu_bf16")
    q, sx = quant_rows_plain(hid)
    out = gemm_s8_plain(q, sx, p["fc2_w"], p["fc2_s"], p["fc2_b"],
                        "res_f32_f32" if cls.dtype == torch.float32 else "res_f32_bf16", x2)
    return out.reshape(B, T, N, D), cls_rows.reshape(B, T, D)


def spatial_mlp_plain(x1: torch.Tensor, cls: torch.Tensor, p: dict,
                      num_heads: int):
    """Plain twin of ``spatial_mlp`` (every tier)."""
    if is_q8(p):
        return _spatial_mlp_q8_plain(x1, cls, p, num_heads)
    B, T, N, D = x1.shape
    H = num_heads
    hd = D // H
    L = N + 1
    seq = torch.cat([cls.float().reshape(B, 1, 1, D).expand(B, T, 1, D), x1],
                    dim=2)  # (B, T, L, D) f32
    y = _ln(seq, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, T, L, 3, H, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)
    a = _attention(q, k, v).transpose(2, 3).reshape(B, T, L, D)
    res = _mm(a, p["proj_w"]) + p["proj_b"]
    cls_rows = res[:, :, 0, :]
    x2 = x1 + res[:, :, 1:, :]
    y2 = _ln(x2, p["ln2_w"], p["ln2_b"]).to(torch.bfloat16)
    h = F.gelu(_mm(y2, p["fc1_w"]) + p["fc1_b"]).to(torch.bfloat16)
    out = x2 + (_mm(h, p["fc2_w"]) + p["fc2_b"])
    return out.to(cls.dtype), cls_rows.contiguous()


def spatial_attention_plain(qkv: torch.Tensor, qkv_prefix: torch.Tensor,
                            num_heads: int, scale: Optional[float] = None):
    """Plain twin of ``spatial_attention``: sequence s is [qkv_prefix row
    s // (S / P), qkv[s]]; returns (grid outputs (S, N, D), prefix outputs
    (S, D))."""
    S, N, D3 = qkv.shape
    D, H = D3 // 3, num_heads
    pre = qkv_prefix.repeat_interleave(S // qkv_prefix.shape[0], dim=0)
    seq = torch.cat([pre[:, None], qkv], dim=1)  # (S, 1 + N, 3D)
    q, k, v = seq.reshape(S, N + 1, 3, H, D // H).permute(2, 0, 3, 1, 4).unbind(0)
    a = _attention(q, k, v, scale).transpose(1, 2).reshape(S, N + 1, D)
    return a[:, 1:].contiguous(), a[:, 0].contiguous()


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epi: str,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of ``gemm``: ``epi`` of GEMM_EPILOGUES applied to a @ w^T +
    bias (bf16 operands, f32 accumulation)."""
    return _epilogue(_mm(a, w) + bias, epi, res)


def mlp_phase_plain(x: torch.Tensor, p: dict, residual: bool = True) -> torch.Tensor:
    """Plain twin of ``mlp_phase`` (both tiers: fc2's output in x's dtype,
    then the residual added in f32 and the sum in x's dtype)."""
    xf = x.float()
    y = _ln(xf, p["ln2_w"], p["ln2_b"]).to(torch.bfloat16)
    h = F.gelu(_mm(y, p["fc1_w"]) + p["fc1_b"]).to(torch.bfloat16)
    out = (_mm(h, p["fc2_w"]) + p["fc2_b"]).to(x.dtype)
    if residual:
        out = (xf + out.float()).to(x.dtype)
    return out


def spatial_phase_plain(x: torch.Tensor, cls: torch.Tensor, p: dict,
                        num_heads: int, out_dtype: Optional[torch.dtype] = None):
    """Plain twin of ``spatial_phase`` (every tier)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    B, T, N, D = x.shape
    H = num_heads
    hd = D // H
    L = N + 1
    seq = torch.cat([cls.reshape(B, 1, 1, D).expand(B, T, 1, D), x],
                    dim=2).float()  # (B, T, L, D)
    y = _ln(seq, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, T, L, 3, H, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)
    a = _attention(q, k, v).transpose(2, 3).reshape(B, T, L, D)
    res = _mm(a, p["proj_w"]) + p["proj_b"]
    cls_rows = res[:, :, 0, :].to(x.dtype).contiguous()
    if out_dtype == torch.float32:
        return x.float() + res[:, :, 1:, :], cls_rows
    grid = (x.float() + res[:, :, 1:, :].to(torch.bfloat16).float()).to(torch.bfloat16)
    return grid, cls_rows


def attn_phase_plain(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """Plain twin of ``attn_phase``."""
    S, L, D = x.shape
    H = num_heads
    y = _ln(x.float(), p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    q, k, v = qkv.reshape(S, L, 3, H, D // H).permute(2, 0, 3, 1, 4).unbind(0)
    a = _attention(q, k, v).transpose(1, 2).reshape(S, L, D)
    return (_mm(a, p["proj_w"]) + p["proj_b"]).to(torch.bfloat16)


def temporal_phase_plain(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """Plain twin of ``temporal_phase``: the bf16 tier of
    ``temporal_phase_tm`` with each sequence as one position (N = 1)."""
    S, L, D = x.shape
    return temporal_phase_tm_plain(x.reshape(S, L, 1, D), p, num_heads,
                                   torch.bfloat16).reshape(S, L, D)


# Backward twins: the kernels' arithmetic, rounded at the Pallas backward's
# bf16 points (dproj, da, ds, dqkv, dh1 and the recomputed activations),
# f32 sums and an f32 LayerNorm backward; the planted-fault tests replace
# ``_attention_bwd``, ``_dw`` and ``_sum_frames``.

def _attention_probs(q: torch.Tensor, k: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The backward's recompute: bf16(softmax(q k^T * scale)) (scale
    hd^-0.5 unless given), row max subtracted, exact division."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def _attention_bwd(q, k, v, da, scale: Optional[float] = None):
    """q, k, v, da (..., L, hd) bf16 -> (dq, dk, dv) bf16, at logit scale
    ``scale`` (hd^-0.5 unless given)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    pf = _attention_probs(q, k, scale).float()
    daf = da.float()
    dv = torch.matmul(pf.transpose(-2, -1), daf).to(torch.bfloat16)
    dp = torch.matmul(daf, v.float().transpose(-2, -1))
    ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True)) * scale
    ds = ds.to(torch.bfloat16).float()
    dq = torch.matmul(ds, k.float()).to(torch.bfloat16)
    dk = torch.matmul(ds.transpose(-2, -1), q.float()).to(torch.bfloat16)
    return dq, dk, dv


def _dw(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weight gradient in the (out, in) layout: dy (rows, out)^T x (rows,
    in), bf16 operands, f32 sums."""
    return torch.matmul(dy.float().t(), x.float())


def spatial_attention_bwd_plain(qkv: torch.Tensor, qkv_prefix: torch.Tensor,
                                da: torch.Tensor, da_prefix: torch.Tensor,
                                num_heads: int, scale: Optional[float] = None):
    """Plain twin of ``spatial_attention_bwd``: sequence s is [qkv_prefix row
    s // (S / P), qkv[s]] with cotangent rows [da_prefix[s], da[s]];
    returns (dqkv (S, N, 3D), dqkv_prefix (S, 3D)), dq | dk | dv, bf16."""
    S, N, D3 = qkv.shape
    D, H = D3 // 3, num_heads
    pre = qkv_prefix.repeat_interleave(S // qkv_prefix.shape[0], dim=0)
    seq = torch.cat([pre[:, None], qkv], dim=1)  # (S, L, 3D)
    q, k, v = seq.reshape(S, N + 1, 3, H, D // H).permute(2, 0, 3, 1, 4).unbind(0)
    dseq = torch.cat([da_prefix[:, None], da], dim=1)
    da_h = dseq.reshape(S, N + 1, H, D // H).transpose(1, 2)  # (S, H, L, hd)
    g = torch.stack(_attention_bwd(q, k, v, da_h) if scale is None
                    else _attention_bwd(q, k, v, da_h, scale))  # (3, S, H, L, hd)
    g = g.permute(1, 3, 0, 2, 4).reshape(S, N + 1, D3)
    return g[:, 1:].contiguous(), g[:, 0].contiguous()


def gemm_dx_plain(dy: torch.Tensor, w: torch.Tensor, epi: str,
                  aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of ``gemm_dx``: ``epi`` of GEMM_DX_EPILOGUES applied to dy
    @ w, w an (out, in) weight (bf16 operands, f32 accumulation)."""
    v = _mm(dy, w.t())
    if epi == "mul_f32_bf16":
        v = v * aux
    return v.to(GEMM_DX_EPILOGUES[epi][2])


def gemm_dw_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``gemm_dw``: dy^T x in f32."""
    return _dw(dy, x)


def gemm_gelu_grad_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Plain twin of ``gemm_gelu_grad``: (bf16(gelu(h)), gelu'(h)) of h = a
    @ w^T + bias in f32."""
    h = _mm(a, w) + bias
    return F.gelu(h).to(torch.bfloat16), _gelu_grad(h)


def _ln_bwd(xf: torch.Tensor, dy: torch.Tensor, w: torch.Tensor):
    """f32 LayerNorm backward over the last axis: (dx, dscale, dbias)."""
    D = xf.shape[-1]
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (xf - mu) * rstd
    dxh = dy * w
    dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                 - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    return (dx, (dy * xhat).reshape(-1, D).sum(0), dy.reshape(-1, D).sum(0))


def layer_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                         res: Optional[torch.Tensor] = None,
                         x_tail: Optional[torch.Tensor] = None, tail_div: int = 1):
    """Plain twin of ``layer_norm_bwd``: ``_ln_bwd`` over the M rows of x and
    then each x_tail row tail_div times; returns (dx (M, D) in x's dtype =
    dx + res, rounded once, the tail rows' dx (P * tail_div, D) f32 or
    None, dscale, dbias f32)."""
    M = x.shape[0]
    xf = x.float()
    if x_tail is not None:
        xf = torch.cat([xf, x_tail.float().repeat_interleave(tail_div, dim=0)])
    dx, dscale, dbias = _ln_bwd(xf, dy, w)
    grid = dx[:M] if res is None else dx[:M] + res.float()
    return (grid.to(x.dtype), None if x_tail is None else dx[M:].contiguous(),
            dscale, dbias)


def _sum_frames(t: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, 1, D): the CLS row's gradient over its frames."""
    return t.sum(dim=1, keepdim=True)


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """Derivative of the exact erf GELU."""
    return (0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
            + h * 0.3989422804014327 * torch.exp(-0.5 * h * h))


def temporal_attention_bwd_plain(qkv: torch.Tensor, da: torch.Tensor, num_heads: int,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``temporal_attention_bwd``: qkv (B, T, N, 3D) and da (B,
    T, N, D) -> dqkv (B, T, N, 3D) bf16 (dq | dk | dv), sequence (b, n) the
    T rows at qkv[b, :, n], through ``_attention_bwd``."""
    B, T, N, D3 = qkv.shape
    H = num_heads
    hd = D3 // 3 // H
    # (B, T, N, 3, H, hd) -> (3, B, N, H, T, hd): sequences over T per position
    q, k, v = qkv.reshape(B, T, N, 3, H, hd).permute(3, 0, 2, 4, 1, 5).unbind(0)
    da = da.reshape(B, T, N, H, hd).permute(0, 2, 3, 1, 4)  # (B, N, H, T, hd)
    g = torch.stack(_attention_bwd(q, k, v, da) if scale is None
                    else _attention_bwd(q, k, v, da, scale))  # (3, B, N, H, T, hd)
    return g.permute(1, 4, 2, 0, 3, 5).reshape(B, T, N, D3)


def temporal_phase_tm_bwd_plain(x: torch.Tensor, dout: torch.Tensor, p: dict,
                                num_heads: int):
    """Plain twin of ``temporal_phase_tm_bwd`` (both tiers): its blocks' twins
    chained, as the kernel chains the blocks. The incoming cotangent enters
    the products as its bf16 copy and the bias gradient and the residual as
    read (f32 in the f32 tier)."""
    B, T, N, D = x.shape
    M = B * T * N
    y = _ln(x.float(), p["ln_w"], p["ln_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    a = temporal_attention_plain(qkv, num_heads).reshape(M, D)
    proj = (_mm(a, p["proj_w"]) + p["proj_b"]).to(torch.bfloat16)
    g = {}
    dfc = dout.reshape(M, D)
    dfc16 = dfc.to(torch.bfloat16)
    g["fc_w"], g["fc_b"] = gemm_dw_plain(dfc16, proj), dfc.float().sum(0)
    dproj = gemm_dx_plain(dfc16, p["fc_w"], "bf16")
    g["proj_w"], g["proj_b"] = gemm_dw_plain(dproj, a), dproj.float().sum(0)
    da = gemm_dx_plain(dproj, p["proj_w"], "bf16")
    dqkv = temporal_attention_bwd_plain(qkv, da.reshape(B, T, N, D), num_heads).reshape(M, 3 * D)
    g["qkv_w"], g["qkv_b"] = gemm_dw_plain(dqkv, y.reshape(M, D)), dqkv.float().sum(0)
    dy = gemm_dx_plain(dqkv, p["qkv_w"], "f32")
    dx, _, g["ln_w"], g["ln_b"] = layer_norm_bwd_plain(x.reshape(M, D), dy, p["ln_w"], dfc)
    return dx.reshape(B, T, N, D), {k: g[k] for k in TEMPORAL_KEYS}


def spatial_phase_bwd_plain(x: torch.Tensor, cls: torch.Tensor,
                            dgo: torch.Tensor, dco: torch.Tensor, p: dict,
                            num_heads: int):
    """Plain twin of ``spatial_phase_bwd`` (both tiers; the cotangents as in
    ``temporal_phase_tm_bwd_plain``)."""
    B, T, N, D = x.shape
    H = num_heads
    hd = D // H
    L = N + 1
    seq = torch.cat([cls.reshape(B, 1, 1, D).expand(B, T, 1, D), x],
                    dim=2).float()
    y = _ln(seq, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (_mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, T, L, 3, H, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)
    a = _attention(q, k, v).transpose(2, 3).reshape(-1, D)
    g = {}
    dproj = torch.cat([dco.reshape(B, T, 1, D), dgo], dim=2).reshape(-1, D)
    dproj16 = dproj.to(torch.bfloat16)
    g["proj_w"], g["proj_b"] = _dw(dproj16, a), dproj.float().sum(0)
    da = _mm(dproj16, p["proj_w"].t()).to(torch.bfloat16)
    da = da.reshape(B, T, L, H, hd).transpose(2, 3)  # (B, T, H, L, hd)
    dqkv = torch.stack(_attention_bwd(q, k, v, da))  # (3, B, T, H, L, hd)
    dqkv = dqkv.permute(1, 2, 4, 0, 3, 5).reshape(-1, 3 * D)
    g["qkv_w"], g["qkv_b"] = _dw(dqkv, y.reshape(-1, D)), dqkv.float().sum(0)
    dy = _mm(dqkv, p["qkv_w"].t()).reshape(B, T, L, D)
    dseq, g["ln1_w"], g["ln1_b"] = _ln_bwd(seq, dy, p["ln1_w"])
    dx = (dseq[:, :, 1:, :] + dgo.float()).to(x.dtype)
    dcls = _sum_frames(dseq[:, :, 0, :])
    return dx, dcls, {k: g[k] for k in SPATIAL_PHASE_KEYS}


def mlp_phase_bwd_plain(x: torch.Tensor, do: torch.Tensor, p: dict,
                        residual: bool = True):
    """Plain twin of ``mlp_phase_bwd`` (both tiers; the cotangent as in
    ``temporal_phase_tm_bwd_plain``)."""
    xf = x.float()
    y = _ln(xf, p["ln2_w"], p["ln2_b"]).to(torch.bfloat16)
    hg, gp = gemm_gelu_grad_plain(y, p["fc1_w"], p["fc1_b"])
    g = {}
    do16 = do.to(torch.bfloat16)
    g["fc2_w"], g["fc2_b"] = _dw(do16, hg), do.float().sum(0)
    dh1 = gemm_dx_plain(do16, p["fc2_w"], "mul_f32_bf16", gp)
    g["fc1_w"], g["fc1_b"] = _dw(dh1, y), dh1.float().sum(0)
    dy = _mm(dh1, p["fc1_w"].t())
    dx, g["ln2_w"], g["ln2_b"] = _ln_bwd(xf, dy, p["ln2_w"])
    if residual:
        dx = dx + do.float()
    return dx.to(x.dtype), {k: g[k] for k in MLP_KEYS}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_geometry(D: int, num_heads: int, Dh: int = 0) -> None:
    """The widths the kernels take. Each op's attention checks its own
    shared memory (the tile's, ``check_spatial_attn_smem`` and
    ``check_temporal_attn_smem``; the banded kernels' in
    ``banded_block``)."""
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"D={D} is not divisible by num_heads={num_heads}")
    hd = D // num_heads
    if hd % 16 or hd > 128:
        raise ValueError(f"head dim {hd}: the kernels need hd % 16 == 0 "
                         "and hd <= 128")
    if D % 128 or D > 1024 or Dh % 128:
        raise ValueError(f"D={D}, MLP width {Dh}: the kernels need "
                         "multiples of 128 and D <= 1024")


def fused_ok(x: torch.Tensor, num_heads: Optional[int] = None) -> bool:
    """The gate of the per-phase dispatch (``models/timesformer.py``'s
    phase functions with ``use_fused``), exactly the JAX package's
    ``fused_ok``: bf16 or f32, D % 128 == 0, head dim < 128.
    ``num_heads=None`` asks for the MLP phase, which has no attention. A
    tensor it admits goes to the kernel op, which raises for what the
    kernels cannot take (``_check_geometry``); the f32 ("mixed") tier of
    that dispatch (rows 5 and 6) is not ported, and ``models.timesformer``
    raises for it."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.shape[-1] % 128:
        return False
    return num_heads is None or x.shape[-1] // num_heads < 128


def _device_of(x: torch.Tensor) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def _run(fn, *args) -> None:
    from . import _build

    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed ({err}): {_build.error_string(err)}")


def _check_weights(p: dict, keys, shapes: dict, dev, q8: bool = False) -> None:
    """bf16 matrices (s8 in the int8 tier) and f32 vectors and scales."""
    mat = torch.int8 if q8 else torch.bfloat16
    for k in keys:
        _check_tensor(k, p[k], mat if k in _MATRICES else torch.float32, shapes[k], dev)


def _temporal_shapes(D: int) -> dict:
    return {"ln_w": (D,), "ln_b": (D,), "qkv_w": (3 * D, D), "qkv_b": (3 * D,),
            "proj_w": (D, D), "proj_b": (D,), "fc_w": (D, D), "fc_b": (D,),
            "qkv_s": (3 * D,), "proj_s": (D,), "fc_s": (D,)}


def _spatial_shapes(D: int, Dh: int = 0) -> dict:
    return {"ln1_w": (D,), "ln1_b": (D,), "qkv_w": (3 * D, D),
            "qkv_b": (3 * D,), "proj_w": (D, D), "proj_b": (D,),
            "ln2_w": (D,), "ln2_b": (D,), "fc1_w": (Dh, D), "fc1_b": (Dh,),
            "fc2_w": (D, Dh), "fc2_b": (D,), "qkv_s": (3 * D,), "proj_s": (D,),
            "fc1_s": (Dh,), "fc2_s": (D,)}


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def check_spatial_attn_smem(lib, L: int, hd: int) -> None:
    """Raise if the tile's spatial attention (``lib``'s
    ``dvst_spatial_attn_smem``) cannot hold L rows at head dim hd."""
    need = lib.dvst_spatial_attn_smem(L, hd)
    if need > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd} needs {need} B "
                         f"of shared memory (limit {SMEM_LIMIT})")


def _tc_group(S: int, L: int) -> int:
    """Sequences of L rows a block of the tile takes (tc_attention.cuh's
    tc_group: seven 16-row strips, short sequences packed 16 // L to a
    strip), at most S."""
    group = 7 * (16 // L) if L < 16 else max(1, 7 // -(-L // 16))
    return min(group, S)


def _tc_strips(G: int, L: int) -> int:
    """16-row strips of a block of G sequences of L rows (tc_strips)."""
    return -(-G // (16 // L)) if L < 16 else G * -(-L // 16)


def temporal_attn_smem(S: int, L: int, hd: int, lib=None) -> int:
    """Shared bytes one block of the temporal attention (the tile at stride
    N) needs over S sequences of L rows at head dim hd: ``lib``'s
    ``dvst_temporal_attn_smem`` where given, else its mirror here
    (tc_attention.cuh's tc_group and tc_smem), so that the plain twins on
    the CPU refuse what the kernel refuses (a card test holds the two
    equal)."""
    if lib is not None:
        return lib.dvst_temporal_attn_smem(S, L, hd)
    if S <= 0 or L <= 0:
        return 0
    return 16 + 6 * _tc_group(S, L) * L * hd


def check_temporal_attn_smem(S: int, L: int, hd: int, lib=None) -> None:
    """Raise if one block of the temporal attention cannot hold its
    sequences of L rows at head dim hd (``temporal_attn_smem``)."""
    need = temporal_attn_smem(S, L, hd, lib)
    if need > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd} needs {need} B "
                         f"of shared memory (limit {SMEM_LIMIT})")


def _carve(*nbytes: int) -> int:
    """Bytes of buffers of ``nbytes`` carved one after another from one
    workspace, each from a 256-byte boundary (csrc: dvst_common.cuh's
    Carve)."""
    off = 0
    for n in nbytes:
        off = -(-off // 256) * 256 + n
    return off


def temporal_phase_tm_ws(B: int, T: int, N: int, D: int, lib=None) -> int:
    """Workspace bytes of ``temporal_phase_tm`` (every tier) and, at N = 1,
    of ``temporal_phase``: ``lib``'s ``dvst_temporal_phase_tm_ws`` where
    given, else its mirror here (fused_block.cu's temporal_ws: qkv, the LN
    rows then the proj output, the attention output, all bf16; the f32
    tier stages nothing in f32). A card test holds the two equal."""
    if lib is not None:
        return lib.dvst_temporal_phase_tm_ws(B, T, N, D)
    M = B * T * N
    return _carve(M * 3 * D * 2, M * D * 2, M * D * 2)


def spatial_mlp_ws(B: int, T: int, N: int, D: int, Dh: int, lib=None) -> int:
    """Workspace bytes of ``spatial_mlp`` (every tier): ``lib``'s
    ``dvst_spatial_mlp_ws`` where given, else its mirror here
    (fused_block.cu's spatial_mlp_ws: the grid rows' LN rows, qkv,
    attention output and hidden rows, the CLS rows' LN rows and qkv, the
    per-frame CLS attention outputs, bf16; the post-spatial carry x2, f32)."""
    if lib is not None:
        return lib.dvst_spatial_mlp_ws(B, T, N, D, Dh)
    M = B * T * N
    return _carve(M * D * 2, M * 3 * D * 2, M * D * 2, M * Dh * 2, B * D * 2,
                  B * 3 * D * 2, B * T * D * 2, M * D * 4)


def temporal_phase_tm_q8_ws(B: int, T: int, N: int, D: int, lib=None) -> int:
    """Workspace bytes of ``temporal_phase_tm``'s int8 tier (rows 1q and
    1qf alike: x is read in place, so its dtype leaves the layout as it
    is): ``lib``'s ``dvst_temporal_phase_tm_q8_ws`` where given, else its
    mirror here (fused_block.cu's temporal_q8_ws: the s8 codes and f32
    scales of the rows being quantized, qkv and the attention output,
    bf16)."""
    if lib is not None:
        return lib.dvst_temporal_phase_tm_q8_ws(B, T, N, D)
    M = B * T * N
    return _carve(M * D, M * 4, M * 3 * D * 2, M * D * 2)


def spatial_mlp_q8_ws(B: int, T: int, N: int, D: int, Dh: int, lib=None) -> int:
    """Workspace bytes of ``spatial_mlp``'s int8 tier (rows 2q and 2qf
    alike: the CLS row is read in place, the grid written to ``out``):
    ``lib``'s ``dvst_spatial_mlp_q8_ws`` where given, else its mirror here
    (fused_block.cu's spatial_mlp_q8_ws: the grid rows' codes (up to Dh
    wide) and scales, qkv, attention output and hidden rows; the CLS rows'
    codes and scales, qkv and per-frame attention outputs; the f32 carry
    x2)."""
    if lib is not None:
        return lib.dvst_spatial_mlp_q8_ws(B, T, N, D, Dh)
    M = B * T * N
    return _carve(M * max(D, Dh), M * 4, M * 3 * D * 2, M * D * 2, M * Dh * 2,
                  B * T * D, B * T * 4, B * 3 * D * 2, B * T * D * 2, M * D * 4)


def mlp_phase_ws(M: int, D: int, Dh: int, lib=None) -> int:
    """Workspace bytes of ``mlp_phase`` (both tiers): ``lib``'s
    ``dvst_mlp_phase_ws`` where given, else its mirror here
    (fused_block.cu's mlp_ws: the LN rows and the hidden rows, bf16)."""
    if lib is not None:
        return lib.dvst_mlp_phase_ws(M, D, Dh)
    return _carve(M * D * 2, M * Dh * 2)


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a 16-byte aligned start")


def _rows_f32(x: torch.Tensor) -> bool:
    """The tier of the training ops, picked by x's dtype: bf16, or f32 (the
    trainer's mixed tier); the op's other row inputs take the same dtype,
    which ``_check_tensor`` holds them to."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x: expected a tensor, got {type(x).__name__}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    return x.dtype == torch.float32


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epi: str,
         res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wgmma GEMM of ``spatial_mlp`` and ``spatial_phase_pf`` alone:
    a (M, K) bf16, w (N, K) bf16, bias (N,) f32 -> ``epi`` (a key of
    GEMM_EPILOGUES) of a @ w^T + bias, (M, N); ``res`` (M, N) for the
    residual epilogues. N % 128 == 0, K % 64 == 0. Kernel on CUDA, plain
    twin on CPU."""
    if epi not in GEMM_EPILOGUES:
        raise ValueError(f"epilogue {epi!r}: one of {sorted(GEMM_EPILOGUES)}")
    code, res_dtype, out_dtype = GEMM_EPILOGUES[epi]
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError("a and w: expected (M, K) and (N, K)")
    (M, K), N = a.shape, w.shape[0]
    dev = _device_of(a)
    if N % 128 or K % 64:
        raise ValueError(f"N={N}, K={K}: the kernel needs N % 128 == 0 and "
                         "K % 64 == 0")
    _check_tensor("a", a, torch.bfloat16, (M, K), dev)
    _check_tensor("w", w, torch.bfloat16, (N, K), dev)
    _check_tensor("bias", bias, torch.float32, (N,), dev)
    if res_dtype is None:
        if res is not None:
            raise ValueError(f"epilogue {epi!r} takes no residual")
    else:
        _check_tensor("res", res, res_dtype, (M, N), dev)
    if dev.type == "cpu":
        return gemm_plain(a, w, bias, epi, res)

    from . import _build

    _check_aligned(a=a, w=w)
    lib = _build.load()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_gemm, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
             None if res is None else res.data_ptr(), out.data_ptr(), M, N, K,
             code, _stream(dev))
    launches["gemm"] += 1
    return out


def _count_q8(op: str) -> None:
    launches[op] += 1
    for k, n in Q8_LAUNCHES[op].items():
        launches[k] += n


def gemm_s8(a_q: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor,
            bias: torch.Tensor, epi: str, res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 tier's s8 wgmma GEMM alone: a_q (M, K) s8 row codes with
    their f32 scales sx (M,), w_q (N, K) s8 channel codes with theirs sw
    (N,), bias (N,) f32 -> ``epi`` (a key of GEMM_EPILOGUES) of f32(a_q @
    w_q^T) * sx[row] * sw[col] + bias, (M, N); ``res`` (M, N) for the
    residual epilogues. N % 128 == 0, K % 128 == 0. Kernel on CUDA, plain
    twin on CPU."""
    if epi not in GEMM_EPILOGUES:
        raise ValueError(f"epilogue {epi!r}: one of {sorted(GEMM_EPILOGUES)}")
    code, res_dtype, out_dtype = GEMM_EPILOGUES[epi]
    if a_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError("a_q and w_q: expected (M, K) and (N, K)")
    (M, K), N = a_q.shape, w_q.shape[0]
    dev = _device_of(a_q)
    if N % 128 or K % 128:
        raise ValueError(f"N={N}, K={K}: the kernel needs N % 128 == 0 and "
                         "K % 128 == 0")
    _check_tensor("a_q", a_q, torch.int8, (M, K), dev)
    _check_tensor("sx", sx, torch.float32, (M,), dev)
    _check_tensor("w_q", w_q, torch.int8, (N, K), dev)
    _check_tensor("sw", sw, torch.float32, (N,), dev)
    _check_tensor("bias", bias, torch.float32, (N,), dev)
    if res_dtype is None:
        if res is not None:
            raise ValueError(f"epilogue {epi!r} takes no residual")
    else:
        _check_tensor("res", res, res_dtype, (M, N), dev)
    if dev.type == "cpu":
        return gemm_s8_plain(a_q, sx, w_q, sw, bias, epi, res)

    from . import _build

    _check_aligned(a_q=a_q, w_q=w_q, sw=sw, bias=bias)
    lib = _build.load()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_gemm_s8, a_q.data_ptr(), sx.data_ptr(), w_q.data_ptr(),
             sw.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(),
             out.data_ptr(), M, N, K, code, _stream(dev))
    launches["gemm_s8"] += 1
    return out


def quant_rows(x: torch.Tensor):
    """The int8 tier's row quantization alone: bf16 rows (M, D) -> (s8
    codes (M, D), f32 scales (M,)), D % 128 == 0. Kernel on CUDA, plain twin
    on CPU."""
    if x.dim() != 2 or x.shape[1] % 128:
        raise ValueError(f"x: expected (M, D) with D % 128 == 0, got {tuple(x.shape)}")
    M, D = x.shape
    dev = _device_of(x)
    _check_tensor("x", x, torch.bfloat16, x.shape, dev)
    if dev.type == "cpu":
        return quant_rows_plain(x)

    from . import _build

    _check_aligned(x=x)
    lib = _build.load()
    q = torch.empty((M, D), dtype=torch.int8, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_quant_rows, x.data_ptr(), q.data_ptr(), sx.data_ptr(), M, D,
             _stream(dev))
    launches["quant_rows"] += 1
    return q, sx


def ln_quant_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The int8 tier's LayerNorm + row quantization alone: rows (M, D), bf16
    or f32 -> (s8 codes (M, D), f32 scales (M,)) of bf16(LN(x)), D % 128
    == 0 and D <= 1024. Kernel on CUDA, plain twin on CPU."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (M, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    M, D = x.shape
    if D % 128 or D > 1024:
        raise ValueError(f"D={D}: the kernel needs D % 128 == 0 and D <= 1024")
    dev = _device_of(x)
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_tensor("w", w, torch.float32, (D,), dev)
    _check_tensor("b", b, torch.float32, (D,), dev)
    if dev.type == "cpu":
        return ln_quant_rows_plain(x, w, b)

    from . import _build

    lib = _build.load()
    q = torch.empty((M, D), dtype=torch.int8, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_ln_quant_rows, x.data_ptr(), w.data_ptr(), b.data_ptr(),
             q.data_ptr(), sx.data_ptr(), M, D, int(x.dtype == torch.float32),
             _stream(dev))
    launches["ln_quant_rows"] += 1
    return q, sx


def spatial_attention(qkv: torch.Tensor, qkv_prefix: torch.Tensor,
                      num_heads: int, scale: Optional[float] = None,
                      prefix_out: bool = True):
    """The spatial attention of ``spatial_mlp`` and ``spatial_phase_pf``
    alone: qkv (S, N, 3D) bf16 grid rows, qkv_prefix (P, 3D) bf16 with S % P
    == 0; sequence s is [qkv_prefix row s // (S / P), qkv[s]] -> (grid
    outputs (S, N, D) bf16, prefix outputs (S, D) bf16, or None without
    ``prefix_out``), at logit scale ``scale`` (hd^-0.5 unless given).
    Kernel on CUDA, plain twin on CPU."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (S, N, 3D), got {tuple(qkv.shape)}")
    S, N, D3 = qkv.shape
    D = D3 // 3
    dev = _device_of(qkv)
    _check_geometry(D, num_heads)
    _check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    P = qkv_prefix.shape[0] if qkv_prefix.dim() == 2 else 0
    if P == 0 or S % P:
        raise ValueError(f"qkv_prefix: expected (P, {D3}) with {S} % P == 0, "
                         f"got {tuple(qkv_prefix.shape)}")
    _check_tensor("qkv_prefix", qkv_prefix, torch.bfloat16, (P, D3), dev)
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    if dev.type == "cpu":
        out, out_pre = spatial_attention_plain(qkv, qkv_prefix, num_heads, scale)
        return out, (out_pre if prefix_out else None)

    from . import _build

    _check_aligned(qkv=qkv, qkv_prefix=qkv_prefix)
    lib = _build.load()
    check_spatial_attn_smem(lib, N + 1, hd)
    out = torch.empty((S, N, D), dtype=torch.bfloat16, device=dev)
    out_pre = (torch.empty((S, D), dtype=torch.bfloat16, device=dev)
               if prefix_out else None)
    with torch.cuda.device(dev):
        _run(lib.dvst_spatial_attn, qkv.data_ptr(), qkv_prefix.data_ptr(),
             out.data_ptr(), None if out_pre is None else out_pre.data_ptr(),
             S, S // P, N, D, num_heads, float(scale), _stream(dev))
    launches["spatial_attention"] += 1
    return out, out_pre


def temporal_attention(qkv: torch.Tensor, num_heads: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The temporal attention of ``temporal_phase_tm`` and
    ``temporal_phase`` alone: qkv (B, T, N, 3D) bf16 -> (B, T, N, D) bf16,
    sequence (b, n) the T rows qkv[b, :, n] (rows (b*T + t)*N + n of the
    flat buffer), at logit scale ``scale`` (hd^-0.5 unless given). Kernel
    on CUDA, plain twin on CPU."""
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (B, T, N, 3D), got {tuple(qkv.shape)}")
    B, T, N, D3 = qkv.shape
    D = D3 // 3
    dev = _device_of(qkv)
    _check_geometry(D, num_heads)
    _check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    if dev.type == "cpu":
        check_temporal_attn_smem(B * N, T, hd)
        return temporal_attention_plain(qkv, num_heads, scale)

    from . import _build

    _check_aligned(qkv=qkv)
    lib = _build.load()
    check_temporal_attn_smem(B * N, T, hd, lib)
    out = torch.empty((B, T, N, D), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_temporal_attn, qkv.data_ptr(), out.data_ptr(), B, T, N, D,
             num_heads, float(scale), _stream(dev))
    launches["temporal_attention"] += 1
    return out


def temporal_phase_tm(x: torch.Tensor, p: dict, num_heads: int,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (B, T, N, D) frame-major -> x + temporal_fc(proj(MHSA over T
    (LN x))) as (B, T, N, D) ``out_dtype``. Three tiers: bf16 x with f32
    out (the whole-block tier's carry) or bf16 out (the per-phase tier,
    bf16(x + bf16(fc))); f32 x with f32 out (the mixed teacher's block
    boundary: LN on the f32 rows, the residual added in f32). With s8
    weights (``block_params`` of a quantized block) the int8 tier, f32 out:
    bf16 x, or f32 x (its f32 tier, the int8 teacher under the mixed
    teacher: LN on the f32 rows, the f32 residual). Kernel on CUDA, plain
    twin on CPU."""
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, N, D), got {tuple(x.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: f32 or bf16")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    x_f32 = x.dtype == torch.float32
    if x_f32 and out_dtype != torch.float32:
        raise TypeError("x: f32 rows are the mixed tier, which writes f32")
    q8 = is_q8(p)
    if q8 and out_dtype != torch.float32:
        raise TypeError("the int8 tier writes the f32 carry")
    B, T, N, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_weights(p, TEMPORAL_Q8_KEYS if q8 else TEMPORAL_KEYS, _temporal_shapes(D),
                   dev, q8)
    if dev.type == "cpu":
        check_temporal_attn_smem(B * N, T, D // num_heads)
        return temporal_phase_tm_plain(x, p, num_heads, out_dtype)

    from . import _build

    _check_aligned(x=x, qkv_w=p["qkv_w"], proj_w=p["proj_w"], fc_w=p["fc_w"])
    lib = _build.load()
    check_temporal_attn_smem(B * N, T, D // num_heads, lib)
    out = torch.empty((B, T, N, D), dtype=out_dtype, device=dev)
    # Scratch is freed on return while the kernels may still run: the
    # caching allocator hands it out again only to later work on this
    # stream, which is the stream the kernels run on.
    if q8:
        _check_aligned(qkv_s=p["qkv_s"], proj_s=p["proj_s"], fc_s=p["fc_s"])
        ws = _ws(temporal_phase_tm_q8_ws(B, T, N, D, lib), dev)
        with torch.cuda.device(dev):
            _run(lib.dvst_temporal_phase_tm_q8, x.data_ptr(),
                 *(p[k].data_ptr() for k in TEMPORAL_Q8_KEYS), ws.data_ptr(),
                 out.data_ptr(), B, T, N, D, num_heads, int(x_f32), _stream(dev))
        _count_q8("temporal_phase_tm_q8_f32" if x_f32 else "temporal_phase_tm_q8")
        return out
    ws = _ws(temporal_phase_tm_ws(B, T, N, D, lib), dev)
    bf16_out = out_dtype == torch.bfloat16
    with torch.cuda.device(dev):  # the launch goes to the current device
        _run(lib.dvst_temporal_phase_tm, x.data_ptr(),
             *(p[k].data_ptr() for k in TEMPORAL_KEYS), ws.data_ptr(),
             out.data_ptr(), B, T, N, D, num_heads, int(x_f32), int(bf16_out),
             _stream(dev))
    launches["temporal_phase_tm_f32" if x_f32 else "temporal_phase_tm_bf16"
             if bf16_out else "temporal_phase_tm"] += 1
    return out


def spatial_phase(x: torch.Tensor, cls: torch.Tensor, p: dict, num_heads: int,
                  out_dtype: Optional[torch.dtype] = None):
    """x (B, T, N, D) bf16 frame-major, cls (B, 1, D) bf16 -> (grid (B, T,
    N, D) bf16 = x + bf16(proj(MHSA(LN [cls, x_t])) rows), per-frame CLS
    rows (B, T, D) bf16), with the ``SPATIAL_PHASE_KEYS`` weights of
    ``block_params(...)["spatial"]``. ``out_dtype=torch.float32`` is the
    grid's f32 tier, x + proj with the branch unrounded, from the same
    launches (through which the card's checks hold the branch). f32 x and
    cls are the trainer's mixed tier: LN on the f32 rows, grid = x + proj
    and the CLS rows in f32, nothing rounded (``out_dtype`` None or f32).
    Kernel on CUDA, plain twin on CPU."""
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: bfloat16 or float32")
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, N, D), got {tuple(x.shape)}")
    x_f32 = _rows_f32(x)
    if x_f32 and out_dtype == torch.bfloat16:
        raise TypeError("x: f32 rows are the mixed tier, which writes f32")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    B, T, N, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_tensor("cls", cls, x.dtype, (B, 1, D), dev)
    _check_weights(p, SPATIAL_PHASE_KEYS, _spatial_shapes(D), dev)
    if dev.type == "cpu":
        return spatial_phase_plain(x, cls, p, num_heads, out_dtype)

    from . import _build

    _check_aligned(x=x, cls=cls, qkv_w=p["qkv_w"], proj_w=p["proj_w"])
    lib = _build.load()
    check_spatial_attn_smem(lib, N + 1, D // num_heads)
    out = torch.empty((B, T, N, D), dtype=out_dtype, device=dev)
    cls_rows = torch.empty((B, T, D), dtype=x.dtype, device=dev)
    ws = _ws(lib.dvst_spatial_phase_ws(B, T, N, D), dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_spatial_phase, x.data_ptr(), cls.data_ptr(),
             *(p[k].data_ptr() for k in SPATIAL_PHASE_KEYS), ws.data_ptr(),
             out.data_ptr(), cls_rows.data_ptr(), B, T, N, D, num_heads,
             int(out_dtype == torch.float32), int(x_f32), _stream(dev))
    launches["spatial_phase_f32" if x_f32 else "spatial_phase"] += 1
    return out, cls_rows


def attn_phase(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """x (S, L, D) bf16, S sequences of L rows -> bf16(proj(MHSA(LN x))) as
    (S, L, D) bf16, with the ``SPATIAL_PHASE_KEYS`` weights of
    ``block_params(...)["spatial"]``. Kernel on CUDA, plain twin on CPU."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (S, L, D), got {tuple(x.shape)}")
    S, L, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, torch.bfloat16, x.shape, dev)
    _check_weights(p, SPATIAL_PHASE_KEYS, _spatial_shapes(D), dev)
    if dev.type == "cpu":
        check_temporal_attn_smem(S, L, D // num_heads)
        return attn_phase_plain(x, p, num_heads)

    from . import _build

    _check_aligned(x=x, qkv_w=p["qkv_w"], proj_w=p["proj_w"])
    lib = _build.load()
    check_temporal_attn_smem(S, L, D // num_heads, lib)
    out = torch.empty((S, L, D), dtype=torch.bfloat16, device=dev)
    ws = torch.empty(S * L * 4 * D, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_attn_phase, x.data_ptr(),
             *(p[k].data_ptr() for k in SPATIAL_PHASE_KEYS), ws.data_ptr(),
             out.data_ptr(), S, L, D, num_heads, _stream(dev))
    launches["attn_phase"] += 1
    return out


def temporal_phase(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """x (S, L, D) bf16, S sequences of L rows -> bf16(x + bf16(fc(proj(
    MHSA(LN x))))) as (S, L, D) bf16, with the ``TEMPORAL_KEYS`` weights of
    ``block_params(...)["temporal"]``. Kernel on CUDA, plain twin on CPU."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (S, L, D), got {tuple(x.shape)}")
    S, L, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, torch.bfloat16, x.shape, dev)
    _check_weights(p, TEMPORAL_KEYS, _temporal_shapes(D), dev)
    if dev.type == "cpu":
        check_temporal_attn_smem(S, L, D // num_heads)
        return temporal_phase_plain(x, p, num_heads)

    from . import _build

    _check_aligned(x=x, qkv_w=p["qkv_w"], proj_w=p["proj_w"], fc_w=p["fc_w"])
    lib = _build.load()
    check_temporal_attn_smem(S, L, D // num_heads, lib)
    out = torch.empty((S, L, D), dtype=torch.bfloat16, device=dev)
    ws = _ws(temporal_phase_tm_ws(S, L, 1, D, lib), dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_temporal_phase, x.data_ptr(),
             *(p[k].data_ptr() for k in TEMPORAL_KEYS), ws.data_ptr(),
             out.data_ptr(), S, L, D, num_heads, _stream(dev))
    launches["temporal_phase"] += 1
    return out


def spatial_mlp(x1: torch.Tensor, cls: torch.Tensor, p: dict, num_heads: int):
    """x1 (B, T, N, D) f32 carry, cls (B, 1, D) bf16 or f32 -> (grid (B, T,
    N, D) in cls's dtype, per-frame CLS rows (B, T, D) f32). The block
    boundary's dtype picks the tier: bf16, or f32 for the mixed teacher
    (the CLS row's LN reads it unrounded, the grid is written in f32). With
    s8 weights the int8 tier, in the same two tiers (a bf16 CLS row, or an
    f32 one: the int8 teacher under the mixed teacher). Kernel on CUDA,
    plain twin on CPU."""
    if x1.dim() != 4:
        raise ValueError(f"x1: expected (B, T, N, D), got {tuple(x1.shape)}")
    if cls.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"cls: dtype {cls.dtype}, expected bfloat16 or float32")
    q8 = is_q8(p)
    f32 = cls.dtype == torch.float32
    B, T, N, D = x1.shape
    Dh = p["fc1_w"].shape[0]
    dev = _device_of(x1)
    _check_geometry(D, num_heads, Dh)
    _check_tensor("x1", x1, torch.float32, x1.shape, dev)
    _check_tensor("cls", cls, cls.dtype, (B, 1, D), dev)
    _check_weights(p, SPATIAL_Q8_KEYS if q8 else SPATIAL_KEYS, _spatial_shapes(D, Dh),
                   dev, q8)
    if dev.type == "cpu":
        return spatial_mlp_plain(x1, cls, p, num_heads)

    from . import _build

    _check_aligned(x1=x1, qkv_w=p["qkv_w"], proj_w=p["proj_w"], fc1_w=p["fc1_w"],
                   fc2_w=p["fc2_w"])
    lib = _build.load()
    check_spatial_attn_smem(lib, N + 1, D // num_heads)
    out = torch.empty((B, T, N, D), dtype=cls.dtype, device=dev)
    cls_rows = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    if q8:
        _check_aligned(**{k: p[k] for k in ("qkv_s", "proj_s", "fc1_s", "fc2_s")})
        ws = _ws(spatial_mlp_q8_ws(B, T, N, D, Dh, lib), dev)
        with torch.cuda.device(dev):
            _run(lib.dvst_spatial_mlp_q8, x1.data_ptr(), cls.data_ptr(),
                 *(p[k].data_ptr() for k in SPATIAL_Q8_KEYS), ws.data_ptr(),
                 out.data_ptr(), cls_rows.data_ptr(), B, T, N, D, num_heads, Dh,
                 int(f32), _stream(dev))
        _count_q8("spatial_mlp_q8_f32" if f32 else "spatial_mlp_q8")
        return out, cls_rows
    ws = _ws(spatial_mlp_ws(B, T, N, D, Dh, lib), dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_spatial_mlp, x1.data_ptr(), cls.data_ptr(),
             *(p[k].data_ptr() for k in SPATIAL_KEYS), ws.data_ptr(),
             out.data_ptr(), cls_rows.data_ptr(), B, T, N, D, num_heads, Dh,
             int(f32), _stream(dev))
    launches["spatial_mlp_f32" if f32 else "spatial_mlp"] += 1
    return out, cls_rows


def divided_block_wb(p: dict, cls: torch.Tensor, grid: torch.Tensor,
                     num_heads: int):
    """Whole divided block: cls (B, 1, D), grid (B, T, N, D), both bf16 or
    (the mixed teacher's tier) both f32 -> (cls, grid) in that dtype, with
    the f32 intra-block carry between the two ops and the CLS row updated
    in plain f32 torch (erf GELU), as JAX's ``clsf.astype(cls.dtype)``. The
    int8 tier's CLS row takes JAX's int8 math (fused_block.py:1694-1706):
    fc1 quantizes the f32 LN row and writes f32, fc2 quantizes bf16(GELU)
    and writes bf16."""
    x1 = temporal_phase_tm(grid, p["temporal"], num_heads)
    grid_out, cls_frames = spatial_mlp(x1, cls, p["spatial"], num_heads)
    s = p["spatial"]
    clsf = cls.float() + cls_frames.mean(dim=1, keepdim=True)
    yn = _ln(clsf, s["ln2_w"], s["ln2_b"])
    if is_q8(s):
        h = F.gelu(quant.int8_linear(yn, s["fc1_w"], s["fc1_s"]) + s["fc1_b"])
        mo = quant.int8_linear(h.to(torch.bfloat16), s["fc2_w"], s["fc2_s"]).float()
    else:
        h = F.gelu(_mm(yn.to(torch.bfloat16), s["fc1_w"]) + s["fc1_b"])
        mo = _mm(h.to(torch.bfloat16), s["fc2_w"])
    clsf = clsf + mo + s["fc2_b"]
    return clsf.to(cls.dtype), grid_out


def mlp_phase(x: torch.Tensor, p: dict, residual: bool = True) -> torch.Tensor:
    """x (M, D) rows -> [x +] fc2(GELU(fc1(LN x))) as (M, D) in x's dtype,
    with the ``MLP_KEYS`` weights of ``block_params(...)["spatial"]``: bf16
    rows round fc2's output before the residual add; f32 rows (the mixed
    teacher's banded grid) add it unrounded. Kernel on CUDA, plain twin on
    CPU."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (M, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: dtype {x.dtype}, expected bfloat16 or float32")
    M, D = x.shape
    Dh = p["fc1_w"].shape[0]
    dev = _device_of(x)
    if D % 128 or D > 1024 or Dh % 128:
        raise ValueError(f"D={D}, MLP width {Dh}: the kernels need "
                         "multiples of 128 and D <= 1024")
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_weights(p, MLP_KEYS, _spatial_shapes(D, Dh), dev)
    if dev.type == "cpu":
        return mlp_phase_plain(x, p, residual)

    from . import _build

    _check_aligned(x=x, fc1_w=p["fc1_w"], fc2_w=p["fc2_w"])
    lib = _build.load()
    out = torch.empty((M, D), dtype=x.dtype, device=dev)
    ws = _ws(mlp_phase_ws(M, D, Dh, lib), dev)
    x_f32 = x.dtype == torch.float32
    with torch.cuda.device(dev):
        _run(lib.dvst_mlp_phase, x.data_ptr(),
             *(p[k].data_ptr() for k in MLP_KEYS), ws.data_ptr(),
             out.data_ptr(), M, D, Dh, int(residual), int(x_f32), _stream(dev))
    launches["mlp_phase_f32" if x_f32 else "mlp_phase"] += 1
    return out


# ---------------------------------------------------------------------------
# Backward wrappers (``csrc/fused_block_bwd.cu``)
# ---------------------------------------------------------------------------

def temporal_attn_bwd_smem(S: int, L: int, hd: int, lib=None) -> int:
    """Shared bytes one block of the temporal attention backward (the tile's
    backward at stride N, ``tc_strided_attn_bwd``) needs over S sequences
    of L rows at head dim hd: ``lib``'s ``dvst_temporal_attn_bwd_smem``
    where given, else its mirror here (tc_group's sequences; a zero row, Q,
    K, V and dA, three floats per row of its 16-row strips), so that the
    plain twins on the CPU refuse what the kernel refuses (a card test
    holds the two equal)."""
    if lib is not None:
        return lib.dvst_temporal_attn_bwd_smem(S, L, hd)
    if S <= 0 or L <= 0:
        return 0
    G = _tc_group(S, L)
    return 16 + 8 * G * L * hd + 192 * _tc_strips(G, L)


def check_temporal_attn_bwd_smem(S: int, L: int, hd: int, lib=None) -> None:
    """Raise if one block of the temporal attention backward cannot hold its
    sequences of L rows at head dim hd (``temporal_attn_bwd_smem``)."""
    need = temporal_attn_bwd_smem(S, L, hd, lib)
    if need > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd}: the attention "
                         f"backward needs {need} B of shared memory (limit "
                         f"{SMEM_LIMIT})")


def spatial_attn_bwd_smem(L: int, hd: int, lib=None) -> int:
    """Shared bytes one block of the spatial attention backward (the tile's
    backward, ``tc_prefix_attn_bwd``) needs at L rows and head dim hd:
    ``lib``'s ``dvst_spatial_attn_bwd_smem`` where given, else its mirror
    here (a zero row, Q, K, V and dA, three floats per row padded to 16
    rows), so that the plain twins on the CPU refuse what the kernel
    refuses (a card test holds the two equal)."""
    if lib is not None:
        return lib.dvst_spatial_attn_bwd_smem(L, hd)
    return 16 + 8 * L * hd + 12 * (-(-L // 16) * 16)


def check_spatial_attn_bwd_smem(L: int, hd: int, lib=None) -> None:
    """Raise if one block of the spatial attention backward cannot hold L
    rows at head dim hd (``spatial_attn_bwd_smem``)."""
    need = spatial_attn_bwd_smem(L, hd, lib)
    if need > SMEM_LIMIT:
        raise ValueError(f"sequence length {L} at head dim {hd}: the attention "
                         f"backward needs {need} B of shared memory (limit "
                         f"{SMEM_LIMIT})")


def _ws(nbytes: int, dev) -> torch.Tensor:
    if nbytes < 0:
        raise RuntimeError("the kernel library could not size its workspace")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def spatial_attention_bwd(qkv: torch.Tensor, qkv_prefix: torch.Tensor,
                          da: torch.Tensor, da_prefix: torch.Tensor,
                          num_heads: int, scale: Optional[float] = None):
    """The attention backward of ``spatial_phase_bwd`` alone (the tile's
    backward): qkv (S, N, 3D) and qkv_prefix (P, 3D) bf16 as
    ``spatial_attention`` takes them, the cotangents da (S, N, D) and
    da_prefix (S, D) bf16 -> (dqkv (S, N, 3D), dqkv_prefix (S, 3D)) bf16
    (dq | dk | dv; the prefix row's gradient once per sequence), at logit
    scale ``scale`` (hd^-0.5 unless given). Kernel on CUDA, plain twin on
    CPU."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (S, N, 3D), got {tuple(qkv.shape)}")
    S, N, D3 = qkv.shape
    D = D3 // 3
    dev = _device_of(qkv)
    _check_geometry(D, num_heads)
    _check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    P = qkv_prefix.shape[0] if qkv_prefix.dim() == 2 else 0
    if P == 0 or S % P:
        raise ValueError(f"qkv_prefix: expected (P, {D3}) with {S} % P == 0, "
                         f"got {tuple(qkv_prefix.shape)}")
    _check_tensor("qkv_prefix", qkv_prefix, torch.bfloat16, (P, D3), dev)
    _check_tensor("da", da, torch.bfloat16, (S, N, D), dev)
    _check_tensor("da_prefix", da_prefix, torch.bfloat16, (S, D), dev)
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    if dev.type == "cpu":
        check_spatial_attn_bwd_smem(N + 1, hd)
        return spatial_attention_bwd_plain(qkv, qkv_prefix, da, da_prefix, num_heads,
                                           scale)

    from . import _build

    _check_aligned(qkv=qkv, qkv_prefix=qkv_prefix, da=da, da_prefix=da_prefix)
    lib = _build.load("bwd")
    check_spatial_attn_bwd_smem(N + 1, hd, lib)
    dqkv = torch.empty_like(qkv)
    dqkv_pre = torch.empty((S, D3), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_spatial_attn_bwd, qkv.data_ptr(), qkv_prefix.data_ptr(),
             da.data_ptr(), da_prefix.data_ptr(), dqkv.data_ptr(),
             dqkv_pre.data_ptr(), S, S // P, N, D, num_heads, float(scale),
             _stream(dev))
    launches["spatial_attention_bwd"] += 1
    return dqkv, dqkv_pre


def temporal_attention_bwd(qkv: torch.Tensor, da: torch.Tensor, num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The attention backward of ``temporal_phase_tm_bwd`` alone (the tile's
    backward at stride N): qkv (B, T, N, 3D) bf16 as ``temporal_attention``
    takes it and the cotangent da (B, T, N, D) bf16 -> dqkv (B, T, N, 3D)
    bf16 (dq | dk | dv), sequence (b, n) the T rows at qkv[b, :, n], at
    logit scale ``scale`` (hd^-0.5 unless given). Kernel on CUDA, plain
    twin on CPU."""
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv: expected (B, T, N, 3D), got {tuple(qkv.shape)}")
    B, T, N, D3 = qkv.shape
    D = D3 // 3
    dev = _device_of(qkv)
    _check_geometry(D, num_heads)
    _check_tensor("qkv", qkv, torch.bfloat16, qkv.shape, dev)
    _check_tensor("da", da, torch.bfloat16, (B, T, N, D), dev)
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    if dev.type == "cpu":
        check_temporal_attn_bwd_smem(B * N, T, hd)
        return temporal_attention_bwd_plain(qkv, da, num_heads, scale)

    from . import _build

    _check_aligned(qkv=qkv, da=da)
    lib = _build.load("bwd")
    check_temporal_attn_bwd_smem(B * N, T, hd, lib)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(dev):
        _run(lib.dvst_temporal_attn_bwd, qkv.data_ptr(), da.data_ptr(), dqkv.data_ptr(),
             B, T, N, D, num_heads, float(scale), _stream(dev))
    launches["temporal_attention_bwd"] += 1
    return dqkv


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                   res: Optional[torch.Tensor] = None,
                   x_tail: Optional[torch.Tensor] = None, tail_div: int = 1):
    """The LayerNorm backward of the three backward ops alone: x (M, D) bf16
    rows and, for P * tail_div tail rows, x_tail (P, D) bf16 (each row
    shared by tail_div rows: row 8's per-frame CLS rows); dy (M + P *
    tail_div, D) f32, the scale w (D,) f32, the residual res (M, D) bf16 or
    None -> (dx (M, D) bf16 = bf16(dx + res), the tail rows' dx (P *
    tail_div, D) f32 or None, dscale (D,), dbias (D,) f32). f32 x (with
    x_tail and res f32) is the trainer's mixed tier: dx = dx + res in f32,
    never rounded. D % 128 == 0, D <= 1024. Kernel on CUDA, plain twin on
    CPU."""
    x_f32 = _rows_f32(x)
    if x.dim() != 2:
        raise ValueError(f"x: expected (M, D), got {tuple(x.shape)}")
    M, D = x.shape
    dev = _device_of(x)
    if D % 128 or D > 1024:
        raise ValueError(f"D={D}: the kernel needs a multiple of 128, at most 1024")
    if tail_div < 1:
        raise ValueError(f"tail_div={tail_div}: at least 1")
    P = 0 if x_tail is None else x_tail.shape[0]
    R = M + P * tail_div
    _check_tensor("x", x, x.dtype, (M, D), dev)
    if x_tail is not None:
        _check_tensor("x_tail", x_tail, x.dtype, (P, D), dev)
    _check_tensor("dy", dy, torch.float32, (R, D), dev)
    _check_tensor("w", w, torch.float32, (D,), dev)
    if res is not None:
        _check_tensor("res", res, x.dtype, (M, D), dev)
    if dev.type == "cpu":
        return layer_norm_bwd_plain(x, dy, w, res, x_tail, tail_div)

    from . import _build

    _check_aligned(x=x, x_tail=x_tail, dy=dy, w=w, res=res)
    lib = _build.load("bwd")
    dx = torch.empty_like(x)
    dx_tail = None if x_tail is None else torch.empty((R - M, D), dtype=torch.float32, device=dev)
    dgb = torch.empty((2, D), dtype=torch.float32, device=dev)
    part = _ws(lib.dvst_layer_norm_bwd_ws(R, D), dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_layer_norm_bwd, x.data_ptr(),
             None if x_tail is None else x_tail.data_ptr(), dy.data_ptr(), w.data_ptr(),
             None if res is None else res.data_ptr(), dx.data_ptr(),
             None if dx_tail is None else dx_tail.data_ptr(), part.data_ptr(),
             dgb.data_ptr(), M, R, D, tail_div, int(x_f32), _stream(dev))
    launches["layer_norm_bwd_f32" if x_f32 else "layer_norm_bwd"] += 1
    return dx, dx_tail, dgb[0], dgb[1]


def gemm_dx(dy: torch.Tensor, w: torch.Tensor, epi: str,
            aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dX GEMM of ``spatial_phase_bwd`` and ``mlp_phase_bwd`` alone: dy
    (M, K) bf16, w (K, N) bf16 (an (out, in) weight, read as stored) ->
    ``epi`` (a key of GEMM_DX_EPILOGUES) of dy @ w, (M, N); ``aux`` (M, N)
    f32 for ``mul_f32_bf16``. N % 128 == 0, K % 64 == 0. Kernel on CUDA,
    plain twin on CPU."""
    if epi not in GEMM_DX_EPILOGUES:
        raise ValueError(f"epilogue {epi!r}: one of {sorted(GEMM_DX_EPILOGUES)}")
    code, aux_dtype, out_dtype = GEMM_DX_EPILOGUES[epi]
    if dy.dim() != 2 or w.dim() != 2:
        raise ValueError("dy and w: expected (M, K) and (K, N)")
    (M, K), N = dy.shape, w.shape[1]
    dev = _device_of(dy)
    if N % 128 or K % 64:
        raise ValueError(f"N={N}, K={K}: the kernel needs N % 128 == 0 and "
                         "K % 64 == 0")
    _check_tensor("dy", dy, torch.bfloat16, (M, K), dev)
    _check_tensor("w", w, torch.bfloat16, (K, N), dev)
    if aux_dtype is None:
        if aux is not None:
            raise ValueError(f"epilogue {epi!r} takes no aux")
    else:
        _check_tensor("aux", aux, aux_dtype, (M, N), dev)
    if dev.type == "cpu":
        return gemm_dx_plain(dy, w, epi, aux)

    from . import _build

    _check_aligned(dy=dy, w=w)
    lib = _build.load("bwd")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_gemm_dx, dy.data_ptr(), w.data_ptr(),
             None if aux is None else aux.data_ptr(), out.data_ptr(), M, N, K,
             code, _stream(dev))
    launches["gemm_dx"] += 1
    return out


def gemm_dw(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The weight-gradient GEMM of ``spatial_phase_bwd`` and
    ``mlp_phase_bwd`` alone: dy (rows, n_out), x (rows, k_in) bf16 -> dW =
    dy^T x (n_out, k_in) f32, in the weights' (out, in) layout, summed over
    the rows in splits added in a fixed order. n_out % 128 == 0, k_in % 128
    == 0. Kernel on CUDA, plain twin on CPU."""
    if dy.dim() != 2 or x.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError("dy and x: expected (rows, n_out) and (rows, k_in)")
    (R, n_out), k_in = dy.shape, x.shape[1]
    dev = _device_of(dy)
    if n_out % 128 or k_in % 128:
        raise ValueError(f"n_out={n_out}, k_in={k_in}: the kernel needs "
                         "multiples of 128")
    _check_tensor("dy", dy, torch.bfloat16, (R, n_out), dev)
    _check_tensor("x", x, torch.bfloat16, (R, k_in), dev)
    if dev.type == "cpu":
        return gemm_dw_plain(dy, x)

    from . import _build

    _check_aligned(dy=dy, x=x)
    lib = _build.load("bwd")
    out = torch.empty((n_out, k_in), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        part = _ws(lib.dvst_gemm_dw_ws(R, n_out, k_in), dev)
        _run(lib.dvst_gemm_dw, dy.data_ptr(), x.data_ptr(), out.data_ptr(),
             part.data_ptr(), R, n_out, k_in, _stream(dev))
    launches["gemm_dw"] += 1
    return out


def gemm_dw_splits(rows: int, n_out: int, k_in: int) -> int:
    """The split count ``gemm_dw`` takes on the current card for these
    shapes (the library's choice; ``chip_smoke.py`` prints it)."""
    from . import _build

    n = _build.load("bwd").dvst_gemm_dw_splits(rows, n_out, k_in)
    if n < 1:
        raise RuntimeError("the kernel library could not ask the device")
    return n


def gemm_gelu_grad(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Row 9's fc1 recompute alone: a (M, K) bf16, w (N, K) bf16, bias (N,)
    f32 -> (bf16(gelu(h)) (M, N) bf16, gelu'(h) (M, N) f32) of h = a @ w^T
    + bias, one GEMM with both outputs from its f32 accumulator. N % 128 ==
    0, K % 64 == 0. Kernel on CUDA, plain twin on CPU."""
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError("a and w: expected (M, K) and (N, K)")
    (M, K), N = a.shape, w.shape[0]
    dev = _device_of(a)
    if N % 128 or K % 64:
        raise ValueError(f"N={N}, K={K}: the kernel needs N % 128 == 0 and "
                         "K % 64 == 0")
    _check_tensor("a", a, torch.bfloat16, (M, K), dev)
    _check_tensor("w", w, torch.bfloat16, (N, K), dev)
    _check_tensor("bias", bias, torch.float32, (N,), dev)
    if dev.type == "cpu":
        return gemm_gelu_grad_plain(a, w, bias)

    from . import _build

    _check_aligned(a=a, w=w)
    lib = _build.load("bwd")
    hg = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    gp = torch.empty((M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run(lib.dvst_gemm_gelu_grad, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
             hg.data_ptr(), gp.data_ptr(), M, N, K, _stream(dev))
    launches["gemm_gelu_grad"] += 1
    return hg, gp


def _grads(dev, shapes: dict, keys):
    """f32 gradient buffers: the two LayerNorm vectors (``keys[:2]``) share
    one (2, D) buffer (the kernels write scale | bias), the rest one each."""
    D = shapes[keys[0]][0]
    dln = torch.empty((2, D), dtype=torch.float32, device=dev)
    g = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
         for k in keys[2:]}
    g[keys[0]], g[keys[1]] = dln[0], dln[1]
    return dln, g


def temporal_phase_tm_bwd(x: torch.Tensor, dout: torch.Tensor, p: dict,
                          num_heads: int):
    """Backward of ``temporal_phase_tm``'s bf16 tier: x, dout (B, T, N, D)
    bf16 -> (dx (B, T, N, D) bf16, f32 gradients keyed as
    ``TEMPORAL_KEYS``, in the weights' (out, in) layout); of its f32 tier
    (the trainer's mixed tier) on f32 x and dout: dx f32. Kernel on CUDA,
    plain twin on CPU."""
    x_f32 = _rows_f32(x)
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, N, D), got {tuple(x.shape)}")
    B, T, N, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_tensor("dout", dout, x.dtype, x.shape, dev)
    shapes = _temporal_shapes(D)
    _check_weights(p, TEMPORAL_KEYS, shapes, dev)
    hd = D // num_heads
    if dev.type == "cpu":
        check_temporal_attn_bwd_smem(B * N, T, hd)
        return temporal_phase_tm_bwd_plain(x, dout, p, num_heads)

    from . import _build

    _check_aligned(x=x, dout=dout, qkv_w=p["qkv_w"], proj_w=p["proj_w"], fc_w=p["fc_w"])
    lib = _build.load("bwd")
    check_temporal_attn_bwd_smem(B * N, T, hd, lib)
    dx = torch.empty_like(x)
    dln, g = _grads(dev, shapes, TEMPORAL_KEYS)
    with torch.cuda.device(dev):
        ws = _ws(lib.dvst_temporal_phase_tm_bwd_ws(B, T, N, D, num_heads, int(x_f32)), dev)
        _run(lib.dvst_temporal_phase_tm_bwd, x.data_ptr(), dout.data_ptr(),
             *(p[k].data_ptr() for k in TEMPORAL_KEYS), ws.data_ptr(),
             dx.data_ptr(), dln.data_ptr(),
             *(g[k].data_ptr() for k in TEMPORAL_KEYS[2:]),
             B, T, N, D, num_heads, int(x_f32), _stream(dev))
    launches["temporal_phase_tm_bwd_f32" if x_f32 else "temporal_phase_tm_bwd"] += 1
    return dx, g


def spatial_phase_bwd(x: torch.Tensor, cls: torch.Tensor, dgo: torch.Tensor,
                      dco: torch.Tensor, p: dict, num_heads: int):
    """Backward of ``spatial_phase``: x (B, T, N, D), cls (B, 1, D), the
    cotangents dgo (B, T, N, D) and dco (B, T, D), all bf16 -> (dx bf16,
    dcls (B, 1, D) f32, f32 gradients keyed as ``SPATIAL_PHASE_KEYS``); all
    f32 (the mixed tier): dx f32. Kernel on CUDA, plain twin on CPU."""
    x_f32 = _rows_f32(x)
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, N, D), got {tuple(x.shape)}")
    B, T, N, D = x.shape
    dev = _device_of(x)
    _check_geometry(D, num_heads)
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_tensor("cls", cls, x.dtype, (B, 1, D), dev)
    _check_tensor("dgo", dgo, x.dtype, x.shape, dev)
    _check_tensor("dco", dco, x.dtype, (B, T, D), dev)
    shapes = _spatial_shapes(D)
    _check_weights(p, SPATIAL_PHASE_KEYS, shapes, dev)
    hd = D // num_heads
    if dev.type == "cpu":
        check_spatial_attn_bwd_smem(N + 1, hd)
        return spatial_phase_bwd_plain(x, cls, dgo, dco, p, num_heads)

    from . import _build

    _check_aligned(x=x, cls=cls, dgo=dgo, dco=dco, qkv_w=p["qkv_w"], proj_w=p["proj_w"])
    lib = _build.load("bwd")
    check_spatial_attn_bwd_smem(N + 1, hd, lib)
    dx = torch.empty_like(x)
    dcls = torch.empty((B, 1, D), dtype=torch.float32, device=dev)
    dln, g = _grads(dev, shapes, SPATIAL_PHASE_KEYS)
    with torch.cuda.device(dev):
        ws = _ws(lib.dvst_spatial_phase_bwd_ws(B, T, N, D, num_heads, int(x_f32)), dev)
        _run(lib.dvst_spatial_phase_bwd, x.data_ptr(), cls.data_ptr(),
             dgo.data_ptr(), dco.data_ptr(),
             *(p[k].data_ptr() for k in SPATIAL_PHASE_KEYS), ws.data_ptr(),
             dx.data_ptr(), dcls.data_ptr(), dln.data_ptr(),
             *(g[k].data_ptr() for k in SPATIAL_PHASE_KEYS[2:]),
             B, T, N, D, num_heads, int(x_f32), _stream(dev))
    launches["spatial_phase_bwd_f32" if x_f32 else "spatial_phase_bwd"] += 1
    return dx, dcls, g


def mlp_phase_bwd(x: torch.Tensor, do: torch.Tensor, p: dict,
                  residual: bool = True):
    """Backward of ``mlp_phase``: x, do (M, D) bf16 -> (dx (M, D) bf16,
    f32 gradients keyed as ``MLP_KEYS``); f32 x and do (the mixed tier): dx
    f32. Kernel on CUDA, plain twin on CPU."""
    x_f32 = _rows_f32(x)
    if x.dim() != 2:
        raise ValueError(f"x: expected (M, D), got {tuple(x.shape)}")
    M, D = x.shape
    Dh = p["fc1_w"].shape[0]
    dev = _device_of(x)
    if D % 128 or D > 1024 or Dh % 128:
        raise ValueError(f"D={D}, MLP width {Dh}: the kernels need "
                         "multiples of 128 and D <= 1024")
    _check_tensor("x", x, x.dtype, x.shape, dev)
    _check_tensor("do", do, x.dtype, x.shape, dev)
    shapes = _spatial_shapes(D, Dh)
    _check_weights(p, MLP_KEYS, shapes, dev)
    if dev.type == "cpu":
        return mlp_phase_bwd_plain(x, do, p, residual)

    from . import _build

    _check_aligned(x=x, do=do, fc1_w=p["fc1_w"], fc2_w=p["fc2_w"])
    lib = _build.load("bwd")
    dx = torch.empty_like(x)
    dln, g = _grads(dev, shapes, MLP_KEYS)
    with torch.cuda.device(dev):
        ws = _ws(lib.dvst_mlp_phase_bwd_ws(M, D, Dh, int(x_f32)), dev)
        _run(lib.dvst_mlp_phase_bwd, x.data_ptr(), do.data_ptr(),
             *(p[k].data_ptr() for k in MLP_KEYS), ws.data_ptr(),
             dx.data_ptr(), dln.data_ptr(),
             *(g[k].data_ptr() for k in MLP_KEYS[2:]),
             M, D, Dh, int(residual), int(x_f32), _stream(dev))
    launches["mlp_phase_bwd_f32" if x_f32 else "mlp_phase_bwd"] += 1
    return dx, g


# ---------------------------------------------------------------------------
# Autograd Functions of the per-phase training tier
# ---------------------------------------------------------------------------

def kernel_weights(params, keys) -> dict:
    """f32 master parameters (in ``keys`` order) -> the kernels' layout:
    bf16 matrices, f32 vectors."""
    return {k: (t.detach().to(torch.bfloat16) if k in _MATRICES
                else t.detach().float()).contiguous()
            for k, t in zip(keys, params)}


def _cast_grads(g: dict, keys, params):
    return tuple(g[k].to(p.dtype) for k, p in zip(keys, params))


class TemporalPhaseTm(torch.autograd.Function):
    """``temporal_phase_tm`` with ``temporal_phase_tm_bwd`` as its backward:
    ``apply(x, num_heads, *params)``, params the f32 masters in
    ``TEMPORAL_KEYS`` order. bf16 x runs the bf16-out tier (1b), f32 x the
    f32 tier (1f: f32 in and out, the trainer's mixed tier)."""

    @staticmethod
    def forward(ctx, x, num_heads, *params):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, *params)
        return temporal_phase_tm(x, kernel_weights(params, TEMPORAL_KEYS),
                                 num_heads, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        dx, g = temporal_phase_tm_bwd(
            x, dout.contiguous(), kernel_weights(params, TEMPORAL_KEYS),
            ctx.num_heads)
        return (dx, None) + _cast_grads(g, TEMPORAL_KEYS, params)


class SpatialPhase(torch.autograd.Function):
    """``spatial_phase`` with ``spatial_phase_bwd`` as its backward:
    ``apply(x, cls, num_heads, *params)``, params the f32 masters in
    ``SPATIAL_PHASE_KEYS`` order; x and cls bf16, or both f32 (4f)."""

    @staticmethod
    def forward(ctx, x, cls, num_heads, *params):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, cls, *params)
        return spatial_phase(x, cls, kernel_weights(params, SPATIAL_PHASE_KEYS),
                             num_heads)

    @staticmethod
    def backward(ctx, dgo, dco):
        x, cls, *params = ctx.saved_tensors
        B, T, N, D = x.shape
        dgo = torch.zeros_like(x) if dgo is None else dgo.contiguous()
        dco = (torch.zeros((B, T, D), dtype=dgo.dtype, device=x.device)
               if dco is None else dco.contiguous())
        dx, dcls, g = spatial_phase_bwd(
            x, cls, dgo, dco, kernel_weights(params, SPATIAL_PHASE_KEYS),
            ctx.num_heads)
        return ((dx, dcls.to(cls.dtype), None)
                + _cast_grads(g, SPATIAL_PHASE_KEYS, params))


class MlpPhase(torch.autograd.Function):
    """``mlp_phase`` with ``mlp_phase_bwd`` as its backward:
    ``apply(x, residual, *params)``, x (M, D) bf16 or f32 (3f and 9f),
    params the f32 masters in ``MLP_KEYS`` order."""

    @staticmethod
    def forward(ctx, x, residual, *params):
        ctx.residual = residual
        ctx.save_for_backward(x, *params)
        return mlp_phase(x, kernel_weights(params, MLP_KEYS), residual)

    @staticmethod
    def backward(ctx, do):
        x, *params = ctx.saved_tensors
        dx, g = mlp_phase_bwd(x, do.contiguous(),
                              kernel_weights(params, MLP_KEYS), ctx.residual)
        return (dx, None) + _cast_grads(g, MLP_KEYS, params)
