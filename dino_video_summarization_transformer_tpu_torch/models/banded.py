"""Banded one-pass scoring forwards (counterpart of the JAX package's
``models/banded.py``).

The exact scorer runs every frame through many overlapping windows. The
banded pass processes each frame once per pass:

* temporal attention is masked to the frame's clamp-shifted window
  (``lo_i = clip(i - eff//2, 0, T - eff)``, the arithmetic of
  ``data/windows.window_indices``), so every frame sees the temporal key
  set the windowed forward gives its window's centre frame;
* spatial attention runs per frame with a per-frame CLS token;
* each frame's CLS aggregates over its window: for every t in win(i) the
  CLS attends [cls_i, patches_t] and the results are averaged (the
  reference's broadcast-attend-average CLS protocol, per frame).

When the video length equals the window length and the time embedding is
constant, the banded pass reproduces the windowed forward for every frame.

Two routes, chosen by the model's ``TimeSformerConfig.use_kernels``:

* plain: the slab-blocked masked attention of the JAX XLA path, in the
  module's dtype (f32 is the reference-compat tier); a quantized model's
  dense layers run ``quant.int8_linear`` (``QuantLinear``), JAX's XLA
  route on ``qkernel`` weights (banded int8; the kernel route refuses a
  quantized model, as JAX's Pallas banded route does);
* kernels: ``ops/banded_block.py`` for the temporal attention, the
  per-frame-CLS spatial phase and the CLS window aggregation, and
  ``ops/fused_block.mlp_phase`` for the grid MLP; the CLS rows' MLP and
  projection stay plain torch (C rows), as in the JAX package. A bf16
  model runs the bf16 tiers; an f32 model (the mixed teacher) carries f32
  rows between the ops, which run their f32 tiers (the spatial phase and
  the grid MLP: LN on the f32 rows, bf16 matmul operands, the residuals
  in f32) or, for the two attentions, take bf16 operands and return bf16
  that the caller casts, as JAX's mixed tier does (JAX
  ``models/banded.py:232-275`` at ``compute_dtype=f32``); the temporal
  glue's LN and dense layers run in f32 on the f32 weights.
"""

from __future__ import annotations

import torch

from ..ops import banded_block as bb
from ..ops import fused_block as fb
from ..ops.banded_block import band_starts
from .timesformer import interp_nearest_1d, layer_norm, resize_pos_embed

__all__ = ["BANDED_INT8_KERNELS", "band_starts", "banded_block", "banded_cls_features"]

# A quantized model's banded pass runs on the plain route only, as in the
# JAX package, where ``linear()`` consumes the quantized layers (its XLA
# route) and the Pallas banded route reads float kernels only.
BANDED_INT8_KERNELS = (
    "banded passes on a quantized model run on the plain route only "
    "(use_kernels=False): the JAX package's Pallas banded route has no int8 "
    "tier (its ops/banded_block.py:249,253 raise KeyError: 'kernel' on a "
    "quantized layer), so neither has the port's")


def _band_mask(lo_b: torch.Tensor, s0: int, S: int, eff: int) -> torch.Tensor:
    """(P, S) bool: slab key j (absolute row s0 + j) inside query i's
    clamp-shifted window [lo_i, lo_i + eff)."""
    kj = s0 + torch.arange(S, device=lo_b.device)
    return (kj[None, :] >= lo_b[:, None]) & (kj[None, :] < lo_b[:, None] + eff)


def _block_size(C: int, block: int) -> int:
    """Largest query-block size <= ``block`` that divides C."""
    P = min(block, C)
    while C % P:
        P -= 1
    return P


def _slabs(C: int, eff: int, block: int, t_real: int):
    """(b*P, P, s0, S) per query block: the block's P queries and the S-frame
    key slab around it. The slab starts at the JAX package's b*P - halo, or
    lower where the end clamp pulls the block's first window start below
    that: in a padded chunk (t_real well below C) the JAX slab misses those
    windows, every key is masked, and the NaN rows reach valid rows through
    the CLS aggregation's 0 * NaN."""
    P = _block_size(C, block)
    halo = eff - 1
    S = min(C, P + 2 * halo)
    hi = max(t_real - eff, 0)
    for b in range(C // P):
        lo_first = min(max(b * P - eff // 2, 0), hi)
        yield b * P, P, min(max(min(b * P - halo, lo_first), 0), C - S), S


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation and an f32 result
    (``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def _banded_temporal(blk, x, lo, eff: int, num_heads: int, block: int,
                     t_real: int):
    """x + temporal_fc(proj(banded_attn(LN x))) for x (C, N, D): the divided
    block's temporal half with the attention masked to per-frame windows."""
    C, N, D = x.shape
    H = num_heads
    hd = D // H
    y = blk._ln(blk.temporal_norm1, x)
    q, k, v = blk.temporal_attn.qkv(y).reshape(C, N, 3, H, hd).unbind(2)
    outs = []
    for i0, P, s0, S in _slabs(C, eff, block, t_real):
        scores = _f32_einsum("pnhd,snhd->hnps", q[i0:i0 + P],
                             k[s0:s0 + S]) * hd ** -0.5
        valid = _band_mask(lo[i0:i0 + P], s0, S, eff)
        scores = scores.masked_fill(~valid, float("-inf"))
        pr = scores.softmax(dim=-1).to(v.dtype)
        outs.append(torch.einsum("hnps,snhd->pnhd", pr, v[s0:s0 + S]))
    res = blk.temporal_attn.proj(torch.cat(outs).reshape(C, N, D))
    return x + blk.temporal_fc(res)


def _banded_spatial(blk, cls, x, lo, eff: int, num_heads: int, block: int,
                    t_real: int):
    """Per-frame spatial attention with a per-frame CLS, and the windowed
    CLS aggregation. cls (C, 1, D), x (C, N, D) -> the post-projection
    residuals (cls_res (C, 1, D), pat_res (C, N, D))."""
    C, N, D = x.shape
    H = num_heads
    hd = D // H
    scale = hd ** -0.5
    qkv = blk.attn.qkv
    q_c, k_c, v_c = qkv(blk._ln(blk.norm1, cls)).reshape(C, 3, H, hd).unbind(1)
    q_p, k_p, v_p = qkv(blk._ln(blk.norm1, x)).reshape(C, N, 3, H, hd).unbind(2)
    pat_out, cls_out = [], []
    for i0, P, s0, S in _slabs(C, eff, block, t_real):
        sl = slice(i0, i0 + P)
        qp_b, kp_b, vp_b = q_p[sl], k_p[sl], v_p[sl]
        qc_b, kc_b, vc_b = q_c[sl], k_c[sl], v_c[sl]
        # patches attend [cls_t, patches_t] of their own frame
        s_pp = _f32_einsum("tnhd,tmhd->thnm", qp_b, kp_b) * scale
        s_pc = _f32_einsum("tnhd,thd->thn", qp_b, kc_b) * scale
        pr = torch.cat([s_pc[..., None], s_pp], dim=-1).softmax(dim=-1).to(x.dtype)
        pat_out.append(torch.einsum("thnm,tmhd->tnhd", pr[..., 1:], vp_b)
                       + torch.einsum("thn,thd->tnhd", pr[..., 0], vc_b))
        # cls_i attends [cls_i, patches_t] for t in win(i), averaged: one
        # softmax over [self, N patches of frame t] per (i, t)
        kp_s, vp_s = k_p[s0:s0 + S], v_p[s0:s0 + S]
        s_cp = _f32_einsum("phd,snhd->hpsn", qc_b, kp_s) * scale
        s_cc = _f32_einsum("phd,phd->hp", qc_b, kc_b) * scale
        m = torch.maximum(s_cp.amax(dim=-1), s_cc[:, :, None])  # (H, P, S)
        e_cp = torch.exp(s_cp - m[..., None])
        e_cc = torch.exp(s_cc[:, :, None] - m)
        den = e_cc + e_cp.sum(dim=-1)
        o_ct = (torch.einsum("hpsn,snhd->hpsd", e_cp, vp_s.float())
                + e_cc[..., None] * vc_b.float().transpose(0, 1)[:, :, None, :]
                ) / den[..., None]
        valid = _band_mask(lo[sl], s0, S, eff).float()
        o_c = torch.einsum("hpsd,ps->phd", o_ct, valid) / eff
        cls_out.append(o_c.to(x.dtype))
    pat_res = blk.attn.proj(torch.cat(pat_out).reshape(C, N, D))
    cls_res = blk.attn.proj(torch.cat(cls_out).reshape(C, 1, D))
    return cls_res, pat_res


def _banded_spatial_fused(blk, kp, cls, x, t_real: int, eff: int,
                            num_heads: int):
    """Kernel route of the spatial half: the per-frame-CLS spatial phase
    (with the patch residual) and the CLS window aggregation over its qkv
    buffers. Returns (cls_res (C, 1, D), x_new (C, N, D))."""
    C, N, D = x.shape
    x_new, qkv, qkv_cls = bb.spatial_phase_pf(
        x.contiguous(), cls[:, 0].contiguous(), kp["spatial"], num_heads)
    band = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, num_heads)
    return blk.attn.proj(band.to(x.dtype).reshape(C, 1, D)), x_new


def _temporal_weights(blk) -> dict:
    """The temporal glue's weights (``fused_block.TEMPORAL_KEYS``) as the
    block holds them, in its own dtype."""
    ta = blk.temporal_attn
    qkv_b = ta.qkv.bias
    if qkv_b is None:  # the kernels' layout gives a bias-free qkv zeros
        qkv_b = ta.qkv.weight.new_zeros(ta.qkv.out_features)
    return {"ln_w": blk.temporal_norm1.weight, "ln_b": blk.temporal_norm1.bias,
            "qkv_w": ta.qkv.weight, "qkv_b": qkv_b,
            "proj_w": ta.proj.weight, "proj_b": ta.proj.bias,
            "fc_w": blk.temporal_fc.weight, "fc_b": blk.temporal_fc.bias}


def banded_block(blk, cls, x, lo, eff: int, num_heads: int, block: int,
                 t_real: int, kp=None):
    """One divided block (``models.timesformer.Block``) in banded form.
    ``kp`` (the block's ``fused_block.block_params``) selects the kernel
    route; None runs the plain route."""
    if kp is not None:
        x = bb.banded_temporal_phase(x.contiguous(), _temporal_weights(blk),
                                     t_real, eff, num_heads)
        cls_res, x = _banded_spatial_fused(blk, kp, cls, x, t_real, eff,
                                             num_heads)
        cls = cls + cls_res
    else:
        x = _banded_temporal(blk, x, lo, eff, num_heads, block, t_real)
        cls_res, pat_res = _banded_spatial(blk, cls, x, lo, eff, num_heads,
                                           block, t_real)
        cls = cls + cls_res
        x = x + pat_res
    cls = cls + blk.mlp(blk._ln(blk.norm2, cls))
    if kp is not None:
        C, N, D = x.shape
        x = fb.mlp_phase(x.reshape(C * N, D), kp["spatial"]).reshape(C, N, D)
    else:
        x = x + blk.mlp(blk._ln(blk.norm2, x))
    return cls, x


def banded_cls_features(model, frames: torch.Tensor, t_real: int, eff: int,
                        block: int = 32) -> torch.Tensor:
    """Per-frame CLS features of one banded pass over a chunk of frames.

    ``model``: a ``TimeSformer``; frames (C, Himg, Wimg, 3) normalized,
    channels-last; ``t_real``: the count of valid frames (rows >= t_real
    are padding: their outputs are garbage for the caller to drop, and
    they never reach a valid row); ``eff``: the window length (the local
    size for the student pass, min(global size, T) for the teacher).
    Returns (C, D) float32."""
    cfg = model.cfg
    if model.quantized and cfg.use_kernels:
        raise NotImplementedError(BANDED_INT8_KERNELS)
    C, _, Wimg, _ = frames.shape
    D = cfg.embed_dim
    dtype = model.pos_embed.dtype
    tok = model.patch_embed(frames.to(dtype))  # (C, N, D)
    xt = torch.cat([model.cls_token.expand(C, 1, D), tok], dim=1)
    pe = model.pos_embed
    if xt.shape[1] != pe.shape[1]:
        pe = resize_pos_embed(pe, xt.shape[1], Wimg // cfg.patch_size)
    xt = xt + pe
    te = model.time_embed
    if eff != te.shape[1]:
        te = interp_nearest_1d(te, eff, axis=1)
    # every frame sits at the centre of its own window: the centre
    # embedding (exact for interior frames; the off-centre delta is part
    # of the banded approximation)
    cls, x = xt[:, :1], xt[:, 1:] + te[0, eff // 2]
    lo = band_starts(torch.arange(C, device=frames.device), eff, t_real)
    kps = model.kernel_params() if cfg.use_kernels else [None] * len(model.blocks)
    for blk, kp in zip(model.blocks, kps):
        cls, x = banded_block(blk, cls, x, lo, eff, cfg.num_heads, block,
                              t_real, kp)
    out = layer_norm(cls, model.norm.weight, model.norm.bias, cfg.norm_eps)
    return out[:, 0].float()
