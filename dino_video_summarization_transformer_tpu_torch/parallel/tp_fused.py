"""Head-sharded per-phase kernels under tensor parallelism (counterpart of
the JAX package's ``parallel/tp_fused.py``).

Each rank runs the kernel route's three phases on its heads: the partial
tier (tier C) of rows 1 and 4 (``fused_block.TemporalPhaseTmPartial``,
``SpatialPhasePartial``: the shard's term of the sum over the shards, no
proj or fc bias, no residual) and row 3 at ``residual=False`` with fc2's
bias zeroed (``MlpPhase``: its fc1 column-, fc2 row-parallel). One
all-reduce over the model group per phase half sums the terms in f32;
the residuals and the once-applied biases are added after it, as JAX's
``psum`` and its adds (``tp_fused.py:111-150`` there): ``b_comb = bproj_t
@ Wfc^T + bfc`` after the temporal half, ``bproj_s`` after the spatial,
``b2`` after the MLP.

Gradients. JAX gets them from ``shard_map``'s transpose; here they are
placed by hand, with ``tp.copy_to_model`` (identity forward, all-reduce of
the gradient over the model group backward):

* each kernel's inputs, the grid and the CLS row: every shard's kernel
  adds its term of their gradient;
* the replicated parameters read inside a shard's kernel: the LN scales
  and biases (``temporal_norm1``, ``norm1``, ``norm2``) and the
  ``temporal_fc`` weight, whose gradients are the sums of the shards'
  terms. The fc weight's gradient through ``b_comb`` is whole on every
  rank and is not reduced again, nor are the once-applied biases'.

The qkv rows are the head-major permutation's (``qkv_head_perm``: shard l
holds [q | k | v] of its heads), so a kernel slices q, k and v at fixed
offsets of its own width. ``permute_qkv_tree`` / ``unpermute_qkv_tree``
move a state dict in and out of that layout; the port's checkpoints are
always written unpermuted (``parallel/state.gather_flat``), where
JAX keeps the permuted layout in its Orbax checkpoints (ROADMAP section 3).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops import fused_block as fb
from . import tp
from .mesh import Mesh


def qkv_head_perm(D: int, num_heads: int, tp_size: int) -> np.ndarray:
    """The row permutation taking a (3D, D) qkv weight (or its (3D,) bias)
    from [q | k | v] (heads interleaved across the shard chunks) to the
    head-major shard order: chunk l holds [q | k | v] of heads l * H/tp ..
    (l + 1) * H/tp - 1 (JAX ``qkv_head_perm``, there a column
    permutation of the (D, 3D) kernel)."""
    hd = D // num_heads
    Hl = num_heads // tp_size
    cols = np.arange(3 * D)
    t = cols // D
    rest = cols % D
    h = rest // hd
    o = rest % hd
    return np.lexsort((o, h % Hl, t, h // Hl))


def _is_qkv(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "qkv" and parts[-1] in ("weight", "bias")


def _apply_qkv_perm(sd: Mapping[str, torch.Tensor], num_heads: int, tp_size: int,
                    inverse: bool = False) -> dict:
    out = {}
    for n, v in sd.items():
        if _is_qkv(n):
            perm = qkv_head_perm(v.shape[0] // 3, num_heads, tp_size)
            if inverse:
                perm = np.argsort(perm)
            v = v[torch.as_tensor(perm, device=v.device)]
        out[n] = v
    return out


def permute_qkv_tree(sd: Mapping[str, torch.Tensor], num_heads: int, tp_size: int) -> dict:
    """Every ``*.qkv.weight`` / ``*.qkv.bias`` of a state dict (or of a
    moment dict keyed the same) into the head-major TP layout."""
    return _apply_qkv_perm(sd, num_heads, tp_size)


def unpermute_qkv_tree(sd: Mapping[str, torch.Tensor], num_heads: int, tp_size: int) -> dict:
    """The inverse of ``permute_qkv_tree``."""
    return _apply_qkv_perm(sd, num_heads, tp_size, inverse=True)


def tp_fused_divided_block(blk, cls: torch.Tensor, grid: torch.Tensor, heads: int,
                           mesh: Mesh):
    """One divided block on the rank's ``heads`` heads: cls (B, 1, D) and
    the frame-major grid (B, T, N, D), bf16. The values of
    ``Block.forward_kernels`` on the unsharded block, up to the rounding of
    each shard's terms to bf16 before their sum."""
    B, T, N, D = grid.shape
    ta, sa, mlp = blk.temporal_attn, blk.attn, blk.mlp

    def rep(t):  # a replicated parameter read inside the shards' kernels
        return tp.copy_to_model(t, mesh)

    def psum(t):
        return tp.reduce_from_model(t.float(), mesh)

    # temporal half: grid + (sum of fc(proj_l(attn_l(LN grid)))) + b_comb
    wfc = blk.temporal_fc.weight
    part = fb.TemporalPhaseTmPartial.apply(
        tp.copy_to_model(grid, mesh), heads, rep(blk.temporal_norm1.weight),
        rep(blk.temporal_norm1.bias), ta.qkv.weight, ta.qkv.bias, ta.proj.weight, rep(wfc))
    b_comb = torch.matmul(ta.proj.bias.float(), wfc.float().t()) + blk.temporal_fc.bias.float()
    grid = grid + (psum(part) + b_comb).to(grid.dtype)

    # spatial half
    g_part, c_part = fb.SpatialPhasePartial.apply(
        tp.copy_to_model(grid, mesh), tp.copy_to_model(cls, mesh), heads,
        rep(blk.norm1.weight), rep(blk.norm1.bias), sa.qkv.weight, sa.qkv.bias,
        sa.proj.weight)
    bproj = sa.proj.bias.float()
    grid = grid + (psum(g_part) + bproj).to(grid.dtype)
    cls = cls + (psum(c_part) + bproj).mean(dim=1, keepdim=True).to(cls.dtype)

    # MLP: fc1 column-, fc2 row-parallel; row 3 without its residual, fc2's
    # bias zeroed and added after the sum
    b2 = mlp.fc2.bias
    params = (rep(blk.norm2.weight), rep(blk.norm2.bias), mlp.fc1.weight, mlp.fc1.bias,
              mlp.fc2.weight, torch.zeros_like(b2))
    m_g = fb.MlpPhase.apply(tp.copy_to_model(grid, mesh).reshape(B * T * N, D), False, *params)
    m_c = fb.MlpPhase.apply(tp.copy_to_model(cls, mesh).reshape(B, D), False, *params)
    grid = grid + (psum(m_g) + b2).to(grid.dtype).reshape(B, T, N, D)
    cls = cls + (psum(m_c) + b2).to(cls.dtype).reshape(B, 1, D)
    return cls, grid


def tp_fused_forward_features(backbone, x: torch.Tensor, cfg, mesh: Mesh,
                              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The TP twin of the kernel route's training forward (JAX
    ``tp_fused_forward_features``): the replicated embedding, the blocks on
    the rank's heads (``tp_fused_divided_block``), the replicated final LN.
    The backbone's qkv, fc1, proj and fc2 are the rank's shards of the
    permuted state (``models/convert.shard_state_dict(...,
    tp_fused=True)``). -> (B, D) CLS features, the same on every rank of
    the model group; differentiable."""
    if cfg.num_heads % mesh.model:
        raise ValueError(f"{cfg.num_heads} heads over a model axis of {mesh.model}")
    if cfg.attention_type != "divided_space_time":
        raise ValueError("the TP-fused forward runs divided space-time attention only")
    heads = cfg.num_heads // mesh.model
    cls_tok, grid = backbone.train_tokens(x, compute_dtype)
    cls_tok, grid = cls_tok.contiguous(), grid.contiguous()
    for blk in backbone.blocks:
        cls_tok, grid = tp_fused_divided_block(blk, cls_tok, grid, heads, mesh)
    return backbone.final_norm(cls_tok)
