"""Analytic FLOP count of a banded pass: the JAX package's
``utils/flops.py:banded_pass_flops``, with the port's kernel route counted
as it runs. Multiply-adds count as 2 FLOP."""

from __future__ import annotations


def banded_pass_flops(cfg, n_frames: int, eff: int, block: int = 32,
                      fused: bool = False) -> float:
    """FLOP of ONE banded pass (``models/banded.py``) over an ``n_frames``
    chunk with window length ``eff``.

    Each frame is processed once: patch embed, then per block the banded
    temporal attention against S keys per query, the per-frame spatial
    attention with a per-frame CLS, the CLS window aggregation over S
    frames, and the MLP. The plain route scores a slab of S = min(C, P +
    2*(eff-1)) keys per query (out-of-band keys masked but paid for); the
    kernel route (``fused``) reads each query's eff window keys only, so
    S = eff there (the JAX package's TPU kernels score a 3P-frame slab)."""
    C = n_frames
    D = cfg.embed_dim
    N = cfg.num_patches
    mlp_hidden = int(D * cfg.mlp_ratio)
    patch_in = cfg.patch_size * cfg.patch_size * cfg.in_chans

    P = min(block, C)
    while C % P:
        P -= 1
    S = eff if fused else min(C, P + 2 * (eff - 1))

    per_frame = 2.0 * N * patch_in * D  # patch embed
    per_block = 0.0
    # temporal half: qkv + proj + temporal_fc on N patch tokens; banded
    # scores/values against S keys
    per_block += N * (2 * 3 * D * D + 2 * D * D + 2 * D * D)
    per_block += N * (4 * S * D)
    # spatial half: qkv + proj on (1 + N) tokens; patches attend (1 + N)
    # own-frame keys; CLS attends N patches of S frames (+ self)
    per_block += (N + 1) * (2 * 3 * D * D + 2 * D * D)
    per_block += N * (4 * (N + 1) * D)
    per_block += 4 * S * N * D
    # MLP on (1 + N) tokens
    per_block += (N + 1) * (2 * 2 * D * mlp_hidden)
    return C * (per_frame + cfg.depth * per_block)
