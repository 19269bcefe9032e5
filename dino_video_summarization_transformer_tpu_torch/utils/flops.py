"""Analytic FLOP counts (the JAX package's ``utils/flops.py``): one
divided space-time forward, one DINO train step, and a banded pass with the
port's kernel route counted as it runs. Multiply-adds count as 2 FLOP;
norms, softmax and elementwise work (<1%) are left out."""

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


def timesformer_forward_flops(cfg, num_frames: int) -> float:
    """FLOP of one divided space-time forward, batch 1, T = num_frames:
    patch embedding, qkv / proj / temporal_fc, the attention products and
    the MLP (the JAX package's ``timesformer_forward_flops``)."""
    D = cfg.embed_dim
    N = cfg.num_patches
    T = num_frames
    mlp_hidden = int(D * cfg.mlp_ratio)
    patch_in = cfg.patch_size * cfg.patch_size * cfg.in_chans
    flops = 2.0 * T * N * patch_in * D
    per_block = 0.0
    if cfg.attention_type == "divided_space_time":
        per_block += T * N * (2 * 3 * D * D + 2 * D * D)      # qkv + proj
        per_block += T * N * (4 * T * D)                      # QK^T + PV
        per_block += T * N * (2 * D * D)                      # temporal_fc
        per_block += T * (N + 1) * (2 * 3 * D * D + 2 * D * D)
        per_block += T * (N + 1) * (4 * (N + 1) * D)
        per_block += (1 + N * T) * (2 * 2 * D * mlp_hidden)
    else:
        seq = 1 + N * T if cfg.attention_type == "joint_space_time" else N + 1
        reps = 1 if cfg.attention_type == "joint_space_time" else T
        per_block += reps * seq * (2 * 4 * D * D + 4 * seq * D)
        per_block += reps * seq * (2 * 2 * D * mlp_hidden)
    return flops + cfg.depth * per_block


def train_step_flops(cfg, batch_per_step: int, n_local_crops: int = 8,
                     local_size_px: int = 96) -> float:
    """FLOP of one DINO train step: the teacher forward on the 2 global
    crops, the student forward + backward (3x forward) on the 2 global and
    the local crops, heads and optimizer left out (the JAX package's
    ``train_step_flops``)."""
    import dataclasses

    B = batch_per_step
    T = cfg.num_frames
    g = timesformer_forward_flops(cfg, T)
    loc = timesformer_forward_flops(
        dataclasses.replace(cfg, img_size=local_size_px), T)
    return 2 * B * g + 3 * B * (2 * g + n_local_crops * loc)
