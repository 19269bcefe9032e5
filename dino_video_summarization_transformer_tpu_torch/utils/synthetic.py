"""Numpy-seeded TimeSformer weights and synthetic video.

Pure-numpy copies of the JAX package's ``utils/synthetic.py``: the same
``RandomState`` draws in the same order, so both packages build bit-equal
weights and frames from one seed. ``make_numpy_params`` returns the JAX
package's stacked-block pytree layout as numpy arrays;
``models.convert.state_dict_from_jax_params`` turns it into the reference
``.pth`` layout the port's modules load.
"""

from __future__ import annotations

import numpy as np


def make_numpy_params(cfg, seed: int = 0) -> dict:
    """Deterministic TimeSformer params (stacked along a leading depth axis),
    drawn in the order of the JAX package's ``make_numpy_params``."""
    r = np.random.RandomState(seed)
    D, L = cfg.embed_dim, cfg.depth
    Dh = int(D * cfg.mlp_ratio)

    def f32(a):
        return np.asarray(a, np.float32)

    def lin(fi, fo, std=0.02):
        return {"kernel": f32(r.randn(fi, fo) * std),
                "bias": f32(r.randn(fo) * 0.01)}

    def ln():
        return {"scale": f32(1 + 0.05 * r.randn(D)),
                "bias": f32(0.02 * r.randn(D))}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    blocks = stack([{
        "norm1": ln(),
        "attn": {"qkv": lin(D, 3 * D), "proj": lin(D, D)},
        "norm2": ln(),
        "mlp": {"fc1": lin(D, Dh), "fc2": lin(Dh, D)},
        "temporal_norm1": ln(),
        "temporal_attn": {"qkv": lin(D, 3 * D), "proj": lin(D, D)},
        "temporal_fc": lin(D, D),
    } for _ in range(L)])
    return {
        "cls_token": f32(r.randn(1, 1, D) * 0.02),
        "pos_embed": f32(r.randn(1, cfg.num_patches + 1, D) * 0.02),
        "patch_embed": {
            "proj": lin(cfg.patch_size * cfg.patch_size * cfg.in_chans, D)},
        "blocks": blocks,
        "norm": ln(),
        "time_embed": f32(r.randn(1, cfg.num_frames, D) * 0.02),
    }


def make_video(seed: int, T: int, size: int, events: bool = True) -> np.ndarray:
    """(T, size, size, 3) uint8: smoothed panning textures with hard cuts
    and sparse bright 3-frame events (see the JAX package's module)."""
    r = np.random.RandomState(seed)
    big = r.rand(size * 3, size * 3, 3).astype(np.float32)
    for _ in range(3):  # smooth the texture
        big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0)
                      + np.roll(big, 1, 1) + np.roll(big, -1, 1))
    vid = np.zeros((T, size, size, 3), np.float32)
    t0 = 0
    while t0 < T:
        seg = min(T - t0, r.randint(50, 90))
        x0, y0 = r.randint(0, size * 2, 2)
        vx, vy = r.uniform(-1.2, 1.2, 2)
        tex = np.roll(big, r.randint(0, 999), axis=r.randint(0, 2))
        for i in range(seg):
            xx = int(np.clip(x0 + vx * i, 0, size * 2 - 1))
            yy = int(np.clip(y0 + vy * i, 0, size * 2 - 1))
            vid[t0 + i] = tex[yy:yy + size, xx:xx + size]
        t0 += seg
    if events:
        for e in r.choice(T - 4, max(2, T // 60), replace=False):
            x0, y0 = r.randint(0, size - size // 4, 2)
            s = size // 4
            vid[e:e + 3, y0:y0 + s, x0:x0 + s] += 0.8
    vid += 0.03 * r.randn(T, size, size, 3).astype(np.float32)
    return (np.clip(vid, 0, 1) * 255).astype(np.uint8)
