"""2D Vision Transformer, DINO's image ViT (counterpart of the JAX
package's ``models/vit2d.py``; ref: vision_transformer.py:100-245): the
two-stream trainer's motion nets over Sobel-filtered flow frames.

The module holds the reference ``.pth`` layout (``blocks.{i}.attn.qkv
.weight`` (out, in), ``patch_embed.proj`` a (D, C, ps, ps) convolution
weight), so a published DINO ViT checkpoint (``convert.
convert_dino_vit2d_checkpoint``) and ``convert.state_dict_from_jax_params``
load natively. Its blocks are the TimeSformer's ``Block`` without the
temporal half (``Block.forward_joint``); the forward runs plain torch in
the compute dtype, the f32 weights cast where JAX casts them, as JAX runs
its motion nets on XLA with no Pallas kernel. The positional embedding is
resized by DINO's bicubic interpolation with the ``+0.1`` scale factor
that leaks into the sampling positions (``interpolate_pos_encoding``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from .timesformer import (Block, PatchEmbed, TimeSformerConfig, _drop_path,
                          _trunc_normal, layer_norm, linear, mhsa_train,
                          load_reference_state_dict)


@dataclasses.dataclass(frozen=True)
class ViT2DConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    num_classes: int = 0
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


def vit2d_tiny(**kw) -> ViT2DConfig:
    return ViT2DConfig(embed_dim=192, depth=12, num_heads=3, **kw)


def vit2d_small(**kw) -> ViT2DConfig:
    return ViT2DConfig(embed_dim=384, depth=12, num_heads=6, **kw)


def vit2d_base(**kw) -> ViT2DConfig:
    return ViT2DConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def _bicubic_coords(out_len: int, in_len: int, scale_override: Optional[float],
                    device) -> tuple:
    """Source indices (out, 4) and weights (out, 4) of torch's bicubic
    (align_corners=False, a = -0.75) in f32, as JAX ``_bicubic_resize_2d``
    computes them: with ``scale_override`` the given factor maps the
    coordinates, not out / in."""
    scale = (1.0 / scale_override) if scale_override else in_len / out_len
    src = (torch.arange(out_len, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    i0 = torch.floor(src).to(torch.int64)
    frac = src - i0.to(torch.float32)
    idx = torch.stack([i0 - 1, i0, i0 + 1, i0 + 2], dim=1)
    d = torch.stack([frac + 1, frac, 1 - frac, 2 - frac], dim=1)
    a = -0.75
    ad = d.abs()
    w = torch.where(
        ad <= 1, (a + 2) * ad ** 3 - (a + 3) * ad ** 2 + 1,
        torch.where(ad < 2, a * ad ** 3 - 5 * a * ad ** 2 + 8 * a * ad - 4 * a,
                    torch.zeros_like(ad)))
    return idx.clamp(0, in_len - 1), w


def bicubic_resize_2d(grid: torch.Tensor, out_h: int, out_w: int,
                      scale_h: Optional[float] = None,
                      scale_w: Optional[float] = None) -> torch.Tensor:
    """torch ``F.interpolate(mode="bicubic", align_corners=False)`` on an
    (H, W, D) grid, written as JAX's ``_bicubic_resize_2d`` (rows, then
    columns, clamped taps); ``scale_h`` / ``scale_w`` carry a
    ``scale_factor`` call's factors into the sampling positions."""
    yi, yw = _bicubic_coords(out_h, grid.shape[0], scale_h, grid.device)
    xi, xw = _bicubic_coords(out_w, grid.shape[1], scale_w, grid.device)
    rows = (grid[yi] * yw[:, :, None, None].to(grid.dtype)).sum(dim=1)  # (out_h, W, D)
    return (rows[:, xi] * xw[None, :, :, None].to(grid.dtype)).sum(dim=2)


def interpolate_pos_encoding(pos_embed: torch.Tensor, npatch: int, w: int, h: int,
                             patch_size: int) -> torch.Tensor:
    """DINO's positional-embedding interpolation with the +0.1 trick (ref:
    vision_transformer.py:174-198; JAX ``interpolate_pos_encoding``): the
    grid's first axis resized to int(w0 + 0.1) rows by the factor
    (w0 + 0.1) / side, its second to int(h0 + 0.1) by (h0 + 0.1) / side."""
    N = pos_embed.shape[1] - 1
    if npatch == N and w == h:
        return pos_embed
    dim = pos_embed.shape[-1]
    side = int(math.isqrt(N))
    w0, h0 = w // patch_size, h // patch_size
    out_w = int(side * ((w0 + 0.1) / side))
    out_h = int(side * ((h0 + 0.1) / side))
    grid = pos_embed[0, 1:].reshape(side, side, dim)
    resized = bicubic_resize_2d(grid, out_w, out_h, scale_h=(w0 + 0.1) / side,
                                scale_w=(h0 + 0.1) / side)
    return torch.cat([pos_embed[:, :1], resized.reshape(1, -1, dim)], dim=1)


def drop_path_masks(B: int, cfg: ViT2DConfig,
                    generator: Optional[torch.Generator] = None, device=None) -> list:
    """One per-sample keep mask (B,) per block, drawn with probability
    1 - rate_i (rate_i from 0 to ``cfg.drop_path_rate`` over the blocks),
    on the CPU from ``generator``. JAX draws one mask a block from one key
    and applies it to both of the block's branches; so does ``forward``."""
    rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth)
    return [torch.bernoulli(torch.full((B,), 1.0 - float(r)), generator=generator).to(device)
            for r in rates]


class ViT2D(nn.Module):
    """DINO's 2D ViT (ref: vision_transformer.py:100-245); ``forward`` takes
    (B, C, H, W) images and returns (B, D) CLS features."""

    def __init__(self, cfg: ViT2DConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        bcfg = TimeSformerConfig(embed_dim=D, depth=cfg.depth, num_heads=cfg.num_heads,
                                 mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                                 attention_type="space_only", norm_eps=cfg.norm_eps)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.blocks = nn.ModuleList(Block(bcfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.head = nn.Linear(D, cfg.num_classes) if cfg.num_classes > 0 else None

    def load_reference_state_dict(self, sd) -> None:
        load_reference_state_dict(self, sd)

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(ref: vision_transformer.py:200-210) x (B, C, H, W) in the compute
        dtype -> [CLS, patches] + the interpolated positional embedding."""
        B, C, H, W = x.shape
        ps = self.cfg.patch_size
        tok = self.patch_embed.forward_train(x.permute(0, 2, 3, 1))
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.cfg.embed_dim)
        pe = interpolate_pos_encoding(self.pos_embed, (H // ps) * (W // ps), H, W, ps)
        return torch.cat([cls, tok], dim=1) + pe.to(x.dtype)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                use_head: bool = False,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """(ref: vision_transformer.py:212-217; JAX ``vit2d.forward``) x (B,
        C, H, W) -> (B, D) CLS features in ``compute_dtype`` (default: the
        parameters'). ``masks`` (``drop_path_masks``) runs the drop-path
        forward, JAX's ``train=True`` with a key: each block's mask scales
        both branches by mask / keep."""
        cfg = self.cfg
        x = self.prepare_tokens(x.to(compute_dtype or self.pos_embed.dtype))
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        for i, blk in enumerate(self.blocks):
            if masks is None or cfg.drop_path_rate == 0.0:
                x = blk.forward_joint(x)
                continue
            keep = 1.0 - rates[i]
            x = x + _drop_path(mhsa_train(blk._ln(blk.norm1, x), blk.attn, cfg.num_heads),
                               masks[i], keep)
            x = x + _drop_path(blk._mlp_train(blk._ln(blk.norm2, x)), masks[i], keep)
        feats = layer_norm(x, self.norm.weight, self.norm.bias, cfg.norm_eps)[:, 0]
        if use_head and self.head is not None:
            feats = linear(feats, self.head)
        return feats


def init_vit2d(cfg: ViT2DConfig, generator: torch.Generator, device=None) -> ViT2D:
    """Fresh f32 parameters with JAX ``init_vit2d``'s rules, drawn from
    ``generator`` on the CPU, then moved to ``device`` (default: the CUDA
    card): truncated normals (std 0.02) for the linear kernels, the patch
    embedding, ``cls_token`` and ``pos_embed``; zero biases; LayerNorms at
    1 and 0."""
    from ..utils.device import resolve_device

    with torch.device("cpu"):
        model = ViT2D(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                _trunc_normal(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        _trunc_normal(model.cls_token, generator)
        _trunc_normal(model.pos_embed, generator)
    return model.to(resolve_device(device))
