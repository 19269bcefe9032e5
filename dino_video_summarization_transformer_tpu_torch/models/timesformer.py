"""TimeSformer / SVT divided space-time backbone in PyTorch.

Counterpart of the JAX package's ``models/timesformer.py`` (ref:
models/timesformer.py:55-364). The modules hold their weights in the
reference ``.pth`` layout (``blocks.{i}.attn.qkv.weight`` as (out, in),
the patch embedding as a (D, C, ps, ps) convolution weight), so published
SVT checkpoints and ``convert.state_dict_from_jax_params`` load natively.

Two block routes, chosen per model by ``TimeSformerConfig.use_kernels``:

* plain (default): the divided block with the split CLS/grid carry on the
  position-major (h w t) grid, in the module's dtype — the counterpart of
  the JAX XLA path (f32 is the reference-compat tier);
* kernels: the frame-major (B, T, N, D) grid through the whole-block
  kernel pair of ``ops/fused_block.py`` (bf16 block boundaries, f32
  intra-block carry) — the counterpart of ``fused_wb``. On a CUDA tensor
  it launches the Hopper kernels; on a CPU tensor their plain twins run.

Patch embedding is patchify + one matmul (as in JAX), which also keeps
cuDNN's TF32 convolution default out of the f32 tier.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_block


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    num_frames: int = 8
    num_classes: int = 400
    attention_type: str = "divided_space_time"
    drop_path_rate: float = 0.1
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    norm_eps: float = 1e-6
    # Run every block through the whole-block kernel pair (frame-major
    # grid, bf16 activations). The scorer sets it; see the module docstring.
    use_kernels: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


def vit_base_config(**kw) -> TimeSformerConfig:
    """ViT-B/16 (ref: models/timesformer.py:592-609)."""
    return TimeSformerConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_small_config(**kw) -> TimeSformerConfig:
    return TimeSformerConfig(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_tiny_config(**kw) -> TimeSformerConfig:
    return TimeSformerConfig(embed_dim=192, depth=12, num_heads=3, **kw)


_ARCH_DIMS = {
    # embed_dim, depth, num_heads
    "vit_base": (768, 12, 12),
    "timesformer": (768, 12, 12),
    "vit_small": (384, 12, 6),
    "vit_tiny": (192, 12, 3),
}


def config_from_cfg(cfg, no_head: bool = False,
                    arch: str = "vit_base") -> TimeSformerConfig:
    """Build from the CfgNode tree (ref: models/timesformer.py:592-601)."""
    embed_dim, depth, num_heads = _ARCH_DIMS.get(arch, _ARCH_DIMS["vit_base"])
    return TimeSformerConfig(
        img_size=cfg.DATA.TRAIN_CROP_SIZE,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        num_classes=0 if no_head else cfg.MODEL.NUM_CLASSES,
        num_frames=cfg.DATA.NUM_FRAMES,
        attention_type=cfg.TIMESFORMER.ATTENTION_TYPE,
    )


# ---------------------------------------------------------------------------
# Plain tensor functions
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to x's dtype (the JAX
    package's formula: biased variance, rsqrt)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def mhsa(x: torch.Tensor, qkv: nn.Linear, proj: nn.Linear,
         num_heads: int) -> torch.Tensor:
    """Dense multi-head self-attention over (S, L, D) sequences
    (ref: models/timesformer.py:55-87). f32 softmax statistics; bf16 keeps
    the score tensor in bf16, as the JAX XLA path does."""
    S, L, C = x.shape
    hd = C // num_heads
    q, k, v = qkv(x).reshape(S, L, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4).unbind(0)  # each (S, H, L, hd)
    scale = hd ** -0.5
    attn = (q @ k.transpose(-2, -1)) * scale
    if x.dtype == torch.bfloat16:
        attn = attn.softmax(dim=-1)
    else:
        attn = attn.float().softmax(dim=-1).to(x.dtype)
    out = (attn @ v).transpose(1, 2).reshape(S, L, C)
    return proj(out)


def interp_nearest_1d(src: torch.Tensor, out_len: int, axis: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') index rule floor(i*in/out),
    evaluated in float32 as the JAX package evaluates it."""
    in_len = src.shape[axis]
    ratio = torch.tensor(in_len / out_len, dtype=torch.float32)
    idx = torch.floor(torch.arange(out_len, dtype=torch.float32) * ratio).long()
    return torch.index_select(src, axis, idx.to(src.device))


def resize_pos_embed(pos_embed: torch.Tensor, n_tokens: int, W: int) -> torch.Tensor:
    """Nearest-resize of spatial pos embeddings with the reference's exact
    (quirky) geometry (ref: models/timesformer.py:292-303): the target grid
    is (n_tokens // W, W) where n_tokens counts the CLS token."""
    cls_pe = pos_embed[:, :1, :]
    other = pos_embed[0, 1:, :]
    P = int(math.isqrt(other.shape[0]))
    D = other.shape[1]
    H_new = n_tokens // W
    grid = other.reshape(P, P, D)
    grid = interp_nearest_1d(grid, H_new, axis=0)
    grid = interp_nearest_1d(grid, W, axis=1)
    return torch.cat([cls_pe, grid.reshape(1, H_new * W, D)], dim=1)


# ---------------------------------------------------------------------------
# Modules (reference state-dict layout)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # torch nn.GELU default: the exact erf form
        return self.fc2(F.gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Conv2d k=s=patch held as the reference's convolution weight, run as
    patchify + matmul (ref: models/timesformer.py:188-209)."""

    def __init__(self, patch_size: int, in_chans: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, dim, patch_size, patch_size)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (BT, H, W, C) channels-last -> (BT, H/ps * W/ps, D)."""
        BT, H, W, C = frames.shape
        ps = self.patch_size
        gh, gw = H // ps, W // ps
        x = frames.reshape(BT, gh, ps, gw, ps, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(BT, gh * gw, ps * ps * C)
        # w[d, c, kh, kw] -> kernel row d over the (kh, kw, c) patch vector
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(x, w, self.proj.bias)


class Block(nn.Module):
    """Divided space-time block (ref: models/timesformer.py:116-185)."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.eps = cfg.norm_eps
        self.norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.attn = Attention(D, cfg.qkv_bias)
        self.temporal_norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.temporal_attn = Attention(D, cfg.qkv_bias)
        self.temporal_fc = nn.Linear(D, D)
        self.norm2 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))

    def _ln(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, norm.weight, norm.bias, self.eps)

    def forward(self, cls: torch.Tensor, grid: torch.Tensor, B: int, T: int,
                N: int):
        """Plain inference route. cls (B, 1, D); grid (B, N*T, D) in
        (h w t) order. The CLS row and the grid travel separately; every
        residual and the MLP are position-wise, so values equal the
        reference's concatenated sequence."""
        D = grid.shape[-1]
        H = self.num_heads
        # temporal attention over T at each spatial position
        xt = grid.reshape(B * N, T, D)
        xt = xt + self.temporal_fc(mhsa(self._ln(self.temporal_norm1, xt),
                                        self.temporal_attn.qkv,
                                        self.temporal_attn.proj, H))
        xt = xt.reshape(B, N * T, D)
        # spatial attention over [CLS, H*W] per frame
        cls_rep = cls.expand(B, T, D).reshape(B * T, 1, D)
        xs = xt.reshape(B, N, T, D).transpose(1, 2).reshape(B * T, N, D)
        xs = torch.cat([cls_rep, xs], dim=1)
        res_s = mhsa(self._ln(self.norm1, xs), self.attn.qkv, self.attn.proj, H)
        # CLS averaged over frames (ref: models/timesformer.py:161-164)
        cls_out = res_s[:, 0, :].reshape(B, T, D).mean(dim=1, keepdim=True)
        res_sp = res_s[:, 1:, :].reshape(B, T, N, D).transpose(1, 2).reshape(
            B, N * T, D)
        cls = cls + cls_out
        grid = xt + res_sp
        cls = cls + self.mlp(self._ln(self.norm2, cls))
        grid = grid + self.mlp(self._ln(self.norm2, grid))
        return cls, grid


class TimeSformer(nn.Module):
    """Divided space-time TimeSformer backbone (ref: models/timesformer.py
    :190-364); ``forward`` takes (B, C, T, H, W) like the reference."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        if cfg.attention_type != "divided_space_time":
            raise NotImplementedError(
                f"attention_type={cfg.attention_type!r}: only divided space-"
                "time attention is ported (ROADMAP: other backbones)")
        self.cfg = cfg
        D = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.time_embed = nn.Parameter(torch.zeros(1, cfg.num_frames, D))
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.head = nn.Linear(D, cfg.num_classes) if cfg.num_classes > 0 else None
        self._kp_key = None
        self._kp = None

    def load_reference_state_dict(self, sd: Mapping[str, object]) -> None:
        """Load a reference-layout state dict (numpy arrays or tensors).
        Every parameter must be present; keys the model has no use for
        (a classifier head it does not build) are ignored, as the JAX
        converter ignores them. Values are cast to the parameters' dtype
        (round to nearest even for bf16)."""
        own = self.state_dict()
        missing = sorted(set(own) - set(sd))
        if missing:
            raise KeyError(f"state dict lacks {missing[:8]}"
                           f"{' ...' if len(missing) > 8 else ''}")
        with torch.no_grad():
            for k, t in own.items():
                v = sd[k]
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v))  # a writable copy
                if v.shape != t.shape:
                    raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                     f"{tuple(t.shape)}")
                t.copy_(v)

    def kernel_params(self) -> list:
        """Per-block weights in the kernels' layout (bf16 matrices, f32
        vectors), rebuilt whenever a parameter is replaced or written."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._kp_key:
            self._kp = [fused_block.block_params(b) for b in self.blocks]
            self._kp_key = key
        return self._kp

    def forward_features(self, x: torch.Tensor,
                         get_all: bool = False) -> torch.Tensor:
        """x (B, C, T, H, W) -> (B, D) CLS features, or (B, 1+N*T, D) in
        the reference token order [CLS, (h w t)] when ``get_all``. Runs in
        the dtype of the module's parameters."""
        cfg = self.cfg
        B, C, T, Himg, Wimg = x.shape
        ps = cfg.patch_size
        W = Wimg // ps
        N = (Himg // ps) * W
        D = cfg.embed_dim
        dtype = self.pos_embed.dtype

        x = x.to(dtype)
        frames = x.permute(0, 2, 3, 4, 1).reshape(B * T, Himg, Wimg, C)
        tok = self.patch_embed(frames)  # (BT, N, D)
        cls = self.cls_token.expand(B * T, 1, D)
        xt = torch.cat([cls, tok], dim=1)
        pe = self.pos_embed
        if xt.shape[1] != pe.shape[1]:
            pe = resize_pos_embed(pe, xt.shape[1], W)
        xt = xt + pe
        te = self.time_embed
        if T != te.shape[1]:
            te = interp_nearest_1d(te, T, axis=1)
        cls_tok = xt[:B, :1, :]  # identical across frames before mixing

        if cfg.use_kernels:
            grid = xt[:, 1:, :].reshape(B, T, N, D) + te[:, :, None, :]
            cls_tok = cls_tok.contiguous()
            for p in self.kernel_params():
                cls_tok, grid = fused_block.divided_block_wb(
                    p, cls_tok, grid, cfg.num_heads)
            cls_tok = cls_tok.to(dtype)
            if get_all:
                spat = grid.transpose(1, 2).reshape(B, N * T, D).to(dtype)
                x = torch.cat([cls_tok, spat], dim=1)
                return layer_norm(x, self.norm.weight, self.norm.bias,
                                  cfg.norm_eps)
            return layer_norm(cls_tok, self.norm.weight, self.norm.bias,
                              cfg.norm_eps)[:, 0]

        # '(b t) n m -> (b n) t m', + time embedding, -> b (n t) m
        spat = xt[:, 1:, :].reshape(B, T, N, D).transpose(1, 2).reshape(
            B * N, T, D)
        spat = (spat + te).reshape(B, N * T, D)
        for blk in self.blocks:
            cls_tok, spat = blk(cls_tok, spat, B, T, N)
        if get_all:
            x = torch.cat([cls_tok, spat], dim=1)
            return layer_norm(x, self.norm.weight, self.norm.bias, cfg.norm_eps)
        # only the CLS row is consumed: LN is per token
        return layer_norm(cls_tok, self.norm.weight, self.norm.bias,
                          cfg.norm_eps)[:, 0]

    def forward(self, x: torch.Tensor, use_head: bool = False) -> torch.Tensor:
        """(ref: models/timesformer.py:347-351)."""
        feats = self.forward_features(x)
        if use_head and self.head is not None:
            feats = self.head(feats)
        return feats


def build_timesformer(cfg: TimeSformerConfig, state_dict: Mapping[str, object],
                      device=None, dtype: Optional[torch.dtype] = None
                      ) -> TimeSformer:
    """Build on ``device`` (default: the CUDA card), cast to ``dtype`` and
    load a reference-layout state dict. Inference mode (``eval``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = TimeSformer(cfg)
    if dtype is not None:
        model = model.to(dtype)
    model.load_reference_state_dict(state_dict)
    return model.eval()
