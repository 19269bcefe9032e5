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
  kernel pair of ``ops/fused_block.py`` (f32 intra-block carry, block
  boundaries in the module's dtype: bf16, or f32 for the mixed teacher,
  whose kernels take bf16 matmul operands and carry f32 rows and an f32
  CLS row) — the counterpart of ``fused_wb``. On a CUDA tensor it launches
  the Hopper kernels; on a CPU tensor their plain twins run.

The plain route also has the XLA-layout block's per-phase dispatch
(``Block.forward(use_fused=True)``, the JAX ``divided_block(use_fused=
True)``): the phase functions ``temporal_phase``, ``attn_phase`` and
``mlp_phase_res`` run the per-phase kernel ops of ``ops/fused_block.py``
where ``fused_ok`` admits the tensor (bf16; f32 raises, its tier is not
ported), the plain formula elsewhere. Nothing in the package selects it:
a caller feeds ``TimeSformer.tokens`` through the blocks. With a
drop-path rate and masks (``drop_path_masks``), ``Block.forward`` runs the
JAX drop-path branch: the temporal half plain with a per-sample mask, the
spatial half through ``attn_phase`` with a per-(sample, frame) mask, the
MLP plain with one per-sample mask for CLS and grid. There is no
model-level drop-path forward: its JAX counterpart does not trace
(ROADMAP §3). ``TimeSformerConfig.attention_kernel`` swaps the plain
block's MHSA for ``ops/attention.mhsa_fused`` (JAX:
``use_pallas_attention``).

Patch embedding is patchify + one matmul (as in JAX), which also keeps
cuDNN's TF32 convolution default out of the f32 tier.

A state dict quantized by ``ops/quant.quantize_state_dict_int8`` builds a
quantized model (``build_timesformer``): each block's seven dense layers
are ``QuantLinear`` (s8 codes, f32 scales and bias, no float copy), which
run ``ops/quant.int8_linear`` on the plain route (JAX ``linear`` on a
``qkernel`` tree) and the int8 tier of the whole-block pair on the kernel
route, in the model's dtype: bf16, or f32 (the int8 teacher under the mixed
teacher: the int8 tier's f32 block boundary, f32 x and CLS row in, f32
grid out); the per-phase dispatch is float-only there and raises, as do
training and the banded kernel route (``models/banded.py``).

Training (``TimeSformer.forward_train``) keeps the parameters in f32 and
takes an explicit compute dtype, casting where the JAX package casts: the
input, ``cls_token``, ``pos_embed``, ``time_embed``, each linear kernel and
bias to the activations' dtype, LayerNorm output to x's dtype. Its two
routes, chosen once per model by ``train_route``:

* plain: the JAX XLA ``divided_block`` without drop-path, differentiable
  by autograd — the f32 tier and the plain bf16 tier;
* kernels: the counterpart of ``divided_block_fused`` on the frame-major
  grid, through the autograd Functions ``TemporalPhaseTm``,
  ``SpatialPhase`` and ``MlpPhase`` of ``ops/fused_block.py`` (Hopper
  kernels forward and backward on a CUDA tensor, plain twins on a CPU
  tensor). The CLS update ``cls + mean(cls_frames)`` stays plain torch.
  In bf16 it is the bf16 tier; in f32 the mixed tier (JAX's
  ``use_fused=True`` at f32: f32 activations, carries and CLS row, bf16
  matmul operands), which only an explicit ``route="kernels"`` selects:
  ``"auto"`` picks the kernel route for bf16 alone, as JAX's CLI gate
  ``should_fuse`` does.

On either route ``forward_train(remat=True)`` reruns each block's forward
in the backward (``checkpoint_block``), with the same values.
``AuxTokenTimeSformer`` is the two-token trainer's backbone (an aux class
token beside the CLS token, JAX ``aux_token_forward_features``), on the
plain route only: JAX runs it as XLA code, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention, fused_block, quant


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
    # grid; bf16 activations, or f32 ones in the mixed tier). The scorer
    # sets it; see the module docstring.
    use_kernels: bool = False
    # The plain route's MHSA through the standalone attention kernel
    # (ops/attention.mhsa_fused); the counterpart of JAX's process-wide
    # use_pallas_attention, per model.
    attention_kernel: bool = False

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


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """The JAX package's ``linear``: the kernel and then the bias cast to
    x's dtype, each added in that dtype; a quantized layer (``QuantLinear``)
    runs ``quant.int8_linear``, as JAX's ``linear`` on ``qkernel``."""
    if isinstance(lin, QuantLinear):
        return lin(x)
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def mhsa_train(x: torch.Tensor, attn: nn.Module, num_heads: int) -> torch.Tensor:
    """The JAX package's ``mhsa`` with master weights cast to x's dtype:
    bf16 keeps the scores in bf16 (softmax over them), f32 takes the
    softmax in f32."""
    S, L, C = x.shape
    hd = C // num_heads
    q, k, v = linear(x, attn.qkv).reshape(S, L, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4).unbind(0)
    a = (q @ k.transpose(-2, -1)) * hd ** -0.5
    if x.dtype == torch.bfloat16:
        a = a.softmax(dim=-1)
    else:
        a = a.float().softmax(dim=-1).to(x.dtype)
    return linear((a @ v).transpose(1, 2).reshape(S, L, C), attn.proj)


def train_route(cfg: "TimeSformerConfig", compute_dtype: torch.dtype,
                route: str = "auto") -> str:
    """``"kernels"`` or ``"plain"``. The geometry gate is the JAX package's
    glue-free gate (models/timesformer.py:679-686) — divided attention,
    D % 128 == 0 and head dim < 128 — plus what the Hopper kernels take
    (head dim % 16 == 0, D <= 1024, qkv biases). ``route="auto"`` picks the
    kernel route for bf16 compute on that geometry, as JAX's ``should_fuse``
    does (bf16 only); every other geometry (vit_tiny's D = 192 among them)
    and f32 take the plain route. ``route="kernels"`` asks for the kernel
    route in bf16 or in f32 (the mixed tier, JAX's ``use_fused=True`` at
    f32) and raises where the gate refuses the geometry or the dtype. A
    static choice, not a fallback: on the kernel route a CUDA tensor
    launches the kernels or raises."""
    if route not in ("auto", "plain", "kernels"):
        raise ValueError(f"route {route!r}: 'auto', 'plain' or 'kernels'")
    if route == "plain":
        return route
    D, H = cfg.embed_dim, cfg.num_heads
    geometry = (cfg.attention_type == "divided_space_time"
                and D % 128 == 0 and D // H < 128 and D % H == 0
                and (D // H) % 16 == 0 and D <= 1024 and cfg.qkv_bias)
    if route == "auto":
        return "kernels" if geometry and compute_dtype == torch.bfloat16 else "plain"
    if not geometry:
        raise ValueError(
            f"route='kernels': D={D} with {H} heads (qkv_bias={cfg.qkv_bias}) is "
            "outside the kernels' gate (divided attention, D % 128 == 0, "
            "D <= 1024, head dim % 16 == 0 and < 128, qkv biases)")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"route='kernels': compute dtype {compute_dtype}, "
                         "expected bfloat16 or float32 (the mixed tier)")
    return route


def eval_kernels(cfg: "TimeSformerConfig", compute_dtype: torch.dtype, device) -> bool:
    """Whether a frozen-backbone consumer (the kNN and linear probes, the
    K400 classifier) runs the whole-block kernel pair
    (``TimeSformerConfig.use_kernels``): ``"auto"``, bf16 on a CUDA
    device, on the kernels' geometry (``train_route``'s gate) — the JAX
    CLIs' ``should_fuse`` with ``fused_wb=True`` and the glue-free gate.
    Anything else takes the plain route."""
    return (torch.device(device).type == "cuda"
            and train_route(cfg, compute_dtype, "auto") == "kernels")


# ---------------------------------------------------------------------------
# The XLA-layout block's phases (JAX models/timesformer.py:266-325)
# ---------------------------------------------------------------------------

def _fused(x: torch.Tensor, num_heads: Optional[int], use_fused: bool,
           kp: Optional[dict]) -> bool:
    """Whether a phase called with ``use_fused`` runs its kernel op: JAX's
    gate ``fused_ok`` (``fused_block.fused_ok``). It also admits f32 (the
    "mixed" tier: f32 carries, bf16 matmul operands); the port has no f32
    tier of these kernels yet, so such a tensor raises instead of running
    the plain formula. A bf16 geometry the kernels cannot take raises in
    the kernel op."""
    if not use_fused or not fused_block.fused_ok(x, num_heads):
        return False
    if kp is not None and fused_block.is_q8(kp):
        raise NotImplementedError(
            "use_fused on a quantized block: the per-phase kernels are "
            "float-only; a quantized model runs the whole-block pair "
            "(TimeSformerConfig.use_kernels), as JAX gates it")
    if x.dtype == torch.float32:
        raise NotImplementedError(
            "use_fused on f32 activations is the per-phase kernels' f32 "
            "('mixed') tier, which is not ported yet (ROADMAP queue 2 item "
            "A3); run use_fused in bf16")
    if kp is None:
        raise ValueError("use_fused needs the kernel-layout weights "
                         "(fused_block.block_params)")
    return True


def attn_phase(norm: nn.LayerNorm, attn: "Attention", x: torch.Tensor,
               num_heads: int, use_fused: bool = False,
               kp: Optional[dict] = None, mhsa_fn=mhsa) -> torch.Tensor:
    """LN -> MHSA over (S, L, D) sequences, no residual (JAX
    ``attn_phase``). With ``use_fused`` and the gate open, the kernel op
    ``fused_block.attn_phase`` with ``kp`` (``block_params(...)
    ["spatial"]``); otherwise ``mhsa_fn`` (``mhsa`` or ``mhsa_fused``)."""
    if _fused(x, num_heads, use_fused, kp):
        return fused_block.attn_phase(x.contiguous(), kp, num_heads)
    return mhsa_fn(layer_norm(x, norm.weight, norm.bias, norm.eps), attn.qkv,
                   attn.proj, num_heads)


def temporal_phase(norm: nn.LayerNorm, attn: "Attention", fc: nn.Linear,
                   x: torch.Tensor, num_heads: int, use_fused: bool = False,
                   kp: Optional[dict] = None, mhsa_fn=mhsa) -> torch.Tensor:
    """x + fc(MHSA(LN x)) over (S, T, D) sequences (JAX
    ``temporal_phase``). With ``use_fused`` and the gate open, the kernel
    op ``fused_block.temporal_phase`` with ``kp`` (``block_params(...)
    ["temporal"]``)."""
    if _fused(x, num_heads, use_fused, kp):
        return fused_block.temporal_phase(x.contiguous(), kp, num_heads)
    return x + fc(mhsa_fn(layer_norm(x, norm.weight, norm.bias, norm.eps),
                          attn.qkv, attn.proj, num_heads))


def _mlp_phase(norm: nn.LayerNorm, mlp: "Mlp", x: torch.Tensor,
               use_fused: bool, kp: Optional[dict], residual: bool):
    if _fused(x, None, use_fused, kp):
        D = x.shape[-1]
        out = fused_block.mlp_phase(x.reshape(-1, D).contiguous(), kp,
                                    residual=residual)
        return out.reshape(x.shape)
    y = mlp(layer_norm(x, norm.weight, norm.bias, norm.eps))
    return x + y if residual else y


def mlp_phase(norm: nn.LayerNorm, mlp: "Mlp", x: torch.Tensor,
              use_fused: bool = False, kp: Optional[dict] = None) -> torch.Tensor:
    """MLP(LN x), the feed-forward branch (JAX ``mlp_phase``); the kernel
    op ``fused_block.mlp_phase(residual=False)`` with ``use_fused``, ``kp``
    being ``block_params(...)["spatial"]``."""
    return _mlp_phase(norm, mlp, x, use_fused, kp, residual=False)


def mlp_phase_res(norm: nn.LayerNorm, mlp: "Mlp", x: torch.Tensor,
                  use_fused: bool = False,
                  kp: Optional[dict] = None) -> torch.Tensor:
    """x + MLP(LN x) (JAX ``mlp_phase_res``); the kernel op
    ``fused_block.mlp_phase(residual=True)`` with ``use_fused``."""
    return _mlp_phase(norm, mlp, x, use_fused, kp, residual=True)


def drop_path_masks(B: int, T: int, rate: float,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> tuple:
    """One block's stochastic-depth keep masks, 1.0 kept / 0.0 dropped,
    drawn with probability 1 - ``rate`` on the CPU from ``generator``: (per
    sample (B,) for the temporal branch, per (sample, frame) (B*T,) for the
    spatial branch, per sample (B,) for the MLP branch of CLS and grid
    alike), the shapes of JAX ``divided_block``'s three draws."""
    keep = torch.full((B + B * T + B,), 1.0 - rate)
    m = torch.bernoulli(keep, generator=generator).to(device)
    return m[:B], m[B:B + B * T], m[B + B * T:]


def _drop_path(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """x * mask / keep with one mask value per leading index (JAX
    ``_drop_path``)."""
    return x * mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1)) / keep


def interp_nearest_1d(src: torch.Tensor, out_len: int, axis: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') index rule floor(i*in/out),
    evaluated in float32 as the JAX package evaluates it."""
    in_len = src.shape[axis]
    ratio = torch.tensor(in_len / out_len, dtype=torch.float32)
    idx = torch.floor(torch.arange(out_len, dtype=torch.float32) * ratio).long()
    return torch.index_select(src, axis, idx.to(src.device))


def resize_pos_embed(pos_embed: torch.Tensor, n_tokens: int, W: int,
                     two_token: bool = False) -> torch.Tensor:
    """Nearest-resize of spatial pos embeddings with the reference's exact
    (quirky) geometry (ref: models/timesformer.py:292-303): the target grid
    is (n_tokens // W, W) where n_tokens counts the CLS token. With
    ``two_token`` the last row is the aux token's, kept as the CLS row is,
    and n_tokens counts both class tokens (ref: models/timesformer.py:
    533-545; JAX ``aux_token_forward_features``), so only a grid with
    W > 2 comes out at its own height."""
    end = pos_embed.shape[1] - (1 if two_token else 0)
    other = pos_embed[0, 1:end, :]
    P = int(math.isqrt(other.shape[0]))
    D = other.shape[1]
    H_new = n_tokens // W
    grid = other.reshape(P, P, D)
    grid = interp_nearest_1d(grid, H_new, axis=0)
    grid = interp_nearest_1d(grid, W, axis=1)
    return torch.cat([pos_embed[:, :1, :], grid.reshape(1, H_new * W, D),
                      pos_embed[:, end:, :]], dim=1)


def load_reference_state_dict(module: nn.Module, sd: Mapping[str, object]) -> None:
    """Load a reference-layout state dict (numpy arrays or tensors) into
    ``module``. Every parameter must be present; keys the module has no use
    for (a classifier head it does not build) are ignored, as the JAX
    converter ignores them. Values are cast to the parameters' dtype
    (round to nearest even for bf16)."""
    own = module.state_dict()
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
            if (v.dtype == torch.int8) != (t.dtype == torch.int8):
                raise TypeError(f"{k}: {v.dtype} into {t.dtype} (an int8 "
                                "state dict builds a quantized model: "
                                "build_timesformer)")
            t.copy_(v)


# ---------------------------------------------------------------------------
# Modules (reference state-dict layout)
# ---------------------------------------------------------------------------

class QuantLinear(nn.Module):
    """A dense layer of the int8 tier (JAX ``quantize_dense``'s output):
    ``weight`` the s8 codes (out, in), ``qscale`` their f32 per-channel
    scales, ``bias`` f32, all buffers; ``forward`` is ``quant.int8_linear``,
    output in x's dtype. ``build_timesformer`` puts these in place after it
    casts the model to its dtype; a later ``.to(dtype)`` would cast the
    scales and bias too."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features,
                                                   dtype=torch.int8))
        self.register_buffer("qscale", torch.zeros(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.int8_linear(x, self.weight, self.qscale, self.bias)


def quantize_blocks(model: "TimeSformer") -> None:
    """Replace every block's ``quant.BLOCK_DENSE`` layers by ``QuantLinear``
    modules of the same shapes (zeros until a quantized state dict loads)."""
    for blk in model.blocks:
        for name in quant.BLOCK_DENSE:
            parent, _, attr = name.rpartition(".")
            owner = blk.get_submodule(parent) if parent else blk
            lin = getattr(owner, attr)
            with torch.device(lin.weight.device):
                setattr(owner, attr, QuantLinear(lin.in_features, lin.out_features,
                                                 lin.bias is not None))


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

    def forward_train(self, frames: torch.Tensor) -> torch.Tensor:
        """``forward`` with the master weights cast to the frames' dtype
        (matmul, then bias), as the JAX ``patch_embed`` runs."""
        BT, H, W, C = frames.shape
        ps = self.patch_size
        gh, gw = H // ps, W // ps
        x = frames.reshape(BT, gh, ps, gw, ps, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(BT, gh * gw, ps * ps * C)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return torch.matmul(x, w.to(x.dtype).t()) + self.proj.bias.to(x.dtype)


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
        self.mhsa_fn = attention.mhsa_fused if cfg.attention_kernel else mhsa

    def _ln(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, norm.weight, norm.bias, self.eps)

    def forward(self, cls: torch.Tensor, grid: torch.Tensor, B: int, T: int,
                N: int, use_fused: bool = False, kp: Optional[dict] = None,
                drop_path_rate: float = 0.0, masks: Optional[tuple] = None):
        """Plain inference route, the JAX XLA ``divided_block``. cls (B, 1,
        D); grid (B, N*T, D) in (h w t) order. The CLS row and the grid
        travel separately; every residual and the MLP are position-wise, so
        values equal the reference's concatenated sequence.

        ``use_fused``: each phase through its kernel op where the gate
        admits it, with ``kp`` this block's ``block_params`` (built here
        when not given). ``drop_path_rate`` > 0 with ``masks`` (from
        ``drop_path_masks``) runs JAX's drop-path branch, whose only kernel
        op is the spatial ``attn_phase``."""
        D = grid.shape[-1]
        H = self.num_heads
        mh = self.mhsa_fn
        if use_fused and kp is None:
            kp = fused_block.block_params(self)
        kt, ks = (kp["temporal"], kp["spatial"]) if use_fused else (None, None)
        dp = drop_path_rate > 0.0
        if dp and masks is None:
            raise ValueError("a drop-path rate needs masks (drop_path_masks)")
        keep = 1.0 - drop_path_rate
        # temporal attention over T at each spatial position
        xt = grid.reshape(B * N, T, D)
        if not dp:
            xt = temporal_phase(self.temporal_norm1, self.temporal_attn,
                                self.temporal_fc, xt, H, use_fused, kt, mh)
            xt = xt.reshape(B, N * T, D)
        else:
            res_t = attn_phase(self.temporal_norm1, self.temporal_attn, xt, H,
                               mhsa_fn=mh).reshape(B, N * T, D)
            xt = grid + self.temporal_fc(_drop_path(res_t, masks[0], keep))
        # spatial attention over [CLS, H*W] per frame
        cls_rep = cls.expand(B, T, D).reshape(B * T, 1, D)
        xs = xt.reshape(B, N, T, D).transpose(1, 2).reshape(B * T, N, D)
        xs = torch.cat([cls_rep, xs], dim=1)
        res_s = attn_phase(self.norm1, self.attn, xs, H, use_fused, ks, mh)
        if dp:
            res_s = _drop_path(res_s, masks[1], keep)
        # CLS averaged over frames (ref: models/timesformer.py:161-164)
        cls_out = res_s[:, 0, :].reshape(B, T, D).mean(dim=1, keepdim=True)
        res_sp = res_s[:, 1:, :].reshape(B, T, N, D).transpose(1, 2).reshape(
            B, N * T, D)
        cls = cls + cls_out
        grid = xt + res_sp
        if not dp:
            cls = mlp_phase_res(self.norm2, self.mlp, cls, use_fused, ks)
            grid = mlp_phase_res(self.norm2, self.mlp, grid, use_fused, ks)
        else:
            # one per-sample mask for CLS and grid, as JAX draws the same
            # mask for both (masking the concatenated sequence)
            cls = cls + _drop_path(mlp_phase(self.norm2, self.mlp, cls),
                                   masks[2], keep)
            grid = grid + _drop_path(mlp_phase(self.norm2, self.mlp, grid),
                                     masks[2], keep)
        return cls, grid

    def _mlp_train(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.mlp.fc1)), self.mlp.fc2)

    def forward_plain_train(self, cls: torch.Tensor, grid: torch.Tensor,
                            B: int, T: int, N: int):
        """Training, plain route: the JAX XLA ``divided_block`` without
        drop-path in x's dtype, the f32 master weights cast where JAX casts
        them. cls (B, 1, D); grid (B, N*T, D) in (h w t) order."""
        D = grid.shape[-1]
        H = self.num_heads
        xt = grid.reshape(B * N, T, D)
        xt = xt + linear(mhsa_train(self._ln(self.temporal_norm1, xt),
                                    self.temporal_attn, H), self.temporal_fc)
        xt = xt.reshape(B, N * T, D)
        cls_rep = cls.expand(B, T, D).reshape(B * T, 1, D)
        xs = xt.reshape(B, N, T, D).transpose(1, 2).reshape(B * T, N, D)
        xs = torch.cat([cls_rep, xs], dim=1)
        res_s = mhsa_train(self._ln(self.norm1, xs), self.attn, H)
        cls_out = res_s[:, 0, :].reshape(B, T, D).mean(dim=1, keepdim=True)
        res_sp = res_s[:, 1:, :].reshape(B, T, N, D).transpose(1, 2).reshape(
            B, N * T, D)
        cls = cls + cls_out
        grid = xt + res_sp
        cls = cls + self._mlp_train(self._ln(self.norm2, cls))
        grid = grid + self._mlp_train(self._ln(self.norm2, grid))
        return cls, grid

    def forward_two_token(self, x: torch.Tensor, B: int, T: int, N: int) -> torch.Tensor:
        """The two-token block (JAX ``divided_block_two_token``, ref:
        models/timesformer.py:124-185 with two class tokens), plain, in x's
        dtype: x (B, 1 + N*T + 1, D) in the token layout [CLS, (h w t),
        AUX]; both class tokens join every frame's spatial attention and
        their outputs are averaged over the frames."""
        D = x.shape[-1]
        H = self.num_heads
        grid = x[:, 1:-1, :]
        xt = grid.reshape(B * N, T, D)
        res_t = mhsa_train(self._ln(self.temporal_norm1, xt), self.temporal_attn, H)
        xt = grid + linear(res_t.reshape(B, N * T, D), self.temporal_fc)
        init_cls, init_aux = x[:, :1, :], x[:, -1:, :]
        cls_rep = init_cls.expand(B, T, D).reshape(B * T, 1, D)
        aux_rep = init_aux.expand(B, T, D).reshape(B * T, 1, D)
        xs = xt.reshape(B, N, T, D).transpose(1, 2).reshape(B * T, N, D)
        xs = torch.cat([cls_rep, xs, aux_rep], dim=1)
        res_s = mhsa_train(self._ln(self.norm1, xs), self.attn, H)
        cls_out = res_s[:, 0, :].reshape(B, T, D).mean(dim=1, keepdim=True)
        aux_out = res_s[:, -1, :].reshape(B, T, D).mean(dim=1, keepdim=True)
        res_sp = res_s[:, 1:-1, :].reshape(B, T, N, D).transpose(1, 2).reshape(
            B, N * T, D)
        x = torch.cat([init_cls + cls_out, xt + res_sp, init_aux + aux_out], dim=1)
        return x + self._mlp_train(self._ln(self.norm2, x))

    def forward_kernels(self, cls: torch.Tensor, grid: torch.Tensor):
        """Training, kernel route (the JAX ``divided_block_fused``): cls
        (B, 1, D) and the frame-major grid (B, T, N, D), both bf16 or both
        f32 (the mixed tier), through the three per-phase autograd
        Functions; the CLS update stays plain torch, in their dtype."""
        B, T, N, D = grid.shape
        H = self.num_heads
        ta, sa = self.temporal_attn, self.attn
        grid = fused_block.TemporalPhaseTm.apply(
            grid, H, self.temporal_norm1.weight, self.temporal_norm1.bias,
            ta.qkv.weight, ta.qkv.bias, ta.proj.weight, ta.proj.bias,
            self.temporal_fc.weight, self.temporal_fc.bias)
        grid, cls_frames = fused_block.SpatialPhase.apply(
            grid, cls, H, self.norm1.weight, self.norm1.bias, sa.qkv.weight,
            sa.qkv.bias, sa.proj.weight, sa.proj.bias)
        cls = cls + cls_frames.mean(dim=1, keepdim=True)
        mlp = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
               self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)
        grid = fused_block.MlpPhase.apply(grid.reshape(B * T * N, D), True,
                                          *mlp).reshape(B, T, N, D)
        cls = fused_block.MlpPhase.apply(cls.reshape(B, D), True,
                                         *mlp).reshape(B, 1, D)
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
        load_reference_state_dict(self, sd)

    @property
    def quantized(self) -> bool:
        return isinstance(self.blocks[0].mlp.fc1, QuantLinear)

    def kernel_params(self) -> list:
        """Per-block weights in the kernels' layout (bf16 matrices, f32
        vectors; s8 codes and f32 scales where quantized), rebuilt whenever
        a parameter or buffer is replaced or written."""
        key = tuple((p.data_ptr(), p._version)
                    for p in [*self.parameters(), *self.buffers()])
        if key != self._kp_key:
            self._kp = [fused_block.block_params(b) for b in self.blocks]
            self._kp_key = key
        return self._kp

    def tokens(self, x: torch.Tensor):
        """x (B, C, T, H, W) -> (cls (B, 1, D), grid (B, T, N, D)
        frame-major), the blocks' input after the patch, position and time
        embeddings, in the dtype of the module's parameters."""
        cfg = self.cfg
        B, C, T, Himg, Wimg = x.shape
        ps = cfg.patch_size
        W = Wimg // ps
        N = (Himg // ps) * W
        D = cfg.embed_dim
        x = x.to(self.pos_embed.dtype)
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
        # the CLS row is identical across frames before mixing
        return xt[:B, :1, :], xt[:, 1:, :].reshape(B, T, N, D) + te[:, :, None, :]

    def forward_features(self, x: torch.Tensor,
                         get_all: bool = False) -> torch.Tensor:
        """x (B, C, T, H, W) -> (B, D) CLS features, or (B, 1+N*T, D) in
        the reference token order [CLS, (h w t)] when ``get_all``. Runs in
        the dtype of the module's parameters."""
        cfg = self.cfg
        dtype = self.pos_embed.dtype
        cls_tok, grid = self.tokens(x)
        B, T, N, D = grid.shape

        if cfg.use_kernels:
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

        # 'b t n m -> b (n t) m'
        spat = grid.transpose(1, 2).reshape(B, N * T, D)
        for blk in self.blocks:
            cls_tok, spat = blk(cls_tok, spat, B, T, N)
        if get_all:
            x = torch.cat([cls_tok, spat], dim=1)
            return layer_norm(x, self.norm.weight, self.norm.bias, cfg.norm_eps)
        # only the CLS row is consumed: LN is per token
        return layer_norm(cls_tok, self.norm.weight, self.norm.bias,
                          cfg.norm_eps)[:, 0]

    def forward_train(self, x: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32,
                      route: str = "plain", remat: bool = False) -> torch.Tensor:
        """Differentiable training forward (the JAX ``forward`` with
        ``train=False``, as the JAX train step calls it): x (B, C, T, H, W)
        -> (B, D) CLS features in ``compute_dtype``, the f32 parameters
        cast where JAX casts them. ``route``: ``"plain"`` or ``"kernels"``
        (``train_route``; with f32 compute the kernel route is the mixed
        tier). ``remat``: each block rematerialized (``checkpoint_block``),
        the same values."""
        if route not in ("plain", "kernels"):
            raise ValueError(f"route {route!r}: 'plain' or 'kernels'")
        if self.quantized:
            raise NotImplementedError("a quantized model serves inference only")
        cfg = self.cfg
        B, C, T, Himg, Wimg = x.shape
        W = Wimg // cfg.patch_size
        N = (Himg // cfg.patch_size) * W
        D = cfg.embed_dim
        cd = compute_dtype

        x = x.to(cd)
        frames = x.permute(0, 2, 3, 4, 1).reshape(B * T, Himg, Wimg, C)
        tok = self.patch_embed.forward_train(frames)  # (BT, N, D)
        cls = self.cls_token.to(cd).expand(B * T, 1, D)
        xt = torch.cat([cls, tok], dim=1)
        pe = self.pos_embed
        if xt.shape[1] != pe.shape[1]:
            pe = resize_pos_embed(pe, xt.shape[1], W)
        xt = xt + pe.to(cd)
        te = self.time_embed
        if T != te.shape[1]:
            te = interp_nearest_1d(te, T, axis=1)
        te = te.to(cd)
        cls_tok = xt[:B, :1, :]  # identical across frames before mixing

        if route == "kernels":
            grid = (xt[:, 1:, :].reshape(B, T, N, D) + te[:, :, None, :]).contiguous()
            cls_tok = cls_tok.contiguous()
            for blk in self.blocks:
                cls_tok, grid = checkpoint_block(remat, blk.forward_kernels, cls_tok, grid)
        else:
            spat = xt[:, 1:, :].reshape(B, T, N, D).transpose(1, 2).reshape(
                B * N, T, D)
            spat = (spat + te).reshape(B, N * T, D)
            for blk in self.blocks:
                cls_tok, spat = checkpoint_block(remat, blk.forward_plain_train,
                                                 cls_tok, spat, B, T, N)
        return layer_norm(cls_tok, self.norm.weight, self.norm.bias,
                          cfg.norm_eps)[:, 0]

    def forward(self, x: torch.Tensor, use_head: bool = False) -> torch.Tensor:
        """(ref: models/timesformer.py:347-351)."""
        feats = self.forward_features(x)
        if use_head and self.head is not None:
            feats = self.head(feats)
        return feats


def checkpoint_block(remat: bool, fn, *args):
    """``fn(*args)``, one block of a training forward; with ``remat`` under
    ``torch.utils.checkpoint`` (non-reentrant): the block keeps only its
    inputs and reruns its forward when the backward needs what it saved.
    A block is the unit whose activations the kernels' autograd Functions
    and the plain route's ops save, so this is the granularity that bounds
    the saved activations by one block's. Early stop is off, so the rerun
    runs the whole block (each per-phase launch twice)."""
    if not remat:
        return fn(*args)
    from torch.utils import checkpoint

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(fn, *args, use_reentrant=False)


TWO_TOKEN_PLAIN_ONLY = (
    "the two-token backbone runs the plain route only: its JAX block "
    "(divided_block_two_token) is XLA code with no Pallas kernel, so no "
    "Hopper kernel of the port serves it")


class AuxTokenTimeSformer(TimeSformer):
    """The two-token (aux-token) backbone (ref: models/timesformer.py:427-583;
    JAX ``init_aux_token_timesformer`` / ``aux_token_forward_features``): a
    second class token ``aux_cls_token`` (1, 1, D) and ``pos_embed`` widened
    to num_patches + 2 rows (CLS, the patches, AUX). Every block is
    ``Block.forward_two_token`` on the plain route, in f32 or bf16; the
    kernel route raises (``TWO_TOKEN_PLAIN_ONLY``)."""

    def __init__(self, cfg: TimeSformerConfig):
        if cfg.use_kernels:
            raise ValueError(TWO_TOKEN_PLAIN_ONLY)
        super().__init__(cfg)
        D = cfg.embed_dim
        self.aux_cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 2, D))

    def forward_features(self, x: torch.Tensor, get_all: bool = False,
                         training: bool = True,
                         compute_dtype: Optional[torch.dtype] = None,
                         route: str = "plain"):
        """x (B, C, T, H, W) -> (cls, aux) features (B, D) each when
        ``training``, else their concatenation (B, 2D); with ``get_all`` the
        whole normalized sequence (B, 1 + N*T + 1, D). Differentiable, in
        ``compute_dtype`` (default: the parameters'), the parameters cast
        where JAX casts them."""
        if route != "plain":
            raise ValueError(f"route={route!r}: {TWO_TOKEN_PLAIN_ONLY}")
        cfg = self.cfg
        cd = compute_dtype or self.pos_embed.dtype
        B, C, T, Himg, Wimg = x.shape
        W = Wimg // cfg.patch_size
        N = (Himg // cfg.patch_size) * W
        D = cfg.embed_dim
        x = x.to(cd)
        frames = x.permute(0, 2, 3, 4, 1).reshape(B * T, Himg, Wimg, C)
        tok = self.patch_embed.forward_train(frames)  # (BT, N, D)
        cls = self.cls_token.to(cd).expand(B * T, 1, D)
        aux = self.aux_cls_token.to(cd).expand(B * T, 1, D)
        xt = torch.cat([cls, tok, aux], dim=1)
        pe = self.pos_embed
        if xt.shape[1] != pe.shape[1]:
            pe = resize_pos_embed(pe, xt.shape[1], W, two_token=True)
        xt = xt + pe.to(cd)
        te = self.time_embed
        if T != te.shape[1]:
            te = interp_nearest_1d(te, T, axis=1)
        spat = xt[:, 1:-1, :].reshape(B, T, N, D).transpose(1, 2).reshape(B * N, T, D)
        spat = (spat + te.to(cd)).reshape(B, N * T, D)
        # the class rows of the first B frame rows, as the reference takes
        # them (identical across frames before mixing)
        x = torch.cat([xt[:B, :1, :], spat, xt[:B, -1:, :]], dim=1)
        for blk in self.blocks:
            x = blk.forward_two_token(x, B, T, N)
        if get_all:
            return layer_norm(x, self.norm.weight, self.norm.bias, cfg.norm_eps)
        # only the two class rows are read: LN is per token
        ends = layer_norm(x[:, [0, -1], :], self.norm.weight, self.norm.bias,
                          cfg.norm_eps)
        if not training:
            return torch.cat([ends[:, 0], ends[:, 1]], dim=1)
        return ends[:, 0], ends[:, 1]

    def forward_train(self, x: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32,
                      route: str = "plain", remat: bool = False):
        """The training forward: (cls, aux) features in ``compute_dtype``.
        ``remat`` must be False: JAX's two-token step never rematerializes."""
        if remat:
            raise ValueError("the two-token backbone has no rematerialized forward")
        return self.forward_features(x, training=True, compute_dtype=compute_dtype,
                                     route=route)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The evaluation features: CLS and AUX concatenated (B, 2D)."""
        return self.forward_features(x, training=False)


def build_timesformer(cfg: TimeSformerConfig, state_dict: Mapping[str, object],
                      device=None, dtype: Optional[torch.dtype] = None
                      ) -> TimeSformer:
    """Build on ``device`` (default: the CUDA card), cast to ``dtype`` and
    load a reference-layout state dict. Inference mode (``eval``). A state
    dict from ``quant.quantize_state_dict_int8`` builds the quantized model
    (``QuantLinear`` blocks), the rest cast to ``dtype``."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = TimeSformer(cfg)
    if dtype is not None:
        model = model.to(dtype)
    if quant.is_quantized(state_dict):
        quantize_blocks(model)
    model.load_reference_state_dict(state_dict)
    return model.eval()


def init_timesformer(cfg: TimeSformerConfig, generator: torch.Generator,
                     device=None) -> TimeSformer:
    """Fresh f32 parameters with the JAX package's ``init_timesformer``
    rules, drawn from ``generator`` on the CPU, then moved to ``device``
    (default: the CUDA card): truncated normals (std 0.02, cut at 2 std)
    for the linear kernels, the patch embedding, ``cls_token`` and
    ``pos_embed``; zero biases and ``time_embed``; LayerNorms at 1 and 0;
    ``temporal_fc`` zero in blocks after the first (the reference's
    zero-init quirk, ref: models/timesformer.py:254-263). The numbers
    differ from JAX's for the same seed; tests that compare the two load
    ``utils/synthetic.make_numpy_params`` into both."""
    from ..utils.device import resolve_device

    with torch.device("cpu"):
        model = TimeSformer(cfg)
    _init_weights(model, generator)
    return model.to(resolve_device(device))


def init_aux_token_timesformer(cfg: TimeSformerConfig, generator: torch.Generator,
                               device=None) -> AuxTokenTimeSformer:
    """Fresh f32 parameters of the two-token backbone (JAX
    ``init_aux_token_timesformer``): ``init_timesformer``'s rules, drawn from
    ``generator`` on the CPU, with ``pos_embed`` at its widened shape and a
    truncated-normal ``aux_cls_token``; then moved to ``device``."""
    from ..utils.device import resolve_device

    with torch.device("cpu"):
        model = AuxTokenTimeSformer(cfg)
    _init_weights(model, generator)
    with torch.no_grad():
        _trunc_normal(model.aux_cls_token, generator)
    return model.to(resolve_device(device))


def _trunc_normal(t: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)


def _init_weights(model: TimeSformer, generator: torch.Generator) -> None:
    """``init_timesformer``'s rules, in place."""
    def tn(t):
        _trunc_normal(t, generator)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                tn(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
        tn(model.cls_token)
        tn(model.pos_embed)
        model.time_embed.zero_()
        for blk in list(model.blocks)[1:]:
            blk.temporal_fc.weight.zero_()
            blk.temporal_fc.bias.zero_()
