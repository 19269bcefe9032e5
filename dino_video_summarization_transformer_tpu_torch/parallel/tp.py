"""Tensor parallelism (Megatron pairing) over the mesh's model axis
(counterpart of the JAX package's ``parallel/tp.py``).

The rules, by parameter name (``tp_spec``), in the port's (out, in)
layout, where JAX's "last axis" of an (in, out) kernel is dim 0:

* column-parallel: ``qkv`` and ``fc1`` weights and biases shard their
  output features (dim 0): the backbone blocks' and the DINO head's hidden
  layer (``head.mlp.2``, JAX ``fc1``);
* row-parallel: the ``proj`` weight (not ``patch_embed.proj``) and the
  ``fc2`` weight (the blocks' and ``head.mlp.4``, JAX ``fc2``) shard their
  input features (dim 1); their biases stay replicated and are added once,
  after the reduce;
* the weight-normed last layer's ``weight_v`` (out, in) and ``weight_g``
  (out, 1) shard their output units (dim 0);
* everything else (LayerNorms, embeddings, ``temporal_fc``, the head's
  first layer, ``cnn_proj``) is replicated, and so is a dimension the axis
  does not divide.

The same names cover the student, the teacher and the optimizer's moments,
so one spec shards the whole state (``models/convert.shard_state_dict``).

A qkv shard holds whole heads: its rows are the head-major permutation's
(``tp_fused.qkv_head_perm``: [q | k | v] of the shard's heads), as JAX's
TP-fused path lays them out, and the plain route here uses the same
layout (GSPMD computes the plain route over any layout; a hand-written
shard needs its heads whole).

The plain route (``tp_forward_features``, JAX's XLA TP path) is the
one-card plain training forward (``Block.forward_plain_train``) with the
linear hook ``sharded_linear``: the linears run column- and row-parallel
with the autograd-aware collectives, ``copy_to_model`` (identity forward,
all-reduce of the gradient over the model group backward) on a
column-parallel layer's input and ``reduce_from_model`` (all-reduce
forward, identity backward) on a row-parallel layer's output. ``head_forward`` runs the DINO head the same
way and gathers the last layer's logits over the model group before the
softmax and centering (``gather_from_model``: an all-reduce of a
zero-filled full tensor, which gloo takes on CUDA; its backward keeps the
shard's columns). Collectives sum in f32.

The port takes TP where every Megatron pair is sharded: the heads and the
MLP and head widths divisible by the axis (``check_divisible``); JAX's
GSPMD also runs a model whose heads the axis does not divide (ROADMAP
section 3).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from .mesh import Mesh, all_reduce


def _module_of(parts) -> str:
    """The JAX module name of a parameter's path: the head's Sequential
    ``mlp.{2i}`` is its ``fc{i}``."""
    module = parts[-2] if len(parts) >= 2 else ""
    if module.isdigit() and len(parts) >= 3 and parts[-3] == "mlp":
        return f"fc{int(module) // 2}"
    return module


def rule_dim(name: str) -> Optional[int]:
    """The dim the Megatron rules shard for parameter ``name`` (before the
    divisibility check), or None."""
    parts = name.split(".")
    pname = parts[-1]
    module = _module_of(parts)
    if module in ("qkv", "fc1") and pname in ("weight", "bias"):
        return 0
    if module == "proj" and pname == "weight" and "patch_embed" not in parts:
        return 1
    if module == "fc2" and pname == "weight":
        return 1
    if module == "last_layer" and pname in ("weight_v", "weight_g"):
        return 0
    return None


def tp_spec(name: str, shape, tp: int) -> Optional[int]:
    """The dim of parameter ``name`` (full ``shape``) sharded over a model
    axis of ``tp`` ranks, or None (replicated): ``rule_dim`` where the axis
    divides that dimension (JAX ``_spec_for_path``)."""
    dim = rule_dim(name)
    if dim is None or dim >= len(shape) or shape[dim] % tp:
        return None
    return dim


def check_divisible(named: Mapping[str, torch.Tensor], tp: int, num_heads: int) -> None:
    """Raise unless the port's TP forwards can run the model over ``tp``
    ranks: every Megatron pair sharded and each qkv shard whole heads."""
    if num_heads % tp:
        raise ValueError(f"--model_parallel {tp} does not divide the {num_heads} heads: "
                         "a qkv shard of the port holds whole heads")
    left = [n for n, t in named.items()
            if rule_dim(n) is not None and tp_spec(n, tuple(t.shape), tp) is None]
    if left:
        raise ValueError(f"--model_parallel {tp} does not divide {left[:3]}: the port's "
                         "TP forwards take every Megatron pair sharded")


# ---------------------------------------------------------------------------
# The collectives of the model axis, as autograd functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward, gradient summed over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The shards' columns side by side along the last dim (an all-reduce
    of a zero-filled full tensor); backward keeps the shard's columns."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        w = x.shape[-1]
        ctx.lo, ctx.w = index * w, w
        full = x.new_zeros(x.shape[:-1] + (w * n,))
        full[..., ctx.lo:ctx.lo + w] = x
        return all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.w].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.model_group is None else _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.model_group is None else _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.model_group is None:
        return x
    return _GatherFromModel.apply(x, mesh.model_group, mesh.model_index, mesh.model)


# ---------------------------------------------------------------------------
# The plain route
# ---------------------------------------------------------------------------

def sharded_linear(mesh: Mesh):
    """The plain training forwards' linear hook (``timesformer.whole_linear``)
    on the rank's shards: a "column" layer (qkv, fc1) on its input copied
    to the model group, a "row" layer (proj, fc2) as the shard's partial
    product summed over the model group, then the replicated bias once; a
    replicated layer whole. The values are the unsharded layer's."""
    from ..models.timesformer import linear

    def lin(x: torch.Tensor, layer, parallel: Optional[str] = None) -> torch.Tensor:
        if parallel == "column":
            return linear(copy_to_model(x, mesh), layer)
        if parallel == "row":
            y = reduce_from_model(torch.matmul(x, layer.weight.to(x.dtype).t()), mesh)
            return y + layer.bias.to(x.dtype)
        return linear(x, layer)

    return lin


def tp_forward_features(backbone, x: torch.Tensor, cfg, mesh: Mesh,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain route's training forward (``TimeSformer.forward_train``
    with route "plain") on a backbone whose qkv, fc1, proj and fc2 are the
    rank's shards (``models/convert.shard_state_dict``): replicated
    embedding, sharded blocks, replicated final LN. -> (B, D) CLS features,
    the same on every rank of the model group; differentiable."""
    heads, lin = cfg.num_heads // mesh.model, sharded_linear(mesh)
    cls_tok, grid = backbone.train_tokens(x, compute_dtype)
    B, T, N, D = grid.shape
    spat = grid.transpose(1, 2).reshape(B, N * T, D)
    for blk in backbone.blocks:
        cls_tok, spat = blk.forward_plain_train(cls_tok, spat, B, T, N, lin, heads)
    return backbone.final_norm(cls_tok)


def head_forward(head, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``DINOHead.forward`` on the rank's shards (JAX ``dino_head_forward``
    under the head's TP specs): the first layer replicated, the hidden
    layer column-parallel, the bottleneck row-parallel, the weight-normed
    last layer over the rank's output units; -> the full (rows, out_dim)
    logits, gathered over the model group."""
    lin, layers = sharded_linear(mesh), head.linears()
    for i, layer in enumerate(layers):
        dim = rule_dim(f"mlp.{2 * i}.weight") if len(layers) > 1 else None
        x = lin(x, layer, {0: "column", 1: "row"}.get(dim))
        if i < len(layers) - 1:
            x = F.gelu(x)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    logits = torch.matmul(copy_to_model(x, mesh), head.last_layer.weight().to(x.dtype).t())
    return gather_from_model(logits, mesh)
