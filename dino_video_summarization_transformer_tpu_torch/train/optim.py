"""Optimizers and gradient utilities as plain tensor code over a
name -> tensor dict (counterpart of the JAX package's ``train/optim.py``,
which builds them from optax; ref: train_ssl.py:377-388,
utils/utils.py:102-119, 523-561, 612-623).

The JAX package holds the blocks stacked along a depth axis, so each of
its leaves ``blocks/<name>`` spans every block. Two of its rules act per
leaf and so across the blocks: the gradient clip's norm and LARS's trust
ratio. The port keeps one tensor per block and reproduces both through
``leaf_groups`` (``blocks.<i>.`` -> ``blocks.*.``), so its numbers equal
the JAX package's; the reference clips and adapts per block tensor
(ROADMAP section 3).

Sharded states (``apply_updates_with_schedules(..., sharding=...)``, the
``parallel`` modules): under tensor parallelism a leaf's norm is over the
whole tensor, its shards' sums of squares added over the model group
(``NormReduce``); under ZeRO-1 the norms are taken on the whole replicated
tensors and only the elementwise moment update runs on the rank's slices
(``Optimizer.adapt`` then ``Optimizer.moments``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, FrozenSet, Optional

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]

_NO_DECAY = ("cls_token", "pos_embed", "time_embed", "weight_g")
_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.")


def leaf_groups(names) -> Dict[str, str]:
    """Parameter name -> the JAX leaf it belongs to (all blocks' copies of
    one block parameter share a leaf)."""
    return {n: _BLOCK.sub(r"\1blocks.*.", n) for n in names}


def jax_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of the JAX leaf: block parameters gain the depth axis,
    ``weight_g`` is (out,) there and (out, 1) here."""
    if name.endswith("weight_g"):
        return 1
    return p.dim() + (1 if _BLOCK.search(name) else 0)


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the parameters that take weight decay, the JAX package's
    ``wd_mask`` leaf for leaf: not biases, LayerNorm scales, ``cls_token``,
    ``pos_embed``, ``time_embed`` or ``weight_g``, and only leaves of rank
    >= 2 (ref: utils/utils.py:612-623)."""
    mask = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            mask[name] = not (pname == "bias" or isinstance(mod, nn.LayerNorm)
                              or pname in _NO_DECAY) and jax_ndim(name, p) >= 2
    return mask


@dataclasses.dataclass
class NormReduce:
    """The tensors that are shards of a larger one (``sharded``) and the
    sum over the ranks holding its other shards (``reduce``, applied to a
    stack of sums of squares): a leaf's norm then covers the whole tensor."""
    sharded: FrozenSet[str]
    reduce: Callable[[torch.Tensor], torch.Tensor]


def _group_norms(ts: Tensors, groups: Dict[str, str],
                 norm_reduce: Optional[NormReduce] = None) -> Tensors:
    sq: Tensors = {}
    part: Tensors = {}  # the shards' sums of squares, summed over their ranks below
    for n, t in ts.items():
        s = t.float().square().sum()
        acc = part if norm_reduce is not None and n in norm_reduce.sharded else sq
        acc[groups[n]] = acc[groups[n]] + s if groups[n] in acc else s
    if part:
        keys = list(part)
        for g, v in zip(keys, norm_reduce.reduce(torch.stack([part[g] for g in keys])).unbind(0)):
            sq[g] = sq[g] + v if g in sq else v
    return {g: v.sqrt() for g, v in sq.items()}


def per_param_clip(grads: Tensors, clip: float,
                   groups: Optional[Dict[str, str]] = None,
                   norm_reduce: Optional[NormReduce] = None) -> Tensors:
    """Each leaf's gradient scaled by min(clip / (||g|| + 1e-6), 1) —
    per leaf, not global-norm clipping (ref: utils/utils.py:102-111)."""
    groups = groups or leaf_groups(grads)
    norms = _group_norms(grads, groups, norm_reduce)
    return {n: (g * torch.clamp(clip / (norms[groups[n]] + 1e-6), max=1.0)).to(g.dtype)
            for n, g in grads.items()}


class Optimizer:
    """The core transform of AdamW / SGD-momentum / LARS, applied with unit
    learning rate (``apply_updates_with_schedules`` scales by -lr):

    * ``adamw``: optax ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, no
      eps_root): bias-corrected m / (sqrt(v) + eps);
    * ``sgd``: optax ``trace`` (momentum, no Nesterov): t = g + momentum * t;
    * ``lars``: the reference's Barlow-Twins LARS (eta 0.001): the trust
      ratio eta * ||p|| / ||g|| on leaves of rank != 1, then momentum.
    """

    def __init__(self, name: str, momentum: float = 0.9):
        if name not in ("adamw", "sgd", "lars"):
            raise ValueError(f"unknown optimizer {name}")
        self.name = name
        self.momentum = momentum
        self.b1, self.b2, self.eps, self.eta = 0.9, 0.999, 1e-8, 0.001

    def init(self, params: Tensors) -> dict:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        if self.name == "adamw":
            dev = next(iter(params.values())).device
            return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": zeros(), "nu": zeros()}
        return {"trace" if self.name == "sgd" else "mu": zeros()}

    def update(self, grads: Tensors, state: dict, params: Tensors,
               groups: Dict[str, str], norm_reduce: Optional[NormReduce] = None):
        """-> (updates, new state)."""
        return self.moments(self.adapt(grads, params, groups, norm_reduce), state)

    def adapt(self, grads: Tensors, params: Tensors, groups: Dict[str, str],
              norm_reduce: Optional[NormReduce] = None) -> Tensors:
        """LARS's trust ratio eta * ||p|| / ||g|| on the leaves of rank != 1
        (the gradients as they are for AdamW and SGD)."""
        if self.name != "lars":
            return grads
        adapt = {n for n in grads if jax_ndim(n, params[n]) != 1}
        pn = _group_norms({n: params[n] for n in adapt}, groups, norm_reduce)
        un = _group_norms({n: grads[n] for n in adapt}, groups, norm_reduce)
        adapted = {}
        for n, g in grads.items():
            if n not in adapt:
                adapted[n] = g
                continue
            p_, u_ = pn[groups[n]], un[groups[n]]
            one = torch.ones_like(p_)
            q = torch.where(p_ > 0, torch.where(u_ > 0, self.eta * p_ / u_, one), one)
            adapted[n] = g * q
        return adapted

    def moments(self, grads: Tensors, state: dict):
        """The elementwise half: -> (updates, new state)."""
        if self.name == "adamw":
            b1, b2 = self.b1, self.b2
            count = state["count"] + 1
            c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count
            c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count
            mu = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in grads.items()}
            nu = {n: (1 - b2) * g * g + b2 * state["nu"][n] for n, g in grads.items()}
            upd = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps)
                   for n in grads}
            return upd, {"count": count, "mu": mu, "nu": nu}
        if self.name == "sgd":
            tr = {n: g + self.momentum * state["trace"][n] for n, g in grads.items()}
            return tr, {"trace": tr}
        mu = {n: state["mu"][n] * self.momentum + d for n, d in grads.items()}
        return mu, {"mu": mu}


@torch.no_grad()
def apply_updates_with_schedules(params: Tensors, grads: Tensors, opt_state: dict,
                                 core: Optimizer, mask: Dict[str, bool],
                                 lr: float, wd: float,
                                 clip: Optional[float] = None,
                                 freeze_last_layer: Optional[bool] = None,
                                 sharding=None) -> dict:
    """One optimizer step in the JAX package's order (its
    ``train/optim.py:121-166``): per-leaf clip, then g + wd * p on the
    masked subset, then the ``last_layer`` gradients zeroed when frozen,
    then the core transform, then p += -lr * u. The parameters are updated
    in place; returns the new optimizer state.

    A frozen leaf's zeroed gradient still goes through the core, as in
    optax: Adam's moments decay and the leaf moves while they are non-zero
    (the JAX comment at ``:149-152`` says otherwise; the code is followed).

    ``sharding`` (a ``parallel.StateSharding``): "tp", the tensors of
    ``sharding.dims`` are the rank's shards and every leaf norm is summed
    over the model group; "zero1", ``opt_state`` holds the rank's moment
    slices, the update runs on the matching slices of the (whole)
    gradients and parameters, and the ranks then exchange the updated
    slices."""
    groups = leaf_groups(grads)
    norm_reduce = None
    if sharding is not None and sharding.kind == "tp" and sharding.mesh.model_group is not None:
        from ..parallel.mesh import all_reduce

        group = sharding.mesh.model_group
        norm_reduce = NormReduce(frozenset(n for n, d in sharding.dims.items() if d is not None),
                                 lambda t: all_reduce(t, group))
    if clip is not None:
        grads = per_param_clip(grads, clip, groups, norm_reduce)
    grads = {n: g + wd * params[n] if mask[n] else g for n, g in grads.items()}
    if freeze_last_layer:
        grads = {n: torch.zeros_like(g) if "last_layer" in n else g
                 for n, g in grads.items()}
    if sharding is not None and sharding.kind == "zero1":
        from ..parallel.zero import exchange_slices, owned

        mesh, dims = sharding.mesh, sharding.dims
        grads = core.adapt(grads, params, groups)
        own = {n: owned(params[n], dims[n], mesh.data_index, mesh.data) for n in params}
        updates, new_state = core.moments(
            {n: owned(g, dims[n], mesh.data_index, mesh.data) for n, g in grads.items()},
            opt_state)
        for n, p in own.items():
            p.add_(-lr * updates[n])
        exchange_slices(params, dims, mesh)
        return new_state
    updates, new_state = core.update(grads, opt_state, params, groups, norm_reduce)
    for n, p in params.items():
        p.add_(-lr * updates[n])
    return new_state
