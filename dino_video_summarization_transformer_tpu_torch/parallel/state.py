"""A ``TrainState`` cut into this rank's shards and gathered back.

``shard_train_state(state, kind, mesh, num_heads)`` replaces, in place,
the student's and the teacher's parameters and the optimizer's tensors by
this rank's shards (``models/convert.shard_state_dict``: "tp" over the
model axis, the qkv rows head-major; "zero1" the moments over the data
axis) and returns the ``StateSharding`` that ``train.ssl.make_train_step``
takes (JAX's ``state_sharding``). ``gather_train_state`` is its inverse,
a collective: every rank gets the whole state in the single-card layout
(the checkpoint's; JAX gathers the same way before its rank 0 writes,
``train_ssl.py:568-576`` there).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from .mesh import Mesh, sum_of_parts


@dataclasses.dataclass
class StateSharding:
    """How a rank's ``TrainState`` is cut: ``kind`` "tp" (``dims``: a
    parameter's dim sharded over the model axis, None where replicated) or
    "zero1" (``dims``: the dim of a parameter's moments sharded over the
    data axis); ``full_dims``: the same over the flat state's keys, as
    ``convert.state_dims`` gives them."""
    kind: str
    mesh: Mesh
    dims: Dict[str, Optional[int]]
    full_dims: Dict[str, Optional[int]]
    num_heads: int = 0

    @property
    def axis(self):
        """(this rank's index, the axis size, its process group)."""
        m = self.mesh
        if self.kind == "tp":
            return m.model_index, m.model, m.model_group
        return m.data_index, m.data, m.data_group


def flat_state(state) -> Dict[str, torch.Tensor]:
    """``student.<name>``, ``teacher.<name>``, ``opt.<moment>.<name>`` (and
    ``opt.<scalar>``) and ``center`` of a ``TrainState``, detached."""
    out = {f"student.{n}": p.detach() for n, p in state.student.named_parameters()}
    out.update({f"teacher.{n}": p.detach() for n, p in state.teacher.named_parameters()})
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"opt.{k}.{n}": t for n, t in v.items()})
        else:
            out[f"opt.{k}"] = v
    out["center"] = state.center
    return out


def _set_params(module: nn.Module, named: Dict[str, torch.Tensor]) -> None:
    for n, t in named.items():
        mod_name, _, pname = n.rpartition(".")
        sub = module.get_submodule(mod_name) if mod_name else module
        old = getattr(sub, pname)
        setattr(sub, pname, nn.Parameter(t.contiguous().clone(),
                                         requires_grad=old.requires_grad))


def _load_flat(state, flat: Dict[str, torch.Tensor]) -> None:
    """Write a flat state into ``state``'s modules and optimizer state."""
    for part in ("student", "teacher"):
        _set_params(getattr(state, part), {n[len(part) + 1:]: v for n, v in flat.items()
                                           if n.startswith(part + ".")})
    for k, v in list(state.opt_state.items()):
        if isinstance(v, dict):
            state.opt_state[k] = {n: flat[f"opt.{k}.{n}"].contiguous().clone() for n in v}
        else:
            state.opt_state[k] = flat[f"opt.{k}"]
    state.center = flat["center"]


def shard_train_state(state, kind: str, mesh: Mesh, num_heads: int = 0) -> StateSharding:
    """Cut ``state`` in place into this rank's shards ("tp" or "zero1";
    ``num_heads`` the model's heads, for the head-major qkv rows) ->
    its ``StateSharding``."""
    from ..models import convert
    from . import tp

    flat = flat_state(state)
    sharding = StateSharding(kind, mesh, {}, {}, num_heads)
    index, size, _ = sharding.axis
    if kind == "tp":
        tp.check_divisible(dict(state.student.named_parameters()), size, num_heads)
    sharding.full_dims = convert.state_dims(flat, size, kind)
    if kind == "tp":
        sharding.dims = {n: sharding.full_dims[f"student.{n}"]
                         for n, _ in state.student.named_parameters()}
    else:
        moment = next(k for k, v in state.opt_state.items() if isinstance(v, dict))
        sharding.dims = {n: sharding.full_dims[f"opt.{moment}.{n}"]
                         for n, _ in state.student.named_parameters()}
    _load_flat(state, convert.shard_state_dict(flat, index, size, kind, num_heads))
    return sharding


def gather_flat_state(state, sharding: StateSharding) -> Dict[str, torch.Tensor]:
    """The whole flat state in the single-card layout, on every rank (a
    collective over the sharded axis)."""
    return gather_flat(flat_state(state), sharding)


@torch.no_grad()
def gather_flat(flat: Dict[str, torch.Tensor], sharding: StateSharding) -> Dict[str, torch.Tensor]:
    """This rank's shards of a flat dict (keyed as ``sharding.full_dims``:
    a state, or gradients under the student's keys) gathered into the
    single-card layout, on every rank: one f32 all-reduce over the sharded
    axis of one zero-filled buffer of the full tensors, each rank's shards
    in place (``mesh.sum_of_parts``)."""
    from .tp_fused import unpermute_qkv_tree

    flat = dict(flat)
    index, size, group = sharding.axis
    names = [n for n in flat if sharding.full_dims.get(n) is not None]
    shapes = []
    for n in names:
        shape = list(flat[n].shape)
        shape[sharding.full_dims[n]] *= size
        shapes.append(shape)

    def fill(k, view):
        d, v = sharding.full_dims[names[k]], flat[names[k]]
        view.narrow(d, index * v.shape[d], v.shape[d]).copy_(v)

    if names:
        full = sum_of_parts(shapes, fill, group, flat[names[0]].device)
        for n, v in zip(names, full):
            flat[n] = v.to(flat[n].dtype)
    if sharding.kind == "tp":
        flat = unpermute_qkv_tree(flat, sharding.num_heads, size)
    return flat


def gather_train_state(state, sharding: StateSharding):
    """A new whole ``TrainState`` in the single-card layout, on every rank
    (collective): what the checkpoint holds."""
    full = copy.copy(state)
    full.student, full.teacher = copy.deepcopy(state.student), copy.deepcopy(state.teacher)
    full.opt_state = dict(state.opt_state)
    _load_flat(full, gather_flat_state(state, sharding))
    return full
