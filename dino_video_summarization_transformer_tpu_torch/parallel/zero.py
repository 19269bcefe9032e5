"""ZeRO-1: the optimizer's moments sharded over the data axis (counterpart
of the JAX package's ``parallel/zero.py``).

Each rank keeps the moments (Adam's mu and nu, SGD's trace, LARS's
momentum) only for its slice of each parameter: the slice along the first
dimension the data size divides (JAX ``_moment_sharding``); a scalar (the
step count) or a tensor no dimension of which it divides stays whole on
every rank. Parameters and gradients stay replicated: after the data
axis's gradient average, each rank runs the optimizer's elementwise update
on its slices (``train/optim.apply_updates_with_schedules`` with this
sharding), writes them into its parameters, and the ranks then exchange
the updated slices (one f32 all-reduce over the data group of one
zero-filled buffer of the sharded parameters, each rank's slices in
place: the gather that gloo takes on CUDA). Norms over a whole tensor (the gradient clip's, LARS's
trust ratio) are taken on the whole replicated tensors before the update
is sliced, so they equal the single-card step's.

The port's parameters are per block where JAX stacks the blocks along a
depth axis, so the first divisible dimension can differ from JAX's; the
values cannot (the update is elementwise), and the moments gathered back
equal JAX's.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .mesh import Mesh, sum_of_parts


def moment_dim(shape, size: int) -> Optional[int]:
    """The first dimension of ``shape`` that ``size`` divides (and is at
    least ``size``), or None: JAX ``_moment_sharding``."""
    for d, s in enumerate(shape):
        if s >= size and s % size == 0:
            return d
    return None


def owned(t: torch.Tensor, dim: Optional[int], index: int, size: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``t`` along ``dim`` (a view), or t whole."""
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


@torch.no_grad()
def exchange_slices(params: Mapping[str, torch.Tensor], dims: Mapping[str, Optional[int]],
                    mesh: Mesh) -> None:
    """Every rank's updated slices into every rank's parameters, in place:
    one all-reduce over the data group of a buffer holding the sharded
    parameters once, with the slices this rank does not own zeroed (whole
    tensors are updated alike on every rank and are not exchanged)."""
    names = [n for n in params if dims.get(n) is not None]
    if mesh.data_group is None or not names:
        return
    i, size = mesh.data_index, mesh.data

    def fill(k, view):
        d = dims[names[k]]
        owned(view, d, i, size).copy_(owned(params[names[k]], d, i, size))

    full = sum_of_parts([params[n].shape for n in names], fill, mesh.data_group,
                        params[names[0]].device)
    for n, v in zip(names, full):
        params[n].copy_(v)
