"""Process groups and the data x model mesh (counterpart of the JAX
package's ``parallel/mesh.py``; ref: utils/utils.py:437-469).

``init_distributed_mode`` brings up ``torch.distributed`` from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) and fails fast where a multi-process run was asked for
and is not there, as JAX's does. ``build_mesh(data, model)`` lays the
ranks out as JAX's ``np.asarray(devices).reshape(data, model)``: rank r at
(r // model, r % model), with one process group per row (the model axis:
the ranks that share a sample under tensor parallelism) and one per
column (the data axis: the replicas whose gradients are averaged).

JAX's ``data_sharding`` and ``replicated`` have no tensor counterpart
here: data rank d takes its own rows of the batch (``train_ssl``), and the
replicated initial state is the same seeded state, built on every rank
from the same generator, as each JAX host builds it from its seed.

Backends: NCCL where each rank has a card of its own, gloo on the CPU and
where ranks share a card (gloo takes CUDA tensors in ``all_reduce`` and
``broadcast`` only, which are the only collectives the parallel modules
call). The choice is a property of the launch, printed when the group
comes up; either way the kernels run on the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """(ref: utils/utils.py:414-419)."""
    return get_rank() == 0


def local_world_size() -> int:
    """Ranks on this node: torchrun's ``LOCAL_WORLD_SIZE`` (the whole world
    where it is not set)."""
    return _env_int("LOCAL_WORLD_SIZE", world_size())


def local_rank() -> int:
    return _env_int("LOCAL_RANK", get_rank() % max(local_world_size(), 1))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request (ranks beyond the cards share them), the CPU as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                           "is False; pass --device cpu to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def pick_backend(device: torch.device) -> str:
    """NCCL where every rank of the node has a card of its own, else gloo."""
    if device.type == "cuda" and local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed_mode(num_shards: int = 1, device=None) -> dict:
    """Bring up the process group from torchrun's environment (a no-op in a
    single process or where the group is already up). ``num_shards`` > 1
    declares that the caller expects a multi-process run: with no process
    group, or a world smaller than ``num_shards``, it raises instead of
    training one shard's data quietly (JAX ``init_distributed_mode``).
    Returns JAX's dict: rank, world_size, local_devices, global_devices."""
    want = _env_int("WORLD_SIZE", 1)
    if want > 1 and not is_initialized():
        dev = rank_device(device)
        backend = pick_backend(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://", rank=_env_int("RANK", 0),
                                world_size=want)
        if is_main_process():
            print(f"torch.distributed: {backend} over {want} ranks", flush=True)
    if num_shards > 1 and not is_initialized():
        raise RuntimeError(
            f"--num_shards={num_shards} requires a multi-process launch (torchrun "
            "sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), but "
            "no process group is up (fail-fast instead of silently training one "
            "shard)")
    if num_shards > 1 and world_size() < num_shards:
        raise RuntimeError(
            f"--num_shards={num_shards} but the process group has {world_size()} "
            "ranks: the launch did not bring up the expected world")
    return {"rank": get_rank(), "world_size": world_size(),
            "local_devices": 1, "global_devices": world_size()}


@dataclasses.dataclass
class Mesh:
    """This rank's place on the data x model mesh: its indices on both
    axes and the process groups of its row (``model_group``) and column
    (``data_group``), None where the axis has one rank."""
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]


def build_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The data x model mesh over the world (JAX ``build_mesh``): data=-1
    takes every rank the model axis leaves. Every rank calls it, in the
    same order (``new_group`` is collective)."""
    n = world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"model axis {model} does not divide {n} ranks")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    r = get_rank()
    data_group = model_group = None
    if n > 1:
        for i in range(data):  # the rows: one model group per data index
            g = dist.new_group([i * model + m for m in range(model)]) if model > 1 else None
            if i == r // model:
                model_group = g
        for m in range(model):  # the columns: one data group per model index
            g = dist.new_group([i * model + m for i in range(data)]) if data > 1 else None
            if m == r % model:
                data_group = g
    return Mesh(data, model, r // model, r % model, data_group, model_group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``t`` itself where the group is
    None), taken in f32 and returned in t's dtype."""
    if group is None:
        return t
    buf = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def all_reduce_flat(tensors: List[torch.Tensor], group, scale: float = 1.0) -> List[torch.Tensor]:
    """The sums of ``tensors`` over ``group`` times ``scale``, in one f32
    all-reduce of their concatenation (the tensors themselves where the
    group is None)."""
    if group is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def sum_of_parts(shapes: List[Sequence[int]], fill, group, device) -> List[torch.Tensor]:
    """Tensors of ``shapes`` each rank holds a part of, summed over
    ``group``: one zero-filled f32 buffer holds them all, ``fill(i, view)``
    writes this rank's part of tensor i into its view, and one all-reduce
    sums the buffer in place (the gather that gloo takes on CUDA, holding
    the tensors once). -> the views of the buffer."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
    views = [v.view(tuple(s)) for v, s in zip(flat.split(sizes), shapes)]
    for i, v in enumerate(views):
        fill(i, v)
    if group is not None:
        dist.all_reduce(flat, group=group)
    return views


def node_group(local_ranks: int):
    """The process group of this rank's node, its ``local_ranks``
    consecutive ranks (None, the default group, where the node is the
    world). Every rank calls it, in the same order (``new_group`` is
    collective)."""
    n = world_size()
    if local_ranks >= n:
        return None
    groups = [dist.new_group(list(range(i, i + local_ranks))) for i in range(0, n, local_ranks)]
    return groups[get_rank() // local_ranks]


def broadcast_tree(tree, src: int, group, device):
    """``tree`` (tensors in nested tuples) from global rank ``src`` to
    every rank of ``group``: ``src`` passes it, the others None and get
    it on ``device``. One small pickled broadcast of the shapes and
    dtypes, then one broadcast a tensor."""
    def spec(t):
        return tuple(spec(c) for c in t) if isinstance(t, tuple) else (tuple(t.shape), t.dtype)

    def build(sp):
        if isinstance(sp[-1], torch.dtype):
            return torch.empty(sp[0], dtype=sp[1], device=device)
        return tuple(build(c) for c in sp)

    def leaves(t):
        return [x for c in t for x in leaves(c)] if isinstance(t, tuple) else [t]

    meta = [spec(tree) if get_rank() == src else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    if get_rank() != src:
        tree = build(meta[0])
    for t in leaves(tree):
        dist.broadcast(t, src=src, group=group)
    return tree
