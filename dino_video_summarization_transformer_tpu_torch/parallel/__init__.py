"""Data parallelism, tensor parallelism and ZeRO-1 on ``torch.distributed``
(counterpart of the JAX package's ``parallel/``): ``mesh`` (process groups
and the data x model mesh), ``tp`` (the Megatron rules and the plain TP
route), ``tp_fused`` (the head-sharded per-phase kernels: the partial tier
of rows 1, 4, 7 and 8), ``zero`` (the moments over the data axis),
``state`` (a train state cut into shards and gathered back), ``launch``
(a world of N ranks in one call, for the CPU tests and ``chip_smoke.py``)
and ``worlds`` (what those ranks run).
Pipeline and sequence parallelism (JAX ``parallel/pp.py``, ``sp.py``) are
not ported (ROADMAP)."""

from .mesh import (Mesh, all_reduce, build_mesh, init_distributed_mode,
                   is_main_process)
from .state import StateSharding, gather_train_state, shard_train_state

__all__ = ["Mesh", "StateSharding", "all_reduce", "build_mesh", "gather_train_state",
           "init_distributed_mode", "is_main_process", "shard_train_state"]
