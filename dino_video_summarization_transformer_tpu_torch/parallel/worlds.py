"""What each rank of a spawned world runs (``launch.run_world``) for the
CPU tests and ``chip_smoke.py``: a few sharded train steps from one full
state, gathered back; the TP-fused forward and its gradients; a module's
``main``. Each takes numpy arrays and plain values and returns them, so
the caller compares its ranks with a one-card run or with JAX. The ranks
import it by name, so it lives in the package and imports no JAX; no
other module of the package imports it. ``count_twins`` and ``run_main``
patch module attributes in the rank's own process, for those callers only.

A global batch is view-major, as the train step takes it ((views x B, C,
T, H, W): all B clips of view 0, then of view 1, ...); data rank d takes
its B / data clips of every view (``local_rows``), as the CLI takes each
rank's rows of the node's batch.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch


def local_rows(x: np.ndarray, views: int, index: int, size: int) -> np.ndarray:
    """Data rank ``index``'s clips of a view-major batch of ``views``
    views over a data axis of ``size`` ranks."""
    v = x.reshape((views, -1) + x.shape[1:])
    b = v.shape[1] // size
    return np.ascontiguousarray(v[:, index * b:(index + 1) * b].reshape((-1,) + x.shape[1:]))


def count_twins() -> Dict[str, int]:
    """Count every call of ``fused_block``'s plain twins from here on (the
    wrappers look them up by name at each call): -> the live counters."""
    from ..ops import fused_block as fb

    calls: Dict[str, int] = {}
    for name in [n for n in dir(fb) if n.endswith("_plain")]:
        fn = getattr(fb, name)
        if getattr(fn, "_counted", False):
            continue

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        wrapped._counted = True
        setattr(fb, name, functools.wraps(fn)(wrapped))
    return calls


def _device(spec) -> torch.device:
    from .mesh import rank_device

    return rank_device(spec.get("device", "cpu"))


def _state(spec, dev):
    from ..models import timesformer as tsf
    from ..train import ssl

    cfg = tsf.TimeSformerConfig(**spec["cfg"])
    state, core, mask = ssl.init_train_state(
        cfg, out_dim=spec["out_dim"], seed=spec.get("seed", 0), pretrained_backbone=spec.get("backbone"),
        head_state_dict=spec.get("head"), device=dev)
    return cfg, state, core, mask


def seeded_crops(seed: int, steps: int, batch: int, n_local: int, frames: int,
                 global_px: int, local_px: int, device) -> list:
    """``steps`` (global, local) view-major crop pairs of a global batch of
    ``batch`` clips, drawn on ``device`` from a generator seeded with
    ``seed`` (the same numbers in every process on the same device)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn((2 * batch, 3, frames, global_px, global_px), generator=gen,
                         device=device),
             torch.randn((n_local * batch, 3, frames, local_px, local_px), generator=gen,
                         device=device)) for _ in range(steps)]


def sharded_steps(rank: int, n: int, spec: dict) -> dict:
    """``len(spec["hyper"])`` train steps of ``spec["mode"]`` ("dp", "tp",
    "tp_fused", "zero1" or "one", the one-card step) on a ``spec["mesh"]``
    = (data, model) mesh, in ``spec["compute_dtype"]`` (default float32)
    on ``spec["device"]`` (default the CPU), from the state
    ``init_train_state`` builds from ``spec["backbone"]`` and
    ``spec["head"]`` (reference-layout numpy state dicts) or, without
    them, from ``spec["seed"]``, on ``spec["route"]`` (default "auto"),
    with the hyperparameters
    ``spec["hyper"]`` [(lr, wd, momentum, teacher_temp, freeze), ...] on
    the crops ``spec["crops"]`` [(g, l), ...] (numpy, view-major; one pair
    a step) or ``seeded_crops(*spec["crops_seed"], device)``. -> losses,
    centers, ms per step (the first step's left out where its gradients
    are kept), the rank's optimizer moments and (on a card) its peak of
    allocated memory over the timed steps in MiB, the launch counters of the
    steps, the twins' calls where
    ``spec["count_twins"]``, and on rank 0 the first step's gradients in
    the single-card layout (unless ``spec["grads"]`` is False) and the
    final state gathered likewise (``parallel.state.gather_flat_state``;
    not where ``spec["state"]`` is False), written as a checkpoint to
    ``spec["checkpoint"]`` where given."""
    import time

    from ..ops import fused_block as fb
    from ..train import ssl
    from ..utils.checkpoint import save_checkpoint
    from .mesh import build_mesh
    from .state import (flat_state, gather_flat, gather_flat_state, gather_train_state,
                        shard_train_state)
    from .tp_fused import tp_fused_forward_features

    dev = _device(spec)
    mode = spec["mode"]
    cd = getattr(torch, spec.get("compute_dtype", "float32"))
    cfg, state, core, mask = _state(spec, dev)
    data, model = spec.get("mesh", (n, 1))
    mesh = build_mesh(data, model) if mode != "one" else None
    sharding, fwd = None, None
    if mode in ("tp", "tp_fused"):
        sharding = shard_train_state(state, "tp", mesh, cfg.num_heads)
        if mode == "tp_fused":
            fwd = functools.partial(tp_fused_forward_features, cfg=cfg, mesh=mesh,
                                    compute_dtype=cd)
    elif mode == "zero1":
        sharding = shard_train_state(state, "zero1", mesh)
    step = ssl.make_train_step(cfg, core, mask, n_local_crops=spec["n_local"], compute_dtype=cd,
                               route=spec.get("route", "auto"), mesh=mesh,
                               state_sharding=sharding, backbone_forward=fwd)
    twins = count_twins() if spec.get("count_twins") else None
    d_index, d_size = (0, 1) if mesh is None else (mesh.data_index, mesh.data)

    def rows(t, views):
        if isinstance(t, np.ndarray):
            return torch.from_numpy(local_rows(t, views, d_index, d_size)).to(dev)
        v = t.reshape((views, -1) + t.shape[1:])
        b = v.shape[1] // d_size
        return v[:, d_index * b:(d_index + 1) * b].reshape((-1,) + t.shape[1:]).contiguous()

    all_crops = (seeded_crops(*spec["crops_seed"], device=dev) if "crops_seed" in spec
                 else spec["crops"])
    out, peaks = {"loss": [], "center": [], "ms": []}, []
    cuda = dev.type == "cuda"
    fb.reset_launches()
    for i, ((g, l), hyper) in enumerate(zip(all_crops, spec["hyper"])):
        gt, lt = rows(g, 2), rows(l, spec["n_local"])
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, aux, grads = step.loss_and_grads(state, gt, lt, hyper[3])
        if i == 0 and spec.get("grads", True):  # the first step's own gradients
            flat = {f"student.{k}": v for k, v in grads.items()}
            if sharding is not None and sharding.kind == "tp":
                flat = gather_flat(flat, sharding)
            if rank == 0:
                out["grads"] = {k[8:]: v.float().cpu().numpy() for k, v in flat.items()}
            del flat
            t0 = None  # the gather is not the step's time, nor its memory
        state, metrics = step.update(state, loss, aux, grads, hyper[0], hyper[1], hyper[2],
                                     hyper[4])
        out["loss"].append(float(metrics["loss"]))  # a sync per step
        if t0 is not None:
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if cuda:
                peaks.append(torch.cuda.max_memory_allocated(dev) / 2**20)
        out["center"].append(state.center.float().cpu().numpy())
    if cuda:
        torch.cuda.synchronize(dev)
        out["peak_mib"] = max(peaks, default=None)
    out["moments_mib"] = sum(t.numel() * t.element_size() for v in state.opt_state.values()
                             if isinstance(v, dict) for t in v.values()) / 2**20
    out["launches"] = dict(fb.launches)
    if twins is not None:
        out["twins"] = dict(twins)
    if spec.get("checkpoint"):
        ck = gather_train_state(state, sharding) if sharding is not None else state
        if rank == 0:
            save_checkpoint(spec["checkpoint"], ck, {"epoch": 1})
    if spec.get("state", True):
        full = (gather_flat_state(state, sharding) if sharding is not None
                else flat_state(state))
        if rank == 0:
            out["state"] = {k: v.float().cpu().numpy() for k, v in full.items()}
    return out


def run_calls(rank: int, n: int, calls) -> list:
    """Each ``(fn, spec)`` of ``calls`` in turn (``fn`` one of this
    module's rank functions), in one world: -> their results. Each call
    builds its own mesh, every rank the same groups in the same order."""
    return [fn(rank, n, spec) for fn, spec in calls]


def tp_features_and_grads(rank: int, n: int, spec: dict) -> dict:
    """The TP-fused forward of a backbone built from ``spec["backbone"]`` on
    ``spec["x"]`` over a model axis of n ranks, and the gradients of
    sum(features^2), gathered into the single-card layout: -> features and
    gradients (numpy)."""
    from ..models import convert, timesformer as tsf
    from .mesh import build_mesh
    from .state import StateSharding, _set_params, gather_flat
    from .tp import check_divisible
    from .tp_fused import tp_fused_forward_features

    dev = _device(spec)
    cd = getattr(torch, spec.get("compute_dtype", "bfloat16"))
    cfg = tsf.TimeSformerConfig(**spec["cfg"])
    backbone = tsf.build_timesformer(cfg, spec["backbone"], device=dev)
    mesh = build_mesh(1, n)
    named = {k: v.detach() for k, v in backbone.named_parameters()}
    check_divisible(named, n, cfg.num_heads)
    dims = convert.state_dims(named, n, "tp")
    _set_params(backbone, convert.shard_state_dict(named, rank, n, "tp", cfg.num_heads))
    x = torch.from_numpy(spec["x"]).to(dev)
    feats = tp_fused_forward_features(backbone, x, cfg, mesh, compute_dtype=cd)
    (feats.float() ** 2).sum().backward()
    grads = {k: p.grad.float() for k, p in backbone.named_parameters()}
    full = gather_flat(grads, StateSharding("tp", mesh, dims, dims, cfg.num_heads))
    return {"features": feats.float().detach().cpu().numpy(),
            "grads": {k: v.cpu().numpy() for k, v in full.items()} if rank == 0 else None}


def synchronized_meter(rank: int, n: int, values) -> tuple:
    """A ``MetricLogger`` meter fed ``values[rank]`` on each rank, then
    ``synchronize_between_processes``: -> (count, total, global_avg), the
    world's."""
    from ..engine.meters import MetricLogger

    logger = MetricLogger()
    for v in values[rank]:
        logger.update(loss=v)
    logger.synchronize_between_processes()
    m = logger.meters["loss"]
    return m.count, m.total, m.global_avg


def node_broadcast(rank: int, n: int, local_ranks: int) -> list:
    """A tree of tensors broadcast from each node's first rank to its
    node (nodes of ``local_ranks`` ranks; ``mesh.node_group``,
    ``mesh.broadcast_tree``), as the train CLI hands out a node's batch:
    -> what this rank holds after it (numpy)."""
    from .mesh import broadcast_tree, node_group

    group = node_group(local_ranks)
    src = rank // local_ranks * local_ranks
    tree = None
    if rank == src:
        tree = (torch.full((2, 3), float(src)), (torch.arange(4) + src,))
    got = broadcast_tree(tree, src, group, torch.device("cpu"))
    return [got[0].numpy(), got[1][0].numpy()]


def imported(rank: int, n: int, names) -> list:
    """Import each of ``names`` that the port can import (the others are
    skipped); -> the modules of ``names`` this rank has loaded, with any
    submodule of them."""
    import importlib
    import sys

    for name in names:
        if name.startswith(__name__.split(".")[0] + "."):
            importlib.import_module(name)
    return sorted(m for m in sys.modules
                  if any(m == x or m.startswith(x + ".") for x in names))


def run_main(rank: int, n: int, module: str, argv, weights: dict) -> None:
    """``module.main(argv)`` on each rank (a CLI under the world's process
    group, as torchrun would start it), the train state started from
    ``weights`` ({"backbone": ..., "head": ...}, reference-layout numpy
    state dicts: ``init_train_state``'s ``pretrained_backbone`` and
    ``head_state_dict``) instead of the seeded draw, so the run can be held
    to another package's run from the same numbers."""
    import importlib

    from ..train import ssl

    init = ssl.init_train_state

    def init_from_weights(model_cfg, **kw):
        kw.update(pretrained_backbone=weights["backbone"], head_state_dict=weights["head"])
        return init(model_cfg, **kw)

    ssl.init_train_state = init_from_weights
    importlib.import_module(module).main(list(argv))
