"""A world of N ranks in one call: the port's stand-in for JAX's
8-device virtual CPU mesh, for the CPU tests and ``chip_smoke.py``.

``run_world(fn, n, *args)`` spawns n processes (``torch.multiprocessing``,
the spawn start method), brings up ``torch.distributed`` in each over a
``FileStore`` in a temporary directory (no TCP port, so several worlds can
run side by side), sets torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) so that code calling
``mesh.init_distributed_mode`` finds the group it expects, and runs
``fn(rank, n, *args)`` in each. It returns the ranks' results in rank
order (picklable values: numpy arrays, numbers, dicts of them) and raises
with the failing ranks' tracebacks if any rank raised or died. ``fn``
must be importable by name, so the children import torch and the port,
never the caller's module.

Backend: gloo, on the CPU or with every rank on one card (a rank's card
is ``cuda:{LOCAL_RANK % device_count}``, ``mesh.rank_device``); gloo takes
CUDA tensors in ``all_reduce`` and ``broadcast``, and the parallel modules
call ``all_reduce`` alone.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

TIMEOUT = 900.0  # seconds a world may take to return every rank's result


def _child(fn, rank, n, store_path, args, threads, q):
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n))
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        q.put((rank, True, fn(rank, n, *args)))
    except BaseException:  # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, n: int, *args, threads: int = 1) -> list:
    """``fn(rank, n, *args)`` on each rank of a spawned world of ``n``;
    -> the ranks' results in rank order. ``threads``: intra-op threads a
    rank (0 leaves torch's default). Raises after TIMEOUT seconds without
    every rank's result."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dvst_world_") as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_child,
                             args=(fn, r, n, os.path.join(tmp, "store"), args, threads, q),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = time.monotonic() + TIMEOUT
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop at the first failure
            while len(results) + len(errors) < n and not errors:
                try:
                    rank, ok, out = q.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"world of {n}: no result after {TIMEOUT} s")
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in results
                            and r not in errors]
                    if dead:
                        for r in dead:
                            errors[r] = f"rank {r} died (exit code {procs[r].exitcode})"
                    continue
                (results if ok else errors)[rank] = out
        finally:
            for p in procs:
                p.join(timeout=1 if errors else 30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(f"[rank {r}]\n{e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(n)]
