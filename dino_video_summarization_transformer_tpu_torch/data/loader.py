"""Batching, host-side prefetch and shard-aware sampling.

Replaces torch DataLoader/DistributedSampler (ref: datasets_custom/loader.py,
data_utils.py:357-380) with a thread-pool prefetcher: decode/augment run in
worker threads (the native decoder releases the GIL inside libav), and
items are handed to the engine in order as numpy for its device upload.
Copied from the JAX package's ``data/loader.py``.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Sequence

import numpy as np


def shard_indices(
    n: int, shard_id: int, num_shards: int, shuffle: bool = False,
    seed: int = 0, drop_last: bool = False,
) -> np.ndarray:
    """Deterministic contiguous-interleaved shard split, the
    DistributedSampler equivalent (ref: data_utils.py:357-380)."""
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed).permutation(n)
    if drop_last:
        usable = (n // num_shards) * num_shards
        order = order[:usable]
    return order[shard_id::num_shards]


class PrefetchLoader:
    """Iterate ``dataset[i]`` for i in ``indices`` with ``num_workers``
    threads, preserving order, keeping up to ``prefetch`` items buffered."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 num_workers: int = 4, prefetch: int = 8):
        self.dataset = dataset
        self.indices = list(indices if indices is not None else range(len(dataset)))
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        if self.num_workers == 1:
            for i in self.indices:
                yield self.dataset[i]
            return

        results: dict = {}
        cond = threading.Condition()
        next_to_fetch = [0]
        consumed = [0]
        stop = threading.Event()
        # Claim window relative to the consumer cursor: position k is always
        # claimed before k+1 and consumption is in order, so every position
        # the consumer waits on is inside the window — no claim-then-starve
        # deadlock (a buffer-occupancy bound can fill the buffer with later
        # positions while the claimer of the needed one waits forever).
        window = max(self.prefetch, self.num_workers + 1)

        def worker():
            while not stop.is_set():
                with cond:
                    while (next_to_fetch[0] >= consumed[0] + window
                           and not stop.is_set()):
                        cond.wait(timeout=0.1)
                    if stop.is_set():
                        return
                    pos = next_to_fetch[0]
                    if pos >= len(self.indices):
                        return
                    next_to_fetch[0] += 1
                try:
                    item = self.dataset[self.indices[pos]]
                except Exception as e:  # surfaced at consumption point
                    item = e
                with cond:
                    results[pos] = item
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(len(self.indices)):
                with cond:
                    while pos not in results:
                        cond.wait(timeout=0.1)
                    item = results.pop(pos)
                    consumed[0] = pos + 1
                    cond.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()
