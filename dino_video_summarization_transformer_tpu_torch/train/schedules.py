"""Training schedules (counterpart of the JAX package's
``train/schedules.py``; ref: utils/utils.py:157-168), in numpy."""

from __future__ import annotations

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0) -> np.ndarray:
    """Per-iteration cosine schedule with an optional linear warmup."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule
