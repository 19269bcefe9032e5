"""Per-frame local/global temporal window construction as index maps.

The reference materializes, for every frame i of a T-frame video, a 3-frame
local clip and a 30-frame global clip as copies — a (2T, 3, 30, 224, 224)
tensor per video (ref: datasets_custom/dino_loss_loader.py:126-171). The
scorer keeps ONE device-resident frame buffer and gathers windows by
index, so the host never materializes the windows and each frame's pixels cross PCIe once.

The index arithmetic below is clamp-for-clamp identical to
``get_views_of_video_same_size`` (ref: dino_loss_loader.py:126-171).
Copied from the JAX package's ``data/windows.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class WindowMismatch(ValueError):
    """Raised when the reference would produce ragged view sizes -> dummy."""


def window_indices(
    num_frames: int, local_size: int, global_size: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Index maps for every frame of a ``num_frames``-long video.

    Returns (local_idx (T, local_size), global_idx (T, eff_global), eff_global)
    where eff_global = min(global_size, num_frames)
    (ref: dino_loss_loader.py:132-133 shrinks the global window for short
    videos).
    """
    T = num_frames
    loc = int(local_size / 2)
    if T < global_size:
        global_size = T
    glob = int(global_size / 2)

    local_idx = np.empty((T, local_size), np.int64)
    global_idx = np.empty((T, global_size), np.int64)
    for i in range(T):
        j = i - loc
        k = i + loc + 1
        l = i - glob
        m = i + glob
        if j < 0:
            j = 0
            k = local_size
        if k >= T:
            k = T
            j = T - local_size
        if l < 0:
            l = 0
            m = global_size
        if m >= T:
            m = T
            l = T - global_size
        if k - j != local_size or m - l != global_size:
            # Ragged windows: for odd T < global_size the interior global
            # window is 2*(T//2) = T-1 long, so the reference's torch.stack
            # produces mismatched view sizes, size_match fails, and the
            # whole video falls back to the constant-loss dummy protocol
            # (ref: dino_loss_loader.py:103-123). Signal that here.
            raise WindowMismatch(
                f"ragged window at frame {i}: local {k - j}, global {m - l}")
        local_idx[i] = np.arange(j, k)
        global_idx[i] = np.arange(l, m)
    return local_idx, global_idx, global_size
