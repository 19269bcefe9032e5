"""Frame selection: uniform and adaptive CDF-quantile sampling.

Pure-numpy re-implementation of the selection math in the reference's
FrameSelectionLoader (ref: datasets_custom/frame_selection_loader.py:115-190),
index-for-index identical, including its quirks (kept for bit-compatibility
with the published eval logs; see SURVEY.md section 7 "known defects"):

* the min-max normalization is dead code — sum-normalization wins
  (ref: frame_selection_loader.py:129-132)
* on duplicate resolution, the *frame* appended is still ``frames[idx]``
  rather than the shifted index's frame (ref: frame_selection_loader.py:161)
* when the forward scan falls off the video end, ``temp - rate`` is appended
  even if already present (ref: frame_selection_loader.py:164-166)

The sequential duplicate scan is O(N) host work on a <=16-entry list — not
worth a device kernel.
Copied from the JAX package's ``data/selection.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def adaptive_indices(
    loss_list: np.ndarray,
    num_frames: int,
    pre_sampling_rate: int,
    num_presampled: int,
    num_unsampled: int,
    sharpen: bool = False,
) -> Tuple[List[int], List[int]]:
    """Select frames by CDF quantiles of normalized per-frame losses.

    Returns (indices, frame_rows):
      indices    — selected indices in the *unsampled* video timeline (what
                   the reference returns for selective re-decode)
      frame_rows — rows into the presampled frame array (which frame tensor
                   the reference stacks for each selection)
    """
    loss_list = np.asarray(loss_list, dtype=np.float64)
    if sharpen:
        loss_list = loss_list ** 2
    if len(loss_list) > num_presampled:
        loss_list = loss_list[:num_presampled]

    pdf = loss_list / np.sum(loss_list)
    cdf = np.cumsum(pdf)

    indices: List[int] = []
    frame_rows: List[int] = []
    N = num_frames
    for i in range(N):
        j = i / N
        idx = int(np.abs(cdf - j).argmin())
        idx_scaled = idx * pre_sampling_rate
        if idx_scaled not in indices:
            indices.append(idx_scaled)
            frame_rows.append(idx)
        else:
            temp = idx_scaled + pre_sampling_rate
            while True:
                if temp not in indices and temp < num_unsampled:
                    indices.append(temp)
                    frame_rows.append(idx)  # reference quirk: original row
                    break
                elif temp >= num_unsampled:
                    indices.append(temp - pre_sampling_rate)
                    frame_rows.append(-1)  # reference appends frames[-1]
                    break
                else:
                    temp = temp + pre_sampling_rate
    return indices, frame_rows


def uniform_indices(
    num_frames: int, num_presampled: int
) -> Tuple[List[int], List[int]]:
    """Every len/N-th presampled frame (ref: frame_selection_loader.py:175-185).
    Note the returned indices live in the *presampled* timeline (the
    reference's uniform branch does not scale by the pre-sampling rate)."""
    interval = int(num_presampled / num_frames)
    indices = [i * interval for i in range(num_frames)]
    return indices, list(indices)


def pad_indices(indices: List[int], num_frames: int, num_selected: int) -> List[int]:
    """(ref: frame_selection_loader.py:188-190) — pads with num_selected-1,
    the reference's (quirky) 'frames.size(0)-1' after selection."""
    out = list(indices)
    for _ in range(num_frames - len(out)):
        out.append(num_selected - 1)
    return out
