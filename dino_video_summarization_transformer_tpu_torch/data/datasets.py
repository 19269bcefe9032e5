"""CSV-driven scoring dataset (counterpart of the JAX package's
``data/datasets.py``: ``read_csv_entries`` and ``DinoLossDataset``, rgb8
wire only).

The dataset returns the decoded frame buffer plus window *index maps*
instead of materialized (2T, 3, 30, 224, 224) view stacks; the scorer
gathers the windows on the device (see data/windows.py).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from . import video as vio
from .transform import tensor_normalize, uniform_crop
from .windows import WindowMismatch, window_indices


def read_csv_entries(
    path_to_file: str, path_prefix: str, separator: str = " ",
    num_clips: int = 1, mode_subdir: Optional[str] = None,
) -> Tuple[List[str], List[int]]:
    """Parse `path label` rows, replicating each ``num_clips`` times
    (ref: kinetics.py:80-118, dino_loss_loader.py:41-77)."""
    if not os.path.exists(path_to_file):
        raise FileNotFoundError(f"{path_to_file} not found")
    paths, labels = [], []
    with open(path_to_file, "r") as f:
        for path_label in f.read().splitlines():
            if not path_label:
                continue
            parts = path_label.split(separator)
            if len(parts) != 2:
                raise ValueError(f"malformed csv row: {path_label!r}")
            path, label = parts
            for _ in range(num_clips):
                if mode_subdir is not None:
                    paths.append(os.path.join(path_prefix, mode_subdir, path))
                else:
                    paths.append(os.path.join(path_prefix, path))
                labels.append(int(label))
    if not paths:
        raise ValueError(f"no entries in {path_to_file}")
    return paths, labels


class DinoLossDataset:
    """Scoring dataset: whole-video decode + per-frame window index maps
    (ref: datasets_custom/dino_loss_loader.py:10-123).

    __getitem__ returns a dict:
      frames      (T, 224, 224, 3) float32, normalized + center-cropped,
                  channels-last; None on dummy
      local_idx   (T, local_size) int64
      global_idx  (T, eff_global) int64
      eff_global  int
      path        str
      dummy       bool — size mismatch -> constant-loss dummy protocol
                  (ref: dino_loss_loader.py:34-38, 104-107)
    """

    def __init__(self, cfg, mode: str, local_clip_size: int,
                 global_clip_size: int, sampling_rate: int):
        self.cfg = cfg
        self.mode = mode
        self.local_clip_size = local_clip_size
        self.global_clip_size = global_clip_size
        self.sampling_rate = sampling_rate
        self.crop_size = 224
        num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS
        csv = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{mode}.csv")
        self._path_to_videos, self._labels = read_csv_entries(
            csv, cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_LABEL_SEPARATOR,
            num_clips)
        print(f"Constructing dataloader (size: {len(self._path_to_videos)}) "
              f"from {csv}")

    def __len__(self):
        return len(self._path_to_videos)

    def _dummy(self, out: dict, eff_global: int) -> dict:
        out.update(dummy=True, frames=None, eff_global=eff_global,
                   num_frames=self.global_clip_size)
        return out

    def __getitem__(self, index: int) -> dict:
        path = self._path_to_videos[index]
        out = {"path": path, "local_size": self.local_clip_size,
               "dummy": False}
        try:
            return self._load_item(path, out)
        except Exception as e:  # boundary: one bad video must not end the run
            # the reference's constant-loss dummy protocol
            # (ref: dino_loss_loader.py:34-38)
            print(f"scoring: substituting dummy views for {path}: {e!r}",
                  flush=True)
            return self._dummy(out, 1)

    def _load_item(self, path: str, out: dict) -> dict:
        try:
            # pre-sampling stride applied in the decoder (the reference
            # decodes everything, then slices [::rate])
            frames_u8, _fps = vio.read_video(path, stride=self.sampling_rate)
        except vio.DecodeError:
            frames_u8 = np.zeros((0, 0, 0, 3), np.uint8)
        if (frames_u8.shape[0] == 0 or frames_u8.shape[1] < self.crop_size
                or frames_u8.shape[2] < self.crop_size):
            return self._dummy(out, min(self.global_clip_size,
                                        max(frames_u8.shape[0], 1)))

        tchw = np.moveaxis(tensor_normalize(
            frames_u8, self.cfg.DATA.MEAN, self.cfg.DATA.STD), -1, 1)
        tchw, _ = uniform_crop(tchw, self.crop_size, spatial_idx=1)
        frames = np.ascontiguousarray(np.moveaxis(tchw, 1, -1))

        T = frames.shape[0]
        try:
            local_idx, global_idx, eff_global = window_indices(
                T, self.local_clip_size, self.global_clip_size)
        except WindowMismatch:
            # ragged windows (odd T < global size): reference dummy protocol
            return self._dummy(out, min(self.global_clip_size, max(T, 1)))
        out.update(frames=frames, local_idx=local_idx, global_idx=global_idx,
                   eff_global=eff_global, num_frames=T)
        return out
