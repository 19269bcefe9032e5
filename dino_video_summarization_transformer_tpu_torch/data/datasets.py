"""CSV-driven datasets (counterpart of the JAX package's
``data/datasets.py``): ``read_csv_entries``, the scoring dataset
``DinoLossDataset`` (the rgb8, yuv420 and yuv420q wires) and the training
dataset ``ClipDataset`` (train mode, DINO multi-crop).

The dataset returns the decoded frame buffer plus window *index maps*
instead of materialized (2T, 3, 30, 224, 224) view stacks; the scorer
gathers the windows on the device (see data/windows.py).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

from . import video as vio
from . import yuv
from .transform import (VideoDataAugmentationDINO, temporal_sampling,
                        tensor_normalize, uniform_crop)
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
                  channels-last; with ``device_preprocess`` the center
                  crop in uint8 (the scorer normalizes on the card); with
                  ``wire_format`` "yuv420" / "yuv420q" the center crop of
                  the decoder's packed I420 (T, rows, 224) uint8 (yuv420q:
                  its chroma quartered after the crop; the scorer unpacks
                  on the card); None on dummy
      local_idx   (T, local_size) int64
      global_idx  (T, eff_global) int64
      eff_global  int
      path        str
      dummy       bool — size mismatch -> constant-loss dummy protocol
                  (ref: dino_loss_loader.py:34-38, 104-107)
    """

    def __init__(self, cfg, mode: str, local_clip_size: int,
                 global_clip_size: int, sampling_rate: int,
                 device_preprocess: bool = False, wire_format: str = "rgb8"):
        if wire_format not in ("rgb8", "yuv420", "yuv420q"):
            raise ValueError(f"wire_format={wire_format!r}")
        self.device_preprocess = device_preprocess
        self.wire_format = wire_format
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
        packed = self.wire_format != "rgb8"
        read = vio.read_video_yuv420 if packed else vio.read_video
        try:
            # pre-sampling stride applied in the decoder (the reference
            # decodes everything, then slices [::rate])
            frames_u8, _fps = read(path, stride=self.sampling_rate)
        except vio.DecodeError:
            frames_u8 = np.zeros((0, 0, 0) if packed else (0, 0, 0, 3), np.uint8)
        fh = yuv.frame_height(frames_u8.shape[1]) if packed else frames_u8.shape[1]
        if (frames_u8.shape[0] == 0 or fh < self.crop_size
                or frames_u8.shape[2] < self.crop_size):
            return self._dummy(out, min(self.global_clip_size,
                                        max(frames_u8.shape[0], 1)))

        if packed:
            # the centre crop of the packed planes, at uniform_crop's
            # ceil-centred offsets (rounded down to even inside crop)
            y0 = math.ceil((fh - self.crop_size) / 2)
            x0 = math.ceil((frames_u8.shape[2] - self.crop_size) / 2)
            frames = yuv.crop(frames_u8, y0, x0, self.crop_size, self.crop_size)
            if self.wire_format == "yuv420q":
                frames = yuv.quarter_chroma(frames)
        else:
            tchw = np.moveaxis(frames_u8 if self.device_preprocess else tensor_normalize(
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


class ClipDataset:
    """Train-mode DINO multi-crop clip dataset for Kinetics / UCF101 /
    HMDB51 (the JAX package's ``ClipDataset`` with ``temporal_aug``, ref:
    datasets_custom/kinetics.py:121-332). An item is the multi-crop of one
    video: 2 global 224-px clips sampled over the whole video and 8 local
    96-px clips over an eighth of it each, every clip (C, T, H, W) float32
    (ref: decoder.py:428-440, transform.py:661-749), as ``(crops, label,
    index, meta)``. A video that fails to decode is swapped for a random
    other one, up to ``num_retries`` times. Videos are decoded whole through
    ``data/video.py`` (the repo's native decoder). The val / test modes and
    the plain-clip, two-token, rand-fr, tiled-local and flow variants are
    not ported (ROADMAP)."""

    def __init__(self, cfg, mode: str = "train", num_retries: int = 10,
                 csv_name: Optional[str] = None, seed: Optional[int] = None):
        if mode != "train":
            raise NotImplementedError(f"ClipDataset mode {mode!r}: only the "
                                      "train mode is ported (ROADMAP)")
        self.cfg = cfg
        self._num_retries = num_retries
        self.rng = np.random.RandomState(seed)
        csv = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, csv_name or f"{mode}.csv")
        self._path_to_videos, self._labels = read_csv_entries(
            csv, cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_LABEL_SEPARATOR, 1)
        print(f"Constructing dataloader (size: {len(self._path_to_videos)}) "
              f"from {csv}")

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def labels(self):
        return list(self._labels)

    def _decode_clips(self, index: int):
        """The 10 multi-crop clips, (T, H, W, C) uint8 each, or None when
        the video does not decode."""
        try:
            frames, _ = vio.read_video(self._path_to_videos[index])
        except vio.DecodeError:
            return None
        if frames.shape[0] == 0:
            return None
        num_frames = self.cfg.DATA.NUM_FRAMES
        max_len = frames.shape[0]
        local_width = max_len // 8
        clips = [temporal_sampling(frames, 0, max_len - 5, num_frames),
                 temporal_sampling(frames, 5, max_len, num_frames)]
        for _ in range(8):
            ri = int(self.rng.randint(0, max(max_len - local_width, 1)))
            clips.append(temporal_sampling(frames, ri, ri + local_width, num_frames))
        return clips

    def __getitem__(self, index: int):
        for _ in range(self._num_retries):
            clips = self._decode_clips(index)
            if clips is not None:
                break
            index = int(self.rng.randint(0, len(self)))
        else:
            raise RuntimeError(f"failed to decode after {self._num_retries} retries")
        aug = VideoDataAugmentationDINO(rng=self.rng)
        as_tchw = [np.moveaxis(c, -1, 1).astype(np.float32) for c in clips]
        crops = aug(as_tchw, from_list=True)
        # T C H W -> C T H W (ref: kinetics.py:306-311)
        return ([np.ascontiguousarray(np.moveaxis(c, 0, 1)) for c in crops],
                self._labels[index], index, {})
