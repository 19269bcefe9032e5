"""CSV-driven datasets (counterpart of the JAX package's
``data/datasets.py``): ``read_csv_entries``, the scoring dataset
``DinoLossDataset`` (the rgb8, yuv420 and yuv420q wires), the frame
selection dataset ``FrameSelectionDataset`` (the K400 evaluation and
finetuning), the clip dataset ``ClipDataset`` (train: one clip or the DINO
multi-crop; val and test: the evaluation CLIs' clips) and the registry
``build_dataset``.

The dataset returns the decoded frame buffer plus window *index maps*
instead of materialized (2T, 3, 30, 224, 224) view stacks; the scorer
gathers the windows on the device (see data/windows.py).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from . import selection as sel
from . import video as vio
from . import yuv
from .transform import (VideoDataAugmentationDINO, get_start_end_idx,
                        spatial_sampling, spatial_tile_local_crops,
                        temporal_sampling, tensor_normalize, uniform_crop)
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


class FrameSelectionDataset:
    """Uniform / adaptive frame selection
    (ref: datasets_custom/frame_selection_loader.py:12-218). ``cfg.LOSS_FILE``
    is the per-frame loss JSON of the scorer; an item is, by
    ``return_type``:

    * ``"Indices"``: (the selected frame indices, padded to ``num_frames``
      by ``selection.pad_indices``, label, file name); with ``probe_only``
      (and no ``augmentations``) the frame count comes from the container's
      metadata and nothing is decoded, where the container reports one;
    * ``"Dict"``: {"pixel_values": (N, C, H, W), "label"}: the selected
      frames (normalized and centre-cropped with ``augmentations``, raw
      uint8 otherwise); where their shape is not (3, N, 224, 224) the
      reference's quirk replaces them by zeros (ref:
      frame_selection_loader.py:201-203);
    * ``"Tensor"``: ((C, N, H, W) frames, label, file name, {}).
    """

    def __init__(self, cfg, pre_sampling_rate: int,
                 selection_method: str = "uniform", num_frames: int = 8,
                 augmentations: bool = False, return_type: str = "Tensor",
                 mode: str = "test", sharpen: bool = False,
                 probe_only: bool = False):
        self.cfg = cfg
        self.mode = mode
        self.pre_sampling_rate = pre_sampling_rate
        self.selection_method = selection_method
        self.num_frames = num_frames
        self.crop_size = 224
        self.augmentations = augmentations
        self.return_type = return_type
        self.sharpen = sharpen
        self.probe_only = probe_only

        with open(cfg.LOSS_FILE, "r") as f:
            self.loss_dict = json.load(f)

        num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS
        csv = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{mode}.csv")
        mode_subdir = mode if cfg.get("DATASET", "") == "Kinetics" else None
        self._path_to_videos, self._labels = read_csv_entries(
            csv, cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_LABEL_SEPARATOR,
            num_clips, mode_subdir)
        print(f"Constructing dataloader (size: {len(self._path_to_videos)}) from {csv}")

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def labels(self):
        return list(self._labels)

    def _selection(self, file_name: str, num_presampled: int, num_unsampled: int):
        if self.selection_method == "adaptive":
            key = os.path.splitext(file_name)[0]
            return sel.adaptive_indices(
                self.loss_dict[key], self.num_frames, self.pre_sampling_rate,
                num_presampled=num_presampled, num_unsampled=num_unsampled,
                sharpen=self.sharpen)
        return sel.uniform_indices(self.num_frames, num_presampled)

    def _indices_from_probe(self, path, file_name, index):
        """Decode-free Indices path: counts from container metadata (the
        strided decode keeps ceil(nb_frames / rate) frames)."""
        num_unsampled = vio.video_info(path)["num_frames"]
        if num_unsampled <= 0:
            return None  # metadata absent; the caller decodes
        num_presampled = -(-num_unsampled // self.pre_sampling_rate)
        indices, frame_rows = self._selection(file_name, num_presampled, num_unsampled)
        indices = sel.pad_indices(indices, self.num_frames, len(frame_rows))
        return indices, self._labels[index], file_name

    def __getitem__(self, index: int):
        path = self._path_to_videos[index]
        file_name = os.path.basename(path)
        N = self.num_frames

        if (self.probe_only and self.return_type == "Indices"
                and not self.augmentations):
            out = self._indices_from_probe(path, file_name, index)
            if out is not None:
                return out

        # the total unsampled frame count bounds the duplicate resolution
        # (ref: frame_selection_loader.py:159-164)
        num_unsampled = vio.video_info(path)["num_frames"]
        frames_u8, _ = vio.read_video(path, stride=self.pre_sampling_rate)
        if num_unsampled <= 0:
            num_unsampled = frames_u8.shape[0] * self.pre_sampling_rate

        if self.augmentations:
            frames = tensor_normalize(frames_u8, self.cfg.DATA.MEAN, self.cfg.DATA.STD)
            frames = np.moveaxis(frames, -1, 1)  # T C H W
            frames, _ = uniform_crop(frames, self.crop_size, spatial_idx=1)
        else:
            frames = np.moveaxis(frames_u8, -1, 1)  # T C H W, uint8

        indices, frame_rows = self._selection(file_name, frames.shape[0], num_unsampled)
        selected = np.stack([frames[r] for r in frame_rows]) if frame_rows else frames[:0]
        indices = sel.pad_indices(indices, N, selected.shape[0])
        frames_cthw = np.ascontiguousarray(np.moveaxis(selected, 0, 1))  # C T H W

        if self.return_type == "Indices":
            return indices, self._labels[index], file_name
        if self.return_type == "Dict":
            want = (3, N, 224, 224)
            if frames_cthw.shape != want:
                frames_cthw = np.zeros(want, np.float32)  # the reference's zero pad
            return {"pixel_values": np.moveaxis(frames_cthw, 0, 1),  # (N, C, H, W)
                    "label": self._labels[index]}
        return frames_cthw, self._labels[index], file_name, {}


class ClipDataset:
    """Train / val / test clip dataset for Kinetics / UCF101 / HMDB51
    (ref: datasets_custom/kinetics.py:121-332, ucf101.py:96-268). An item is
    ``(clip or crops, label, index, meta)``:

    * train, plain (the default): one clip of ``DATA.NUM_FRAMES`` frames
      from a random window, normalized, scale-jittered, randomly cropped
      to ``DATA.TRAIN_CROP_SIZE`` and flipped, (C, T, H, W) float32;
    * val: the same (one random clip, ``spatial_sampling``'s train path),
      as the reference's val mode;
    * test: ``TEST.NUM_ENSEMBLE_VIEWS`` temporal clips x
      ``TEST.NUM_SPATIAL_CROPS`` uniform crops per video, each an item
      (clip ``(i % views_x_crops) // crops``, crop ``i % crops``),
      short-side scaled to and cropped at ``DATA.TEST_CROP_SIZE``;
    * train with ``temporal_aug``: 2 global 224-px clips sampled over the
      whole video and 8 local 96-px clips over an eighth of it each (the
      DINO multi-crop, a list of (C, T, H, W) float32);
    * with ``rand_fr``: the globals of 4 and 8 frames, the locals of [2, 2,
      4, 4, 8, 8, 16, 16] frames (ref: decoder.py:418-427);
    * with ``tiled_local``: the locals are 8 overlapping 96 x 96 tiles of
      one frame (``spatial_tile_local_crops``; ref: decoder.py:576-601);
    * ``two_token``: 3 global and 2 local clips make 6 views
      (``VideoDataAugmentationDINO(two_token=True)``).

    The plain clip decodes only its frames (``video_info`` then
    ``read_video_indices``); the multi-crop spans the whole video and
    decodes it all. Each draws from its ``RandomState`` what the JAX class
    draws, in the same order, so the same seed gives the same clips. A
    video that fails to decode is swapped for a random other one, up to
    ``num_retries`` times. The flow companion (``get_flow``) needs the
    two-stream trainer's flow helpers and raises (ROADMAP queue 1 item
    7)."""

    def __init__(self, cfg, mode: str, num_retries: int = 10,
                 get_flow: bool = False, temporal_aug: bool = False,
                 two_token: bool = False, rand_fr: bool = False,
                 tiled_local: bool = False, csv_name: Optional[str] = None,
                 seed: Optional[int] = None):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode {mode!r}: train, val or test")
        if get_flow:
            raise NotImplementedError(
                "ClipDataset(get_flow=True): the optical-flow companion of the "
                "two-stream trainer is not ported (ROADMAP queue 1 item 7)")
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self.temporal_aug = temporal_aug
        self.two_token = two_token
        self.rand_fr = rand_fr
        self.tiled_local = tiled_local
        self.rng = np.random.RandomState(seed)
        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        csv = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, csv_name or f"{mode}.csv")
        self._path_to_videos, self._labels = read_csv_entries(
            csv, cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_LABEL_SEPARATOR, self._num_clips)
        self._spatial_temporal_idx = [i % self._num_clips
                                      for i in range(len(self._path_to_videos))]
        print(f"Constructing dataloader (size: {len(self._path_to_videos)}) "
              f"from {csv}")

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def labels(self):
        return list(self._labels)

    def _local_start(self, max_len: int, local_width: int) -> int:
        return int(self.rng.randint(0, max(max_len - local_width, 1)))

    def _multi_crop_clips(self, frames: np.ndarray):
        """The multi-crop variant's clips of a whole decoded video,
        (T, H, W, C) uint8 each."""
        num_frames = self.cfg.DATA.NUM_FRAMES
        max_len = frames.shape[0]
        local_width = max_len // 8
        if self.two_token:
            globals_ = []
            for _ in range(3):
                ri = int(self.rng.randint(0, 7))
                globals_.append(temporal_sampling(frames, ri, max_len - ri, num_frames))
            locals_ = []
            for _ in range(2):
                ri = self._local_start(max_len, local_width)
                locals_.append(temporal_sampling(frames, ri, ri + local_width, num_frames))
            return [*globals_, *locals_]
        if self.rand_fr:
            clips = [temporal_sampling(frames, 0, max_len - 5, 4),
                     temporal_sampling(frames, 5, max_len, 8)]
            for n_local in (2, 2, 4, 4, 8, 8, 16, 16):
                ri = self._local_start(max_len, local_width)
                clips.append(temporal_sampling(frames, ri, ri + local_width, n_local))
            return clips
        clips = [temporal_sampling(frames, 0, max_len - 5, num_frames),
                 temporal_sampling(frames, 5, max_len, num_frames)]
        if self.tiled_local:
            ri = self._local_start(max_len, local_width)
            one = temporal_sampling(frames, ri, ri, 1)[0]
            return clips + spatial_tile_local_crops(one)
        for _ in range(8):
            ri = self._local_start(max_len, local_width)
            clips.append(temporal_sampling(frames, ri, ri + local_width, num_frames))
        return clips

    def _decode_clip(self, index: int):
        """The item's clip, (T, H, W, C) uint8, or the multi-crop's list of
        clips; None when the video does not decode (ref: decoder.py:
        307-446)."""
        cfg = self.cfg
        path = self._path_to_videos[index]
        multi_crop = (self.two_token or self.temporal_aug) and self.mode == "train"
        if self.mode in ("train", "val"):
            clip_idx, num_clips_total = -1, 1
        else:
            clip_idx = self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            num_clips_total = cfg.TEST.NUM_ENSEMBLE_VIEWS
        num_frames = cfg.DATA.NUM_FRAMES
        target_fps = cfg.DATA.TARGET_FPS

        def clip_size(fps):
            return cfg.DATA.SAMPLING_RATE * num_frames / target_fps * (fps or target_fps)

        if not multi_crop:
            # selective decode: the clip's sample indices from the
            # container's frame count, then only those frames
            try:
                info = vio.video_info(path)
            except vio.DecodeError:
                return None
            size = info["num_frames"]
            if size > 0:
                start_idx, end_idx = get_start_end_idx(
                    size, clip_size(info["fps"]), clip_idx, num_clips_total, self.rng)
                # temporal_sampling's index rule over the whole video
                idx = np.linspace(start_idx, end_idx, num_frames, dtype=np.float32)
                idx = np.clip(idx, 0, size - 1).astype(np.int64)
                try:
                    clip = vio.read_video_indices(path, idx)
                except vio.DecodeError:
                    return None
                return clip if clip.shape[0] else None
            # no frame count in the container: decode it all, as below

        try:
            frames, fps = vio.read_video(path)
        except vio.DecodeError:
            return None
        if frames.shape[0] == 0:
            return None
        # the clip's start is drawn before the multi-crop clips, which do not
        # read it (ref: decoder.py:379-384)
        start_idx, end_idx = get_start_end_idx(
            frames.shape[0], clip_size(fps), clip_idx, num_clips_total, self.rng)
        if multi_crop:
            return self._multi_crop_clips(frames)
        return temporal_sampling(frames, start_idx, end_idx, num_frames)

    def __getitem__(self, index: int):
        cfg = self.cfg
        for _ in range(self._num_retries):
            clips = self._decode_clip(index)
            if clips is not None:
                break
            index = int(self.rng.randint(0, len(self)))
        else:
            raise RuntimeError(f"failed to decode after {self._num_retries} retries")
        label = self._labels[index]

        if self.mode == "train" and (self.two_token or self.temporal_aug):
            aug = VideoDataAugmentationDINO(rng=self.rng)
            as_tchw = [np.moveaxis(c, -1, 1).astype(np.float32) for c in clips]
            if self.two_token:
                crops = aug(as_tchw, two_token=True)
            else:
                crops = aug(as_tchw, from_list=True)
            # T C H W -> C T H W (ref: kinetics.py:306-311)
            return ([np.ascontiguousarray(np.moveaxis(c, 0, 1)) for c in crops],
                    label, index, {})

        # the plain clip: normalize + spatial sampling (ref: kinetics.py:257-289)
        frames = np.moveaxis(tensor_normalize(clips, cfg.DATA.MEAN, cfg.DATA.STD), -1, 1)
        if self.mode in ("train", "val"):
            spatial_idx = -1
            min_s, max_s = cfg.DATA.TRAIN_JITTER_SCALES
            crop = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            min_s = max_s = crop = cfg.DATA.TEST_CROP_SIZE
        frames = spatial_sampling(
            frames, self.rng, spatial_idx=spatial_idx, min_scale=min_s,
            max_scale=max_s, crop_size=crop,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP)
        return np.ascontiguousarray(np.moveaxis(frames, 0, 1)), label, index, {}


# dataset registry (ref: datasets_custom/build.py:5-30)
DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name.lower()] = cls
        return cls
    return deco


def build_dataset(name: str, cfg, split: str, **kw):
    """A registered dataset, or ``ClipDataset`` for kinetics / ucf101 /
    hmdb51 (their differences are the CSV names)."""
    key = name.lower()
    if key in DATASET_REGISTRY:
        return DATASET_REGISTRY[key](cfg, split, **kw)
    if key in ("kinetics", "kinetics400"):
        return ClipDataset(cfg, split, **kw)
    if key == "ssv2":
        raise NotImplementedError(
            "ssv2: Ssv2Dataset and load_image_lists are not ported yet (ROADMAP "
            "queue 1 item 6, the rest of the evaluation consumers)")
    if key == "ucf101":
        return ClipDataset(cfg, split, csv_name=f"ucf101_{split}_split_1_videos.txt", **kw)
    if key == "hmdb51":
        return ClipDataset(cfg, split, csv_name=f"hmdb51_{split}_split_1_videos.txt", **kw)
    raise ValueError(f"unknown dataset {name}")
