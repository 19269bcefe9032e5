"""Per-frame DINO importance scoring on the card (counterpart of the JAX
package's ``engine/scoring.py``, exact windowed path).

For every frame of a video the scorer runs the student forward over the
frame's 3-frame local window and the teacher forward over its 30-frame
global window, and scores the frame with the DINO cross-entropy between
the two CLS features (ref: dino_similarity.py:16-93). Frames cross to the
device once per video: the windows are gathered on the device by index
from one frame buffer per video group (concatenated across the group,
with index offsets), and a chunk of frames is scored per call — two
batched forwards and a vectorized loss. Launches are queued without host
syncs; results are fetched once per video group.

Numerics: f32 (``precision="highest"``, TF32 off) is the reference-compat
tier and reproduces the JAX package's f32 golden scores; bf16 is the
production tier and runs every block through the whole-block Hopper
kernels on a CUDA device (``use_kernels="auto"``).

The approximation knobs of the JAX scorer (teacher/score strides, banded
scoring, int8 tiers, the mixed teacher, the yuv wire) are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..models.timesformer import TimeSformerConfig, build_timesformer
from ..train.dino import scoring_dino_loss
from ..utils.device import resolve_device

MAX_GROUP_FRAMES = 1536  # frames of one video group held on the device


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    """FrameScorer knobs. ``FrameScorer`` also takes them as keyword
    arguments: ``FrameScorer(sd, mcfg, chunk=8)`` ==
    ``FrameScorer(sd, mcfg, ScorerConfig(chunk=8))``.

    use_kernels: "auto" runs the bf16 Hopper kernels on a CUDA device and
      the plain path for f32 or on the CPU; True forces the kernel route
      (on CPU tensors it runs the kernels' plain twins, as the tests do);
      False forces the plain path.
    precision: "highest" turns TF32 off for matmuls and convolutions (the
      f32 reference-compat tier); None leaves PyTorch's settings alone.
    device: "cuda" (default), "cuda:i" or "cpu".
    """

    local_size: int = 3
    global_size: int = 30
    chunk: int = 16
    teacher_temp: float = 0.02
    student_temp: float = 0.3
    compute_dtype: torch.dtype = torch.float32
    precision: Optional[str] = "highest"
    use_kernels: Union[str, bool] = "auto"
    device: Optional[object] = None


class FrameScorer:
    """Batched per-frame scorer for one model and window geometry.

    ``state_dict``: reference-layout backbone weights (numpy arrays or
    tensors, e.g. ``models.convert.convert_svt_checkpoint``)."""

    def __init__(self, state_dict, model_cfg: TimeSformerConfig,
                 config: Optional[ScorerConfig] = None, **overrides):
        if config is None:
            config = ScorerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.local_size = config.local_size
        self.global_size = config.global_size
        self.chunk = config.chunk
        self.teacher_temp = config.teacher_temp
        self.student_temp = config.student_temp
        self.compute_dtype = config.compute_dtype
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype={self.compute_dtype}")
        self.device = resolve_device(config.device)
        if config.precision == "highest":
            # counterpart of jax.default_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif config.precision is not None:
            raise ValueError(f"precision={config.precision!r}")
        use = config.use_kernels
        if use == "auto":
            use = (self.compute_dtype == torch.bfloat16
                   and self.device.type == "cuda")
        elif use not in (True, False):
            raise ValueError(f"use_kernels={use!r}")
        if use and self.compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the kernels take bf16 activations; the f32-in temporal "
                "kernel of the mixed teacher is not ported yet (ROADMAP)")
        self.model_cfg = dataclasses.replace(model_cfg, use_kernels=bool(use))
        self.model = build_timesformer(self.model_cfg, state_dict,
                                       device=self.device,
                                       dtype=self.compute_dtype)
        self._dummy_loss: Optional[float] = None

    # -- one chunk -------------------------------------------------------------

    def _gather_views(self, frames: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Gather (chunk, n_view, H, W, C) windows from the frame buffer;
        returns (chunk, C, n_view, H, W)."""
        v = frames[idx.reshape(-1)].reshape(*idx.shape, *frames.shape[1:])
        return v.permute(0, 4, 1, 2, 3)

    @torch.inference_mode()
    def _score_chunk(self, frames, loc_idx, glob_idx) -> torch.Tensor:
        """Both forwards + the loss for a chunk of frames: (chunk,) f32."""
        s = self.model(self._gather_views(frames, loc_idx))
        t = self.model(self._gather_views(frames, glob_idx))
        return scoring_dino_loss(s, t, teacher_temp=self.teacher_temp,
                                 student_temp=self.student_temp)

    # -- video groups ----------------------------------------------------------

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """Normalized float frames travel in the compute dtype."""
        return torch.from_numpy(np.ascontiguousarray(frames)).to(
            self.device, self.compute_dtype)

    def _run_group_chunks(self, items: List[dict]) -> List[tuple]:
        """Score the rows of several videos as one stream of full chunks
        (chunks may straddle videos). Returns [(device_losses, n_valid)],
        rows in video order; nothing is fetched."""
        bufs, locs, globs = [], [], []
        off = 0
        for it in items:
            bufs.append(self._upload(it["frames"]))
            locs.append(np.asarray(it["local_idx"]) + off)
            globs.append(np.asarray(it["global_idx"]) + off)
            off += it["frames"].shape[0]
        frames = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
        n_rows = off
        n_chunks = -(-n_rows // self.chunk)
        pad = n_chunks * self.chunk - n_rows

        def to_dev(mats):  # padded rows gather frame 0; their losses drop
            m = np.concatenate(mats)
            m = np.pad(m, ((0, pad), (0, 0)))
            return torch.from_numpy(m).to(self.device).reshape(
                n_chunks, self.chunk, m.shape[1])

        loc, glob = to_dev(locs), to_dev(globs)
        outs = []
        for c in range(n_chunks):
            n = min(self.chunk, n_rows - c * self.chunk)
            outs.append((self._score_chunk(frames, loc[c], glob[c]), n))
        return outs

    def score_group_async(self, items: List[dict]) -> List["PendingScore"]:
        """Score several DinoLossDataset items with cross-video chunk
        batching; one PendingScore per item, order preserved. Dummies get
        the constant-loss protocol; videos whose teacher windows differ in
        length (the short-video clamp) are batched separately."""
        results: List[Optional[PendingScore]] = [None] * len(items)
        groups: Dict[int, List[int]] = {}
        for i, item in enumerate(items):
            if item["dummy"]:
                results[i] = PendingScore([], ready=self.dummy_losses())
            else:
                groups.setdefault(item["eff_global"], []).append(i)
        for idxs in groups.values():
            for i, h in zip(idxs, self._score_group_exact(
                    [items[i] for i in idxs])):
                results[i] = h
        return results

    def _score_group_exact(self, items: List[dict]) -> List["PendingScore"]:
        gf = _GroupFetch(self._run_group_chunks(items))
        handles, s = [], 0
        for it in items:
            T = it["frames"].shape[0]
            handles.append(PendingScore([], group=(gf, s, s + T)))
            s += T
        return handles

    # -- public API --------------------------------------------------------------

    def score_video_async(self, frames: np.ndarray, local_idx: np.ndarray,
                          global_idx: np.ndarray, eff_global: int) -> "PendingScore":
        """Queue one video's scoring; ``.fetch()`` returns the (T,) losses."""
        if global_idx.shape[1] != eff_global:
            raise ValueError(f"global_idx has {global_idx.shape[1]} columns, "
                             f"eff_global is {eff_global}")
        item = {"frames": frames, "local_idx": local_idx,
                "global_idx": global_idx}
        return PendingScore(self._run_group_chunks([item]))

    def score_video(self, frames: np.ndarray, local_idx: np.ndarray,
                    global_idx: np.ndarray, eff_global: int) -> np.ndarray:
        """frames (T, H, W, C) float32, normalized; returns (T,) float64
        losses."""
        return self.score_video_async(frames, local_idx, global_idx,
                                      eff_global).fetch()

    @torch.inference_mode()
    def dummy_losses(self) -> np.ndarray:
        """Constant-loss protocol for corrupt / size-mismatched videos: the
        reference scores global_size pairs of all-zero (3, 60, 224, 224)
        views (ref: dino_loss_loader.py:34-38, dino_similarity.py:66-93),
        yielding global_size identical values."""
        if self._dummy_loss is None:
            dt, dev = self.compute_dtype, self.device
            s = self.model(torch.zeros((1, 3, self.local_size, 224, 224),
                                       dtype=dt, device=dev))
            t = self.model(torch.zeros((1, 3, 60, 224, 224), dtype=dt,
                                       device=dev))
            self._dummy_loss = float(scoring_dino_loss(
                s[0], t[0], teacher_temp=self.teacher_temp,
                student_temp=self.student_temp))
        return np.full(self.global_size, self._dummy_loss)


def _fetch_outs(outs: List[tuple]) -> np.ndarray:
    """[(device_losses, n_valid)] -> host rows: one device-side concat,
    one copy to the host."""
    full = torch.cat([o for o, _ in outs]).cpu().numpy()
    pieces, off = [], 0
    for o, n in outs:
        pieces.append(full[off:off + n])
        off += o.shape[0]
    return np.concatenate(pieces)


class _GroupFetch:
    """One fetch for a video group's shared chunk outputs: the first
    PendingScore.fetch() pulls every chunk, later videos slice the host
    array."""

    def __init__(self, outs: List[tuple]):
        self._outs = outs
        self._arr: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        if self._arr is None:
            self._arr = _fetch_outs(self._outs)
            self._outs = []  # release device memory
        return self._arr


class PendingScore:
    """Handle to a video's queued scoring work. ``fetch()`` waits for the
    device and returns float64 losses. ``ready`` holds host-computed
    results (dummies); ``group`` = (_GroupFetch, start, end) slices a
    video group's shared rows."""

    def __init__(self, outs: List[tuple], ready: Optional[np.ndarray] = None,
                 group: Optional[tuple] = None):
        self._outs = outs
        self._ready = ready
        self._group = group

    def fetch(self) -> np.ndarray:
        if self._ready is not None:
            return np.asarray(self._ready, np.float64)
        if self._group is not None:
            gf, s, e = self._group
            return gf.get()[s:e].astype(np.float64)
        return _fetch_outs(self._outs).astype(np.float64)


def export_loss(loss_list, video_path: str, file_path: str) -> None:
    """Incremental read-merge-write JSON export
    (ref: dino_similarity.py:97-117). Keyed by basename without extension."""
    video_name = os.path.basename(video_path)
    key, _ = os.path.splitext(video_name)
    video_dict = {key: [float(x) for x in loss_list]}
    if os.path.exists(file_path):
        with open(file_path, "r") as f:
            data = json.load(f)
        data.update(video_dict)
        with open(file_path, "w") as f:
            json.dump(data, f)
    else:
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        with open(file_path, "w") as f:
            json.dump(video_dict, f)


def make_scorers(state_dict, model_cfg, config: Optional[ScorerConfig] = None,
                 n_devices: int = 1, **overrides) -> List[FrameScorer]:
    """One FrameScorer per local CUDA device (weights replicated); videos
    are independent, so ``run_scoring`` deals them round-robin with no
    collectives. ``n_devices`` <= 0 means every local card. A CPU config
    gives one scorer."""
    if config is None:
        config = ScorerConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    dev = resolve_device(config.device)
    if dev.type != "cuda":
        return [FrameScorer(state_dict, model_cfg, config)]
    count = torch.cuda.device_count()
    n = count if n_devices <= 0 else min(n_devices, count)
    if n == 1:
        return [FrameScorer(state_dict, model_cfg, config)]
    return [FrameScorer(state_dict, model_cfg, config, device=f"cuda:{i}")
            for i in range(n)]


def run_scoring(dataset, scorer, file_path: str, num_workers: int = 4,
                shard_id: int = 0, num_shards: int = 1, log_every: int = 1,
                pipeline_depth: int = 2, group_videos: int = 8) -> None:
    """Iterate the scoring dataset with host prefetch, exporting per video.

    ``scorer`` is a FrameScorer or a list of them (make_scorers): video
    groups are dealt round-robin across scorers. ``--num_shards`` splits
    the videos across processes or hosts. Up to ``pipeline_depth`` groups
    per scorer stay queued while older groups are fetched and exported, so
    the host sync and the JSON export hide behind the device's work."""
    from ..data.loader import PrefetchLoader, shard_indices

    scorers = scorer if isinstance(scorer, (list, tuple)) else [scorer]
    idx = shard_indices(len(dataset), shard_id, num_shards)
    loader = PrefetchLoader(dataset, indices=idx, num_workers=num_workers)

    pending_groups: List[List[tuple]] = []
    group: List[dict] = []
    group_frames = 0
    next_scorer = 0

    def drain_to(depth: int):
        while len(pending_groups) > depth:
            for path, handle in pending_groups.pop(0):
                export_loss(handle.fetch(), path, file_path)

    def flush_group():
        nonlocal group, group_frames, next_scorer
        if not group:
            return
        handles = scorers[next_scorer].score_group_async(group)
        next_scorer = (next_scorer + 1) % len(scorers)
        pending_groups.append([(it["path"], h) for it, h in zip(group, handles)])
        group, group_frames = [], 0
        drain_to(max(1, pipeline_depth) * len(scorers))

    for i, item in enumerate(loader):
        if log_every and i % log_every == 0:
            print(f"{i + 1} / {len(idx)}", flush=True)
        n_f = 0 if item["dummy"] else item["frames"].shape[0]
        if group and (len(group) >= group_videos
                      or group_frames + n_f > MAX_GROUP_FRAMES):
            flush_group()
        group.append(item)
        group_frames += n_f
    flush_group()
    drain_to(0)
