"""Per-frame DINO importance scoring on the card (counterpart of the JAX
package's ``engine/scoring.py``: the exact windowed path and banded
one-pass scoring).

For every frame of a video the scorer runs the student forward over the
frame's 3-frame local window and the teacher forward over its 30-frame
global window, and scores the frame with the DINO cross-entropy between
the two CLS features (ref: dino_similarity.py:16-93). Frames cross to the
device once per video: the windows are gathered on the device by index
from one frame buffer per video group (concatenated across the group,
with index offsets), and a chunk of frames is scored per call — two
batched forwards and a vectorized loss. Launches are queued without host
syncs; results are fetched once per video group.

Banded one-pass scoring (``band_mode``, ``models/banded.py``) processes
each frame once per pass instead of once per overlapping window: "both"
runs a banded teacher pass (band = global window) and a banded student pass
(band = local window) per segment of up to ``band_chunk`` frames; "teacher"
keeps the exact windowed students and takes its teacher rows from the
banded teacher pass.

Numerics: f32 (``precision="highest"``, TF32 off) is the reference-compat
tier and reproduces the JAX package's f32 golden scores; bf16 is the
production tier and runs every block through the Hopper kernels on a CUDA
device (``use_kernels="auto"``): the whole-block pair on the windowed path,
the banded kernels and the MLP-phase kernel on the banded path. The mixed
teacher (``teacher_dtype=torch.float32`` with bf16 students, exact windows)
runs the teacher forward on its own f32 model, built from the original
weights: f32 activations and block boundaries, bf16 matmul operands,
through the kernels' f32 tiers on the card. With ``band_mode`` it raises
(ROADMAP §3).

Frames reach the card in one of four forms (JAX ``_make_buffer`` and
``_gather_views``): normalized floats (uploaded in the teacher's dtype),
uint8 RGB (T, H, W, 3), or packed I420 / yuv420q uint8 (T, rows, W), read
by ``ScorerConfig.wire_format``. A uint8 buffer ships as its bytes, and
every view gather unpacks and normalizes it on the card in the forward's
own dtype (``ops/wire.py``: the hand-written kernel on the kernel route,
its plain twin otherwise).

The int8 tiers (``teacher_quant`` / ``student_quant``, JAX
``ScorerConfig``'s) quantize the teacher's or the students' dense block
weights (W8A8, ``ops/quant.py``) from the original state dict; in bf16 on
the card the quantized forwards run the int8 tier of the whole-block pair
(s8 wgmma GEMMs), on the plain path ``quant.int8_linear``. Exact windows
only; ``teacher_quant`` not with the mixed teacher. The approximation knobs
of the JAX scorer (teacher/score strides) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..models import banded
from ..models.timesformer import TimeSformerConfig, build_timesformer
from ..ops import wire
from ..ops.banded_block import banded_problems
from ..ops.quant import quantize_state_dict_int8
from ..train.dino import scoring_dino_loss
from ..utils.device import resolve_device
from ..utils.flops import banded_pass_flops

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
    band_mode: None (exact windows), "both" or "teacher" (module docstring).
    band_chunk: frames per banded pass; longer videos run in segments that
      overlap by ``band_halo`` frames on each side, so frames near a seam
      keep their full CLS window (band_halo >= global_size // 2).
    band_block: query frames per block of the plain route's slab-blocked
      banded attention.
    teacher_dtype: the teacher forward's dtype; None means
      ``compute_dtype``. ``torch.float32`` with ``compute_dtype=bfloat16``
      is the mixed-teacher tier (JAX ``ScorerConfig.teacher_dtype``): the
      teacher runs with f32 activations on weights cast from the ORIGINAL
      state dict (not the students' bf16 copy), on f32 views of the
      frames, and on the card through the kernels' f32 tiers (bf16 matmul
      operands, f32 LN weights, f32 carries); the students stay bf16. At
      teacher_temp 0.02 the teacher softmax is the score's sharpest noise
      amplifier, so teacher precision buys score fidelity. Exact windows
      only: with ``band_mode`` it raises NotImplementedError.
    teacher_quant, student_quant: None or "int8": the teacher's, or the
      students', seven dense layers of every block quantized to int8 (W8A8
      dynamic PTQ, ``ops/quant.py``: per-channel weights quantized once
      from the ORIGINAL state dict, per-row activations), as JAX's. With
      both, teacher and students share one quantized model. Exact windows
      only (with ``band_mode`` they raise NotImplementedError), and
      ``teacher_quant`` not with the mixed teacher; ``student_quant`` with
      it is allowed.
    wire_format: how 3-D uint8 frames (T, rows, W) are read: "yuv420", the
      codec's packed I420 planes (default), or "yuv420q", I420 with
      eighth-resolution chroma (experimental: 16-27% relative score error
      on the JAX package's synthetic validators). uint8 RGB (T, H, W, 3)
      and float frames do not read it.
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
    band_mode: Optional[str] = None
    band_chunk: int = 512
    band_halo: int = 32
    band_block: int = 32
    teacher_dtype: Optional[torch.dtype] = None
    wire_format: str = "yuv420"
    teacher_quant: Optional[str] = None
    student_quant: Optional[str] = None


class FrameScorer:
    """Batched per-frame scorer for one model and window geometry: exact
    windows, or banded one-pass scoring with ``band_mode``.

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
                "the kernels run bf16 students (their f32 tiers serve only "
                "the mixed teacher, teacher_dtype=torch.float32 with "
                "compute_dtype=torch.bfloat16); run f32 on the plain path")
        t_dtype = config.teacher_dtype
        if t_dtype is None or t_dtype == self.compute_dtype:
            t_dtype = self.compute_dtype
        elif not (t_dtype == torch.float32 and self.compute_dtype == torch.bfloat16):
            raise NotImplementedError(
                f"teacher_dtype={t_dtype} with compute_dtype="
                f"{self.compute_dtype}: the port has the mixed teacher only "
                "(teacher_dtype=torch.float32 with bf16 students)")
        self.teacher_dtype = t_dtype
        if config.wire_format not in ("yuv420", "yuv420q"):
            raise ValueError(f"wire_format={config.wire_format!r}, expected "
                             "'yuv420' or 'yuv420q'")
        for name in ("teacher_quant", "student_quant"):
            if getattr(config, name) not in (None, "int8"):
                raise ValueError(f"{name}={getattr(config, name)!r}: None or 'int8'")
        self.teacher_quant, self.student_quant = config.teacher_quant, config.student_quant
        if config.band_mode is not None and (self.teacher_quant or self.student_quant):
            raise NotImplementedError(
                "band_mode with teacher_quant or student_quant: banded int8 is "
                "not ported (ROADMAP queue 1 item 5a); score exact windows")
        if self.teacher_quant and t_dtype != self.compute_dtype:
            raise NotImplementedError(
                "teacher_quant with the mixed teacher (teacher_dtype=float32) is "
                "not ported (ROADMAP queue 1 item 5b): no JAX bench mode runs it")
        self.band_mode = config.band_mode
        if self.band_mode is not None and t_dtype != self.compute_dtype:
            raise NotImplementedError(
                "band_mode with the mixed teacher is not ported: on the card "
                "its losses sat further from the f32 losses than the bf16 "
                "kernel path's on one clip (ROADMAP §3); score exact windows "
                "(band_mode=None) with the mixed teacher")
        if self.band_mode is not None:
            if self.band_mode not in ("both", "teacher"):
                raise ValueError(f"band_mode={self.band_mode!r}")
            if config.band_halo < self.global_size // 2:
                raise ValueError(
                    f"band_halo={config.band_halo} must cover half the "
                    f"global window ({self.global_size // 2}) so seam "
                    "frames keep their full CLS window")
            if config.band_chunk < self.global_size:
                raise ValueError("band_chunk must be >= global_size")
            if config.band_chunk <= 2 * config.band_halo:
                raise ValueError(
                    f"band_chunk={config.band_chunk} must exceed twice "
                    f"band_halo={config.band_halo}: each segment emits "
                    "band_chunk - 2 * band_halo frames")
            if use:
                bad = banded_problems(model_cfg.embed_dim, model_cfg.num_heads,
                                      model_cfg.num_patches,
                                      int(model_cfg.embed_dim * model_cfg.mlp_ratio))
                if bad:
                    raise ValueError(f"band_mode with the kernels: {bad}")
        self.model_cfg = dataclasses.replace(model_cfg, use_kernels=bool(use))
        # the int8 tiers' weights, quantized from the original state dict
        q_sd = (quantize_state_dict_int8(state_dict)
                if self.teacher_quant or self.student_quant else None)
        self.model = build_timesformer(
            self.model_cfg, q_sd if self.student_quant else state_dict,
            device=self.device, dtype=self.compute_dtype)
        if (self.teacher_dtype == self.compute_dtype
                and self.teacher_quant == self.student_quant):
            self.t_model = self.model
        else:  # from the original weights, not the students' bf16 copy
            self.t_model = build_timesformer(
                self.model_cfg, q_sd if self.teacher_quant else state_dict,
                device=self.device, dtype=self.teacher_dtype)
        self._dummy_loss: Optional[float] = None
        # rows computed (window rows per pass), and for the banded passes the
        # chunk rows processed (padding and seam halo included) and the
        # analytic FLOP they cost
        self.stats = {"teacher_rows": 0, "student_rows": 0,
                      "band_teacher_frames": 0, "band_student_frames": 0,
                      "band_flops": 0.0}

    # -- one chunk -------------------------------------------------------------

    def _layout(self, frames) -> Optional[str]:
        """The wire layout of a uint8 frame array or buffer (numpy or
        torch): "rgb8" for (T, H, W, 3), ``wire_format`` for packed
        (T, rows, W); None for float frames."""
        if frames.dtype not in (np.uint8, torch.uint8):
            return None
        if frames.ndim == 4 and frames.shape[-1] == 3:
            return "rgb8"
        if frames.ndim == 3:
            return self.config.wire_format
        raise ValueError(f"uint8 frames of shape {tuple(frames.shape)}: expected "
                         "RGB (T, H, W, 3) or packed (T, rows, W)")

    def _gather(self, frames: torch.Tensor, idx: np.ndarray,
                dtype: torch.dtype) -> torch.Tensor:
        """(M, H, W, 3) frames at the host indices ``idx`` in ``dtype``: a
        uint8 buffer through the wire's gather (its kernel on the kernel
        route, its twin otherwise), a float buffer by indexing."""
        layout = self._layout(frames)
        if layout is not None:
            gather = (wire.gather_normalize if self.model_cfg.use_kernels
                      else wire.gather_normalize_plain)
            return gather(frames, idx, dtype, layout)
        return frames[wire.index_tensor(idx, frames.shape[0], frames.device)].to(dtype)

    def _gather_views(self, frames: torch.Tensor, idx: np.ndarray,
                      dtype: torch.dtype) -> torch.Tensor:
        """Gather (chunk, n_view) windows by the host index matrix ``idx``
        from the frame buffer in ``dtype``; returns (chunk, C, n_view, H,
        W)."""
        v = self._gather(frames, idx.reshape(-1), dtype)
        return v.reshape(*idx.shape, *v.shape[1:]).permute(0, 4, 1, 2, 3)

    def _loss(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return scoring_dino_loss(s, t, teacher_temp=self.teacher_temp,
                                 student_temp=self.student_temp)

    @torch.inference_mode()
    def _score_chunk(self, frames, loc_idx, glob_idx) -> torch.Tensor:
        """Both forwards + the loss for a chunk of frames: (chunk,) f32."""
        s = self.model(self._gather_views(frames, loc_idx, self.compute_dtype))
        t = self.t_model(self._gather_views(frames, glob_idx, self.teacher_dtype))
        return self._loss(s, t)

    @torch.inference_mode()
    def _student_chunk(self, frames, loc_idx, t_rows) -> torch.Tensor:
        """The student forward + the loss against given teacher rows."""
        return self._loss(self.model(self._gather_views(frames, loc_idx,
                                                        self.compute_dtype)), t_rows)

    # -- banded one-pass scoring ------------------------------------------------

    def _band_segments(self, T: int) -> List[tuple]:
        """[(w0, w1, e0, e1)]: compute windows [w0, w1) tiling the video
        with ``band_halo`` overlap; rows [e0, e1) are emitted."""
        cap = self.config.band_chunk
        if T <= cap:
            return [(0, T, 0, T)]
        halo = self.config.band_halo
        step = cap - 2 * halo
        segs, e0 = [], 0
        while e0 < T:
            e1 = min(e0 + step, T)
            segs.append((max(0, e0 - halo), min(T, e1 + halo), e0, e1))
            e0 = e1
        return segs

    _BAND_BUCKETS = (64, 128, 256, 384, 512)

    def _band_bucket(self, n: int) -> int:
        """Pad segment lengths to a few chunk sizes, so short videos do not
        pay for a full ``band_chunk``."""
        cap = self.config.band_chunk
        for b in self._BAND_BUCKETS:
            if b >= cap:
                break
            if n <= b:
                return b
        return cap if n <= cap else n

    @torch.inference_mode()
    def _band_pass(self, frames: torch.Tensor, t_real: int, eff: int,
                   kind: str) -> torch.Tensor:
        """(Cb, D) f32 CLS rows of one banded pass over gathered frames
        (the teacher's model for the teacher pass)."""
        Cb = frames.shape[0]
        self.stats[f"band_{kind}_frames"] += Cb
        self.stats["band_flops"] += banded_pass_flops(
            self.model_cfg, Cb, eff, self.config.band_block,
            fused=self.model_cfg.use_kernels)
        model = self.t_model if kind == "teacher" else self.model
        return banded.banded_cls_features(model, frames, t_real, eff,
                                          block=self.config.band_block)

    def _score_video_banded(self, frames: np.ndarray, local_idx: np.ndarray,
                            eff_global: int) -> "PendingScore":
        """Per segment, one banded teacher pass and, in "both" mode, one
        banded student pass; in "teacher" mode the exact windowed student
        chunks then score against the banded teacher rows (a device-side
        hand-off). Nothing is fetched."""
        T = frames.shape[0]
        buf = self._upload(frames)
        outs, t_parts = [], []
        for w0, w1, e0, e1 in self._band_segments(T):
            Lw = w1 - w0
            Cb = self._band_bucket(Lw)
            # padding rows repeat the segment's last frame; their rows drop.
            # Both passes read these views (the teacher's dtype is the
            # students' on the banded path)
            fr = self._gather(buf, np.minimum(w0 + np.arange(Cb), w1 - 1),
                              self.teacher_dtype)
            t_rows = self._band_pass(fr, Lw, eff_global, "teacher")
            if self.band_mode == "both":
                s_rows = self._band_pass(fr, Lw, self.local_size, "student")
                outs.append((self._loss(s_rows, t_rows)[e0 - w0:e1 - w0],
                             e1 - e0))
            else:
                t_parts.append(t_rows[e0 - w0:e1 - w0])
        self.stats["teacher_rows"] += T
        self.stats["student_rows"] += T
        if self.band_mode == "both":
            return PendingScore(outs)
        t_all = torch.cat(t_parts)
        n_chunks = -(-T // self.chunk)
        pad = n_chunks * self.chunk - T
        loc = np.pad(np.asarray(local_idx), ((0, pad), (0, 0))).reshape(
            n_chunks, self.chunk, -1)
        t_all = torch.nn.functional.pad(t_all, (0, 0, 0, pad)).reshape(
            n_chunks, self.chunk, -1)
        for c in range(n_chunks):
            n = min(self.chunk, T - c * self.chunk)
            outs.append((self._student_chunk(buf, loc[c], t_all[c]), n))
        return PendingScore(outs)

    # -- video groups ----------------------------------------------------------

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """uint8 frames (RGB or packed) travel as their bytes; normalized
        float frames in the teacher's dtype (the compute dtype, or f32 for
        the mixed teacher). Each forward's gather makes its views in its
        own dtype on the device."""
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if t.dtype == torch.uint8:
            return t.to(self.device)
        return t.to(self.device, self.teacher_dtype)

    def _run_group_chunks(self, items: List[dict]) -> List[tuple]:
        """Score the rows of several videos as one stream of full chunks
        (chunks may straddle videos). Returns [(device_losses, n_valid)],
        rows in video order; nothing is fetched. The videos must share one
        frame layout (float, uint8 RGB or one packed wire)."""
        layouts = {self._layout(it["frames"]) for it in items}
        if len(layouts) > 1:
            raise ValueError(f"a video group mixes frame layouts {layouts}: "
                             "score them in separate groups")
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

        def chunked(mats):  # padded rows gather frame 0; their losses drop
            m = np.pad(np.concatenate(mats), ((0, pad), (0, 0)))
            return m.reshape(n_chunks, self.chunk, m.shape[1])

        loc, glob = chunked(locs), chunked(globs)
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
        if self.band_mode is not None:
            # banded passes batch within a video (chunk buckets)
            return [self.score_item_async(it) for it in items]
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
            self.stats["teacher_rows"] += T
            self.stats["student_rows"] += T
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
        if self.band_mode is not None:
            return self._score_video_banded(frames, local_idx, eff_global)
        item = {"frames": frames, "local_idx": local_idx,
                "global_idx": global_idx}
        self.stats["teacher_rows"] += frames.shape[0]
        self.stats["student_rows"] += frames.shape[0]
        return PendingScore(self._run_group_chunks([item]))

    def score_item_async(self, item: dict) -> "PendingScore":
        """Queue one DinoLossDataset item's scoring; ``.fetch()`` the handle
        for the losses. Dummies get the constant-loss protocol."""
        if item["dummy"]:
            return PendingScore([], ready=self.dummy_losses())
        return self.score_video_async(item["frames"], item["local_idx"],
                                      item["global_idx"], item["eff_global"])

    def score_video(self, frames: np.ndarray, local_idx: np.ndarray,
                    global_idx: np.ndarray, eff_global: int) -> np.ndarray:
        """frames: (T, H, W, 3) float32 normalized, (T, H, W, 3) uint8 RGB,
        or (T, rows, W) uint8 packed in ``wire_format``; returns (T,)
        float64 losses."""
        return self.score_video_async(frames, local_idx, global_idx,
                                      eff_global).fetch()

    @torch.inference_mode()
    def dummy_losses(self) -> np.ndarray:
        """Constant-loss protocol for corrupt / size-mismatched videos: the
        reference scores global_size pairs of all-zero (3, 60, 224, 224)
        views (ref: dino_loss_loader.py:34-38, dino_similarity.py:66-93),
        yielding global_size identical values."""
        if self._dummy_loss is None:
            dev = self.device
            s = self.model(torch.zeros((1, 3, self.local_size, 224, 224),
                                       dtype=self.compute_dtype, device=dev))
            t = self.t_model(torch.zeros((1, 3, 60, 224, 224),
                                         dtype=self.teacher_dtype, device=dev))
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
