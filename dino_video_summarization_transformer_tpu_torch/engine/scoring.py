"""Per-frame DINO importance scoring on the card (counterpart of the JAX
package's ``engine/scoring.py``: the exact windowed path, the strided and
refined approximations, and banded one-pass scoring).

For every frame of a video the scorer runs the student forward over the
frame's 3-frame local window and the teacher forward over its 30-frame
global window, and scores the frame with the DINO cross-entropy between
the two CLS features (ref: dino_similarity.py:16-93). Frames cross to the
device once per video: the windows are gathered on the device by index
from one frame buffer per video group (concatenated across the group,
with index offsets), and a chunk of frames is scored per call — two
batched forwards and a vectorized loss. Launches are queued without host
syncs; results are fetched once per video group.

The approximation knobs (JAX ``ScorerConfig``, same names, defaults and
checks): ``global_subsample`` samples every s-th frame of the teacher
window; ``teacher_stride`` runs the teacher only at every k-th scored
frame (plus the last) and interpolates its rows between these knots
(``teacher_interp``: linear or Catmull-Rom; ``teacher_target="probs"``
interpolates the knots' softmax instead of their CLS rows);
``teacher_adaptive`` and ``teacher_refine`` bisect the knot intervals
where the luma motion, or the knots' leave-one-out interpolation error
(one host readback), is large; ``score_stride`` scores every m-th frame
(plus the last) and interpolates the losses, ``score_refine`` bisects
where the loss curve's leave-one-out error is large (at fetch time) and
``score_bail`` scores every frame instead once that would touch most of
them; ``teacher_img`` resizes the teacher views (bilinear, antialiased as
JAX's ``jax.image.resize``); ``student_dispatch`` gathers the views of
that many student chunks at once. A video group's teacher and student
chunks are shared across its videos.

Banded one-pass scoring (``band_mode``, ``models/banded.py``) processes
each frame once per pass instead of once per overlapping window: "both"
runs a banded teacher pass (band = global window) and a banded student pass
(band = local window) per segment of up to ``band_chunk`` frames; "teacher"
keeps the exact windowed students and takes its teacher rows from the
banded teacher pass. It composes with none of the knobs above. With the
mixed teacher each pass gathers the segment's frames in its own model's
dtype (f32 views for the f32 teacher pass, bf16 for the student pass).

Numerics: f32 (``precision="highest"``, TF32 off) is the reference-compat
tier and reproduces the JAX package's f32 golden scores; bf16 is the
production tier and runs every block through the Hopper kernels on a CUDA
device (``use_kernels="auto"``): the whole-block pair on the windowed
paths, the banded kernels and the MLP-phase kernel on the banded path. f32
with ``use_kernels=True`` (JAX's ``use_pallas=True`` at f32) runs students
and teacher through the whole-block pair's f32 tier: f32 activations and
block boundaries, bf16 matmul operands. The mixed teacher
(``teacher_dtype=torch.float32`` with bf16 students) runs the teacher
forward on its own f32 model, built from the original weights, through
the same f32 tier on the card (on the banded path: the f32 tiers of the
banded spatial phase and the grid MLP).

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
(s8 wgmma GEMMs; the int8 teacher under the mixed teacher its f32 tier),
on the plain path ``quant.int8_linear``. Banded int8 runs on the plain
path only (JAX's XLA route): the kernel route refuses it, as JAX's Pallas
banded route does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data import yuv
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
      (at f32 the whole-block pair's f32 tier, bf16 matmul operands; on CPU
      tensors it runs the kernels' plain twins, as the tests do); False
      forces the plain path.
    precision: "highest" turns TF32 off for matmuls and convolutions (the
      f32 reference-compat tier; on the kernel route it governs the work
      outside the kernels: the patch embedding and the final LN); None
      leaves PyTorch's settings alone.
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
      amplifier, so teacher precision buys score fidelity. With
      ``band_mode`` the teacher pass runs on the f32 model and f32 views.
    teacher_quant, student_quant: None or "int8": the teacher's, or the
      students', seven dense layers of every block quantized to int8 (W8A8
      dynamic PTQ, ``ops/quant.py``: per-channel weights quantized once
      from the ORIGINAL state dict, per-row activations), as JAX's. With
      both, teacher and students share one quantized model. With the
      mixed teacher, ``teacher_quant`` quantizes the f32 teacher (the int8
      tier's f32 block boundary on the kernels). With ``band_mode`` they run
      on the plain route only (``use_kernels=False``, or "auto" off the
      card's bf16 tier): the kernel route raises NotImplementedError.
    wire_format: how 3-D uint8 frames (T, rows, W) are read: "yuv420", the
      codec's packed I420 planes (default), or "yuv420q", I420 with
      eighth-resolution chroma (experimental: 16-27% relative score error
      on the JAX package's synthetic validators). uint8 RGB (T, H, W, 3)
      and float frames do not read it.
    global_subsample s > 1: the teacher window keeps its span but takes
      every s-th frame (30 -> 15 frames at s = 2).
    teacher_stride k > 1: the teacher forward runs at every k-th scored
      frame and the last; the frames between get its rows interpolated
      (``teacher_interp``: "linear", or "catmullrom", the cubic through the
      knots with tangents over the uneven spans).
    teacher_target: "cls" interpolates the raw CLS rows, which the loss
      softmaxes; "probs" softmaxes at the knots (teacher_temp) and
      interpolates the probabilities, which the loss reads as they are.
    teacher_adaptive alpha > 0: knot intervals whose summed luma motion
      exceeds alpha x the mean interval's get their midpoint as a knot.
    teacher_refine alpha > 0: after the knot pass, every interior knot
      whose leave-one-out linear interpolation error in feature space
      (relative L2) exceeds alpha has both its intervals bisected by a
      second teacher pass (one host readback of the error vector).
    score_stride m > 1: only every m-th frame (and the last) is scored;
      the losses between are linearly interpolated (float64, np.interp).
    score_refine alpha > 0 (with m > 1): at fetch time, both intervals
      around every scored frame whose leave-one-out loss error exceeds
      alpha x the mean loss are bisected by a second student pass (teacher
      rows from the knots' interpolation).
    score_bail: when that refinement would score at least this fraction
      of the video's frames, every unscored frame is scored instead; 0
      disables.
    teacher_img r > 0: the teacher views are resized to r x r (bilinear,
      antialiased on a downscale, as JAX's ``jax.image.resize``) and the
      positional grid follows (r >= 2 x patch size).
    student_dispatch: student chunks per call, clamped to the pass's
      chunks: one view gather for all of them, then one forward and loss
      per chunk of ``chunk`` rows, so the losses equal 1's bit for bit.
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
    global_subsample: int = 1
    teacher_stride: int = 1
    score_stride: int = 1
    teacher_img: int = 0
    teacher_interp: str = "linear"
    teacher_target: str = "cls"
    teacher_adaptive: float = 0.0
    teacher_refine: float = 0.0
    score_refine: float = 0.0
    score_bail: float = 0.9
    student_dispatch: int = 4


class FrameScorer:
    """Batched per-frame scorer for one model and window geometry: exact
    windows, their strided and refined approximations, or banded one-pass
    scoring with ``band_mode``.

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
        self.global_subsample = max(1, int(config.global_subsample))
        self.teacher_stride = max(1, int(config.teacher_stride))
        self.score_stride = max(1, int(config.score_stride))
        if config.teacher_interp not in ("linear", "catmullrom"):
            raise ValueError(f"teacher_interp={config.teacher_interp!r}")
        self.teacher_interp = config.teacher_interp
        if config.teacher_target not in ("cls", "probs"):
            raise ValueError(f"teacher_target={config.teacher_target!r}")
        self.teacher_target = config.teacher_target
        self.teacher_adaptive = max(0.0, float(config.teacher_adaptive))
        self.teacher_refine = max(0.0, float(config.teacher_refine))
        self.score_refine = max(0.0, float(config.score_refine))
        self.student_dispatch = max(1, int(config.student_dispatch))
        self.teacher_img = int(config.teacher_img)
        if self.teacher_img:
            # the positional grid's resize (H = n_tokens // W, counting the
            # CLS token) breaks on a 1 x 1 patch grid
            assert self.teacher_img >= 2 * model_cfg.patch_size, (
                self.teacher_img, model_cfg.patch_size)
        self.band_mode = config.band_mode
        if self.band_mode is not None:
            if self.band_mode not in ("both", "teacher"):
                raise ValueError(f"band_mode={self.band_mode!r}")
            incompatible = {
                "teacher_stride": self.teacher_stride > 1,
                "score_stride": self.score_stride > 1,
                "global_subsample": self.global_subsample > 1,
                "teacher_img": bool(self.teacher_img),
                "teacher_target": self.teacher_target != "cls",
                "teacher_adaptive": self.teacher_adaptive > 0,
                "teacher_refine": self.teacher_refine > 0,
                "score_refine": self.score_refine > 0,
            }
            bad = [k for k, v in incompatible.items() if v]
            if bad:
                raise ValueError(
                    f"band_mode does not compose with {bad}: the banded "
                    "pass already computes every frame once")
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
        if (self.band_mode is not None and use
                and (self.teacher_quant or self.student_quant)):
            raise NotImplementedError(
                f"band_mode with an int8 option on the kernel route: "
                f"{banded.BANDED_INT8_KERNELS}; pass use_kernels=False")
        if self.band_mode is not None:
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
        self._resize_w: Dict[tuple, torch.Tensor] = {}
        # window rows computed (teacher knots and scored frames on the
        # strided paths), and for the banded passes the chunk rows processed
        # (padding and seam halo included) and the analytic FLOP they cost
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

    def _teacher_views(self, frames: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """The teacher's windows, resized to ``teacher_img`` where set (JAX
        ``_resize_teacher``: ``resize_weights`` in the views' dtype)."""
        v = self._gather_views(frames, idx, self.teacher_dtype)
        r = self.teacher_img
        if not r or v.shape[-1] == r:
            return v
        H, W = v.shape[-2:]
        key = (H, W, v.dtype)
        if key not in self._resize_w:
            self._resize_w[key] = tuple(
                _to_device(resize_weights(n, r), v.device).to(v.dtype) for n in (H, W))
        wh, ww = self._resize_w[key]
        return torch.matmul(wh.t(), torch.matmul(v, ww))

    def _loss(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Per-frame loss against teacher rows: CLS rows, or ready
        probabilities (``teacher_target="probs"``: the loss is linear in
        them, so interpolated rows are valid as they are)."""
        if self.teacher_target == "probs":
            logp = torch.log_softmax(s.float() / self.student_temp, dim=-1)
            return -torch.sum(t.float() * logp, dim=-1)
        return scoring_dino_loss(s, t, teacher_temp=self.teacher_temp,
                                 student_temp=self.student_temp)

    @torch.inference_mode()
    def _score_chunk(self, frames, loc_idx, glob_idx) -> torch.Tensor:
        """Both forwards + the loss for a chunk of frames: (chunk,) f32."""
        s = self.model(self._gather_views(frames, loc_idx, self.compute_dtype))
        t = self.t_model(self._teacher_views(frames, glob_idx))
        return scoring_dino_loss(s, t, teacher_temp=self.teacher_temp,
                                 student_temp=self.student_temp)

    @torch.inference_mode()
    def _teacher_chunk(self, frames, glob_idx) -> torch.Tensor:
        """(chunk, D) f32 teacher rows (JAX ``_build_teacher``): raw CLS
        rows, or their softmax at teacher_temp (``teacher_target="probs"``)."""
        t = self.t_model(self._teacher_views(frames, glob_idx)).float()
        if self.teacher_target == "probs":
            t = torch.softmax(t / self.teacher_temp, dim=-1)
        return t

    @torch.inference_mode()
    def _student_call(self, frames, loc_idx, t_rows) -> torch.Tensor:
        """Students + loss against given teacher rows over a multiple of
        ``chunk`` rows (JAX ``_build_student(sub)``): one view gather for
        every row, then one forward and loss per chunk of ``chunk`` rows —
        the single-chunk computation, so the losses do not depend on how
        many chunks a call takes."""
        views = self._gather_views(frames, loc_idx, self.compute_dtype)
        c = self.chunk
        return torch.cat([self._loss(self.model(views[r0:r0 + c]), t_rows[r0:r0 + c])
                          for r0 in range(0, views.shape[0], c)])

    def _student_sub(self, n_rows: int) -> int:
        """Chunks per student call for a pass of ``n_rows``:
        ``student_dispatch`` clamped to the chunks there are."""
        return max(1, min(self.student_dispatch, -(-n_rows // self.chunk)))

    def _run_rows(self, fn, mats: List[np.ndarray], extra=None,
                  chunk: Optional[int] = None) -> List[tuple]:
        """fn(*idx_rows[, extra_rows]) over the rows of the host index
        matrices ``mats`` (each (R, W_i), into one frame buffer), ``chunk``
        rows a call (default ``self.chunk``, else a multiple of it). The
        rows are padded to a multiple of ``self.chunk`` with index-0 rows
        (and zero ``extra`` rows, a device (R, D) tensor), whose outputs
        drop. Returns [(device_out, n_valid)]; nothing is fetched."""
        step = self.chunk if chunk is None else chunk
        R = mats[0].shape[0]
        pad = -R % self.chunk
        mats = [np.pad(np.asarray(m), ((0, pad), (0, 0))) for m in mats]
        if extra is not None and pad:
            extra = torch.nn.functional.pad(extra, (0, 0, 0, pad))
        outs = []
        for r0 in range(0, R, step):
            args = [m[r0:r0 + step] for m in mats]
            if extra is not None:
                args.append(extra[r0:r0 + step])
            outs.append((fn(*args), min(step, R - r0)))
        return outs

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
        """(Cb, D) f32 CLS rows of one banded pass over frames gathered in
        its model's dtype (the teacher's model for the teacher pass)."""
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
            # Each pass reads the views in its model's dtype: one gather
            # for both where the dtypes agree, two under the mixed teacher
            idx = np.minimum(w0 + np.arange(Cb), w1 - 1)
            fr = self._gather(buf, idx, self.teacher_dtype)
            t_rows = self._band_pass(fr, Lw, eff_global, "teacher")
            if self.band_mode == "both":
                if self.compute_dtype != self.teacher_dtype:
                    fr = self._gather(buf, idx, self.compute_dtype)
                s_rows = self._band_pass(fr, Lw, self.local_size, "student")
                outs.append((self._loss(s_rows, t_rows)[e0 - w0:e1 - w0],
                             e1 - e0))
            else:
                t_parts.append(t_rows[e0 - w0:e1 - w0])
        self.stats["teacher_rows"] += T
        self.stats["student_rows"] += T
        if self.band_mode == "both":
            return PendingScore(outs)
        return PendingScore(self._run_rows(
            partial(self._student_call, buf), [np.asarray(local_idx)],
            extra=torch.cat(t_parts), chunk=self.chunk * self._student_sub(T)))

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

    def _group_buffer(self, items: List[dict]):
        """One device buffer of the group's frames (concatenated), and each
        video's local and global index matrices offset into it, the global
        ones subsampled by ``global_subsample`` (JAX ``_group_inputs``).
        The videos must share one frame layout (float, uint8 RGB or one
        packed wire)."""
        layouts = {self._layout(it["frames"]) for it in items}
        if len(layouts) > 1:
            raise ValueError(f"a video group mixes frame layouts {layouts}: "
                             "score them in separate groups")
        bufs, locs, globs = [], [], []
        off = 0
        for it in items:
            bufs.append(self._upload(it["frames"]))
            locs.append(np.asarray(it["local_idx"]) + off)
            globs.append(np.asarray(it["global_idx"])[:, ::self.global_subsample] + off)
            off += it["frames"].shape[0]
        frames = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
        return frames, locs, globs

    def _run_group_chunks(self, items: List[dict]) -> List[tuple]:
        """Exact windows: score the rows of several videos as one stream of
        full chunks (chunks may straddle videos). Returns [(device_losses,
        n_valid)], rows in video order; nothing is fetched."""
        frames, locs, globs = self._group_buffer(items)
        return self._run_rows(partial(self._score_chunk, frames),
                              [np.concatenate(locs), np.concatenate(globs)])

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
                eff = len(range(0, item["eff_global"], self.global_subsample))
                groups.setdefault(eff, []).append(i)
        for idxs in groups.values():
            group = [items[i] for i in idxs]
            handles = (self._score_group_strided(group) if self._strided
                       else self._score_group_exact(group))
            for i, h in zip(idxs, handles):
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

    # -- the strided paths -----------------------------------------------------

    @property
    def _strided(self) -> bool:
        return self.teacher_stride > 1 or self.score_stride > 1

    def _teacher_positions(self, pos: np.ndarray, frames: np.ndarray) -> np.ndarray:
        """Teacher knot positions (frame timeline): every
        ``teacher_stride``-th scored position and the last; with
        ``teacher_adaptive`` alpha > 0, the midpoint of every interval whose
        summed luma motion exceeds alpha x the mean interval's."""
        k = self.teacher_stride
        tsel = np.arange(0, len(pos), k)
        if tsel[-1] != len(pos) - 1:
            tsel = np.append(tsel, len(pos) - 1)
        tpos = pos[tsel]
        if self.teacher_adaptive <= 0.0 or k < 2 or len(tpos) < 2:
            return tpos
        motion = _motion_energy(frames, self.config.wire_format)
        csum = np.concatenate([[0.0], np.cumsum(motion)])
        intervals = csum[tpos[1:]] - csum[tpos[:-1]]  # motion per interval
        mean = float(intervals.mean())
        if mean <= 0.0:
            return tpos
        mids = []
        for i in np.nonzero(intervals > self.teacher_adaptive * mean)[0]:
            lo, hi = tsel[i], tsel[i + 1]
            if hi - lo >= 2:
                mids.append(pos[(lo + hi) // 2])
        if not mids:
            return tpos
        return np.unique(np.concatenate([tpos, np.asarray(mids, dtype=tpos.dtype)]))

    def _refine_mids(self, tpos: np.ndarray, errs: np.ndarray) -> np.ndarray:
        """Midpoints of both intervals around every interior knot whose
        leave-one-out error exceeds ``teacher_refine``."""
        return _bisect(tpos, np.nonzero(errs > self.teacher_refine)[0])

    def _loss_refine_mids(self, pos: np.ndarray, losses: np.ndarray) -> np.ndarray:
        """Midpoints of both intervals around every scored frame whose
        loss-curve leave-one-out error exceeds ``score_refine`` x the mean
        loss."""
        if len(pos) < 3:
            return np.empty(0, pos.dtype)
        l = np.asarray(losses, np.float64)
        w = ((pos[1:-1] - pos[:-2]).astype(np.float64)
             / np.maximum(pos[2:] - pos[:-2], 1))
        l_hat = l[:-2] * (1.0 - w) + l[2:] * w
        scale = max(float(np.abs(l).mean()), 1e-12)
        errs = np.abs(l[1:-1] - l_hat) / scale
        return _bisect(pos, np.nonzero(errs > self.score_refine)[0])

    def _score_refine_rows(self, pos: np.ndarray, losses: np.ndarray,
                           T: int) -> np.ndarray:
        """The guarded score stride's extra rows, or every unscored frame
        where they would reach ``score_bail`` of the video."""
        mids = self._loss_refine_mids(pos, losses)
        bail = self.config.score_bail
        if bail > 0 and len(mids) and len(pos) + len(mids) >= bail * T:
            mids = np.setdiff1d(np.arange(T, dtype=pos.dtype), pos)
        return mids

    def _teacher_pass(self, frames, globs, tposs) -> List[torch.Tensor]:
        """Teacher rows at each video's knots, the chunks shared across
        the videos: [(len(tpos), D) f32 device rows]."""
        outs = self._run_rows(partial(self._teacher_chunk, frames),
                              [np.concatenate([g[t] for g, t in zip(globs, tposs)])])
        t_all = torch.cat([o[:n] for o, n in outs])
        return list(torch.split(t_all, [len(t) for t in tposs]))

    def _student_pass(self, frames, locs, poss, extras) -> List[tuple]:
        """Students + loss at each video's positions against its teacher
        rows, the chunks shared across the videos, ``_student_sub`` chunks
        a call: [(device_losses, n_valid)]."""
        n = sum(len(p) for p in poss)
        return self._run_rows(partial(self._student_call, frames),
                              [np.concatenate([l[p] for l, p in zip(locs, poss)])],
                              extra=torch.cat(extras),
                              chunk=self.chunk * self._student_sub(n))

    def _refine_group(self, frames, globs, tposs, feats):
        """Error-adaptive teacher refinement (JAX ``_refine_group``): every
        video's leave-one-out errors in one readback, the midpoints as one
        shared teacher pass, each video's knots merged."""
        errs_dev = [_loo_errs(f, _loo_weights(t)) if len(t) >= 3 else None
                    for t, f in zip(tposs, feats)]
        flat = [e for e in errs_dev if e is not None]
        if not flat:
            return tposs, feats
        cat = torch.cat(flat).cpu().numpy()  # one host sync
        mids_list, off = [], 0
        for tpos, e in zip(tposs, errs_dev):
            if e is None:
                mids_list.append(np.empty(0, tpos.dtype))
                continue
            mids_list.append(self._refine_mids(tpos, cat[off:off + e.shape[0]]))
            off += e.shape[0]
        sel = [i for i, m in enumerate(mids_list) if len(m)]
        if not sel:
            return tposs, feats
        self.stats["teacher_rows"] += sum(len(m) for m in mids_list)
        m_feats = self._teacher_pass(frames, [globs[i] for i in sel],
                                     [mids_list[i] for i in sel])
        tposs, feats = list(tposs), list(feats)
        for i, fm in zip(sel, m_feats):
            order = np.argsort(np.concatenate([tposs[i], mids_list[i]]))
            tposs[i] = np.concatenate([tposs[i], mids_list[i]])[order]
            feats[i] = torch.cat([feats[i], fm])[_to_device(order, fm.device)]
        return tposs, feats

    def _score_group_strided(self, items: List[dict]) -> List["PendingScore"]:
        """Teacher-stride / score-stride scoring of a video group (JAX
        ``_score_video_strided_async`` and ``_score_group_strided``; one
        video is a group of one). Scored positions: every
        ``score_stride``-th frame and the last; teacher knots from
        ``_teacher_positions``, refined by ``teacher_refine``; the teacher
        rows interpolated on the device to every scored position; losses
        between scored positions interpolated on the host."""
        m = self.score_stride
        frames, locs, globs = self._group_buffer(items)
        Ts = [it["frames"].shape[0] for it in items]
        poss, tposs = [], []
        for it, T in zip(items, Ts):
            pos = np.arange(0, T, m)
            if pos[-1] != T - 1:
                pos = np.append(pos, T - 1)
            poss.append(pos)
            tposs.append(self._teacher_positions(pos, it["frames"]))
        self.stats["teacher_rows"] += sum(len(t) for t in tposs)
        self.stats["student_rows"] += sum(len(p) for p in poss)
        feats = self._teacher_pass(frames, globs, tposs)
        if self.teacher_refine > 0.0:
            tposs, feats = self._refine_group(frames, globs, tposs, feats)
        extras = [_interp_rows(t, f, p, self.teacher_interp)
                  for t, f, p in zip(tposs, feats, poss)]
        outs = self._student_pass(frames, locs, poss, extras)
        if m > 1 and self.score_refine > 0.0:
            return self._group_score_refine_handles(frames, locs, Ts, poss, tposs,
                                                    feats, outs)
        gf = _GroupFetch(outs)
        handles, s = [], 0
        for T, pos in zip(Ts, poss):
            post = None if m == 1 else partial(_interp_losses, T, pos)
            handles.append(PendingScore([], group=(gf, s, s + len(pos)), post=post))
            s += len(pos)
        return handles

    def _group_score_refine_handles(self, frames, locs, Ts, poss, tposs, feats,
                                    outs) -> List["PendingScore"]:
        """The guarded score stride over a video group (JAX
        ``_group_score_refine_handles``): at the first fetch, one readback
        of the strided losses, one shared student pass at every video's
        midpoints (teacher rows interpolated from the knots), then each
        video's losses interpolated to all its frames."""

        def compute():
            flat = _fetch_outs(outs)
            losses = np.split(flat, np.cumsum([len(p) for p in poss])[:-1])
            mids = [self._score_refine_rows(p, l, T) for p, l, T in zip(poss, losses, Ts)]
            m_losses = [np.empty(0)] * len(poss)
            sel = [i for i, mm in enumerate(mids) if len(mm)]
            if sel:
                self.stats["student_rows"] += sum(len(mids[i]) for i in sel)
                m_outs = self._student_pass(
                    frames, [locs[i] for i in sel], [mids[i] for i in sel],
                    [_interp_rows(tposs[i], feats[i], mids[i], self.teacher_interp)
                     for i in sel])
                parts = np.split(_fetch_outs(m_outs),
                                 np.cumsum([len(mids[i]) for i in sel])[:-1])
                for i, part in zip(sel, parts):
                    m_losses[i] = part
            res = []
            for T, p, l, mm, ml in zip(Ts, poss, losses, mids, m_losses):
                all_pos = np.concatenate([p, mm])
                order = np.argsort(all_pos)
                res.append(np.interp(np.arange(T), all_pos[order],
                                     np.concatenate([l, ml])[order]))
            return res

        cache: dict = {}

        def get(i):
            if "res" not in cache:
                cache["res"] = compute()
            return cache["res"][i]

        return [PendingScore([], lazy=partial(get, i)) for i in range(len(poss))]

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
        if self._strided:
            return self._score_group_strided([item])[0]
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
    device and returns float64 losses, after the optional host
    post-processing ``post`` (the score stride's interpolation). ``ready``
    holds host-computed results (dummies); ``group`` = (_GroupFetch, start,
    end) slices a video group's shared rows; ``lazy`` is a closure that may
    queue more device work at fetch time (the guarded score stride), its
    result kept so that fetch() can be called again."""

    def __init__(self, outs: List[tuple], post=None, ready: Optional[np.ndarray] = None,
                 group: Optional[tuple] = None, lazy=None):
        self._outs = outs
        self._post = post
        self._ready = ready
        self._group = group
        self._lazy = lazy

    def fetch(self) -> np.ndarray:
        if self._lazy is not None:
            self._ready = self._lazy()
            self._lazy = None
        if self._ready is not None:
            return np.asarray(self._ready, np.float64)
        if self._group is not None:
            gf, s, e = self._group
            losses = gf.get()[s:e]
        else:
            losses = _fetch_outs(self._outs)
        if self._post is not None:
            losses = self._post(losses)
        return losses.astype(np.float64)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; on a card through pinned memory, so the
    copy queues behind the device's work without a host sync."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _interp_losses(T: int, pos: np.ndarray, losses: np.ndarray) -> np.ndarray:
    """The score stride's losses at ``pos`` interpolated to all T frames."""
    return np.interp(np.arange(T), pos, losses)


def _bisect(pos: np.ndarray, flagged) -> np.ndarray:
    """Midpoints of both intervals around each flagged interior position
    (flag i names pos[i + 1]), where an interval spans >= 2 frames, less
    the positions already there; sorted."""
    mids = set()
    for i in flagged:
        for a, b in ((i, i + 1), (i + 1, i + 2)):
            if pos[b] - pos[a] >= 2:
                mids.add((int(pos[a]) + int(pos[b])) // 2)
    mids -= set(int(p) for p in pos)
    return np.asarray(sorted(mids), dtype=pos.dtype)


def _loo_weights(tpos: np.ndarray) -> np.ndarray:
    """Each interior knot's linear weight between its two neighbours."""
    return ((tpos[1:-1] - tpos[:-2]).astype(np.float32)
            / np.maximum(tpos[2:] - tpos[:-2], 1))


def _loo_errs(feats: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """(n-2,) leave-one-out error of each interior knot of the (n, D) rows
    against the linear interpolation of its neighbours, relative L2, f32 on
    the rows' device (JAX ``_loo_errs_fn``)."""
    f = feats.float()
    w = _to_device(w.astype(np.float32), f.device)
    t_hat = f[:-2] * (1.0 - w)[:, None] + f[2:] * w[:, None]
    num = torch.linalg.vector_norm(f[1:-1] - t_hat, dim=-1)
    den = torch.linalg.vector_norm(f[1:-1], dim=-1) + 1e-6
    return num / den


def _motion_energy(frames: np.ndarray, wire_format: str) -> np.ndarray:
    """(T,) per-frame luma motion: mean |Y_t - Y_{t-1}| over a 2x-strided
    pixel grid (motion[0] = 0), on the host frames: packed I420 / yuv420q
    frames read their Y plane, RGB (uint8 or normalized) frames their green
    channel."""
    T = frames.shape[0]
    if frames.ndim == 3:  # packed planar (T, rows, W)
        rows = frames.shape[1]
        H = (yuv.frame_height_q(rows, frames.shape[2])
             if wire_format == "yuv420q" else yuv.frame_height(rows))
        y = frames[:, :H:2, ::2].astype(np.float32)
    else:
        y = frames[:, ::2, ::2, 1].astype(np.float32)
    motion = np.zeros(T, np.float64)
    if T > 1:
        motion[1:] = np.abs(np.diff(y, axis=0)).mean(axis=(1, 2))
    return motion


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of JAX's ``jax.image.resize(...,
    "bilinear")`` along one axis (``compute_weight_mat``): the triangle
    kernel at each output pixel's centre, widened by in/out on a downscale
    (antialiasing), each column normalized to sum 1."""
    inv = np.float32(in_size / out_size)
    kscale = np.float32(max(in_size / out_size, 1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _interp_rows(xp: np.ndarray, rows, x: np.ndarray, kind: str = "linear"):
    """Row-wise interpolation of the teacher rows (JAX ``_interp_rows``):
    ``linear`` or ``catmullrom``; ``rows`` a device tensor or a host numpy
    array."""
    if kind == "linear":
        return _lerp_rows(xp, rows, x)
    if kind == "catmullrom":
        return _catmull_rom_rows(xp, rows, x)
    raise ValueError(f"unknown teacher_interp {kind!r}")


def _catmull_rom_rows(xp: np.ndarray, rows, x: np.ndarray):
    """Row-wise cubic Catmull-Rom on (possibly uneven) knots: rows
    (len(xp), D) at xp, evaluated at x within [xp[0], xp[-1]] -> (len(x),
    D). Tangents m_j = (y[j+1] - y[j-1]) / (x[j+1] - x[j-1]), one-sided at
    the ends (the end knots clamped), so the curve passes through every knot
    and is C1. The knot search and the four weights of each point are
    float64 on the host, cast to f32 and then to the rows' dtype; the mix is
    four gathered rows (JAX ``_catmull_rom_rows``). Fewer than 3 knots:
    linear."""
    xp = np.asarray(xp, np.float64)
    n = len(xp)
    if n < 3:
        return _lerp_rows(xp, rows, x)
    j = np.searchsorted(xp, x, side="right") - 1
    j = np.clip(j, 0, n - 2)
    h = xp[j + 1] - xp[j]
    t = np.clip((np.asarray(x, np.float64) - xp[j]) / np.maximum(h, 1e-12), 0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    jm1 = np.maximum(j - 1, 0)  # m_j over rows[j-1], rows[j+1]
    span_l = xp[j + 1] - xp[jm1]
    jp2 = np.minimum(j + 2, n - 1)  # m_{j+1} over rows[j], rows[j+2]
    span_r = xp[jp2] - xp[j]
    cl = h10 * h / np.maximum(span_l, 1e-12)
    cr = h11 * h / np.maximum(span_r, 1e-12)
    w = np.stack([-cl, h00 - cr, h01 + cl, cr], axis=1).astype(np.float32)  # (len(x), 4)
    idx = np.stack([jm1, j, j + 1, jp2], axis=1)  # (len(x), 4)
    if isinstance(rows, torch.Tensor):
        wj = _to_device(w, rows.device).to(rows.dtype)
        g = rows[_to_device(idx, rows.device)]  # (len(x), 4, D)
        return torch.einsum("pk,pkd->pd", wj, g)
    return np.einsum("pk,pkd->pd", w.astype(rows.dtype), np.asarray(rows)[idx])


def _lerp_rows(xp: np.ndarray, rows, x: np.ndarray):
    """Row-wise linear interpolation: rows (len(xp), D) at xp, evaluated at
    x within [xp[0], xp[-1]] -> (len(x), D). The gather indices and the f32
    weights come from the host, cast to the rows' dtype (JAX
    ``_lerp_rows``)."""
    xp = np.asarray(xp)
    on_device = isinstance(rows, torch.Tensor)
    if len(xp) == 1:
        return rows.repeat(len(x), 1) if on_device else np.repeat(rows, len(x), axis=0)
    j = np.searchsorted(xp, x, side="right") - 1
    j = np.clip(j, 0, len(xp) - 2)
    w = ((x - xp[j]) / np.maximum(xp[j + 1] - xp[j], 1)).astype(np.float32)[:, None]
    if on_device:
        w = _to_device(w, rows.device).to(rows.dtype)
        j = _to_device(j, rows.device)
    else:
        w = w.astype(rows.dtype)
    return rows[j] * (1.0 - w) + rows[j + 1] * w


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
