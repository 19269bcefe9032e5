"""TimeSformer video classification: preprocessing, evaluation, finetuning
(ref: timesformer_evaluation.py:13-109, timesformer_finetuning.py:13-104;
the JAX package's ``engine/classification.py``).

The reference drives a HuggingFace TimesformerForVideoClassification; here
the port's TimeSformer classifies, from a HuggingFace-layout checkpoint
through ``models/convert.convert_hf_timesformer``. ``hf_video_preprocess``
resizes with PIL's antialiased bilinear filter written in numpy
(``pil_bilinear_resize``), as the card's machine has no PIL.

The JAX package's ``make_classifier_fn`` and ``finetune`` cast the pixels to
``compute_dtype`` and then call ``forward`` without it, so the model
computes in its default f32 on bf16-rounded pixels (JAX
``engine/classification.py:59-68,171-175``). The port follows that: the
model stays f32 and the pixels go through ``compute_dtype`` and back. Under
``--precision bfloat16`` on the card the classifier's model has
``use_kernels`` (``timesformer.eval_kernels``), so its blocks run the
whole-block pair's f32 tier, as JAX's mixed tier does on a TPU; finetuning
runs the plain f32 route, as in JAX.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients for 8-bit images


@functools.lru_cache(maxsize=None)
def _bilinear_taps(in_size: int, out_size: int):
    """PIL's resample coefficients for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` of its ``Resample.c``, the triangle filter):
    the support widens with the downscale factor, each output's weights
    are normalized to sum 1 in double, then rounded half away from zero to
    22-bit fixed point. Returns (first tap (out,), taps (out, k) int64),
    read-only: they are cached, as every frame of a video shares its sizes."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(w)  # summed in order, as the C loop does
        if ww != 0.0:
            w = [v / ww for v in w]
        first[xx] = xmin
        for x, v in enumerate(w):
            taps[xx, x] = int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0 else \
                int(0.5 + v * (1 << PRECISION_BITS))
    first.setflags(write=False)
    taps.setflags(write=False)
    return first, taps


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of an (H, W, C)
    uint8 image: integer sums from 2^21, then >> 22 clipped to [0, 255]."""
    in_size = img.shape[axis]
    first, taps = _bilinear_taps(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(taps.shape[1]):
        pos = np.minimum(first + j, in_size - 1)  # taps past the end are 0
        acc += src[pos] * taps[:, j].reshape(-1, *([1] * (src.ndim - 1)))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize(img: np.ndarray, size) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize(size, Image.BILINEAR)`` for an
    (H, W, C) uint8 image, ``size`` = (width, height): PIL's two-pass
    resample (horizontal first, each pass rounded to uint8), each pass run
    only where its axis changes."""
    nw, nh = size
    out = img
    if nw != img.shape[1]:
        out = _resample_axis(out, nw, axis=1)
    if nh != img.shape[0]:
        out = _resample_axis(out, nh, axis=0)
    return out


def hf_video_preprocess(
    frames: np.ndarray,
    size: int = 224,
    mean=(0.45, 0.45, 0.45),
    std=(0.225, 0.225, 0.225),
) -> np.ndarray:
    """HF VideoMAE/Timesformer processor semantics
    (ref: timesformer_evaluation.py:60, 89: AutoImageProcessor(video)):
    PIL-bilinear resize of the shortest edge to ``size``, center crop,
    rescale 1/255, normalize. frames (T, H, W, C) uint8 ->
    (T, C, size, size) float32."""
    out = np.empty((frames.shape[0], size, size, 3), np.float32)
    for i, fr in enumerate(frames):
        h, w = fr.shape[:2]
        # HF get_resize_output_image_size truncates the long edge
        if w < h:
            nw, nh = size, int(h * size / w)
        else:
            nw, nh = int(w * size / h), size
        img = pil_bilinear_resize(fr, (nw, nh))
        left = (nw - size) // 2
        top = (nh - size) // 2
        out[i] = img[top:top + size, left:left + size].astype(np.float32) / 255.0
    out = (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.moveaxis(out, -1, 1)  # (T, C, H, W)


def make_classifier_fn(model: torch.nn.Module, compute_dtype=torch.float32):
    """Logits of (B, T, C, H, W) HF-style pixel values (numpy or a tensor)
    on the model's device. As JAX's: the pixels are cast to
    ``compute_dtype`` and the model computes in its own dtype (f32), so
    ``compute_dtype=bfloat16`` classifies bf16-rounded pixels in f32."""
    dev = next(model.parameters()).device

    def fn(pixel_values):
        x = torch.as_tensor(pixel_values, device=dev).permute(0, 2, 1, 3, 4)
        with torch.no_grad():
            return model(x.to(compute_dtype), use_head=True)

    return fn


def evaluate_selection(
    dataset,
    model: torch.nn.Module,
    num_frames: int = 16,
    log_path: Optional[str] = None,
    log_every: int = 250,
    compute_dtype=torch.float32,
    limit: Optional[int] = None,
) -> float:
    """Selection-quality evaluation (ref: timesformer_evaluation.py:33-109):
    for each video, decode ONLY the selected frame indices, preprocess,
    classify, accumulate top-1 accuracy; a running line every
    ``log_every`` videos into ``log_path``."""
    from ..data import video as vio

    logger = logging.getLogger("selection_eval")
    handler = None
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        handler = logging.FileHandler(log_path)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        clf = make_classifier_fn(model, compute_dtype)
        correct = total = 0
        n = len(dataset) if limit is None else min(limit, len(dataset))
        for i in range(n):
            indices, label, _file_name = dataset[i]
            try:
                frames = vio.read_video_indices(dataset._path_to_videos[i], indices)
            except vio.DecodeError:
                total += 1
                continue
            clips = hf_video_preprocess(frames)
            # zero-pad short videos to num_frames (ref: timesformer_evaluation.py:83-86)
            if clips.shape[0] < num_frames:
                pad = num_frames - clips.shape[0]
                clips = np.concatenate(
                    [clips, np.zeros((pad,) + clips.shape[1:], np.float32)])
            logits = clf(clips[None])
            pred = int(logits[0].argmax())
            correct += int(pred == int(label))
            total += 1
            if log_every and total % log_every == 0:
                logger.info(
                    f"processed {total}/{n}, running top-1: "
                    f"{100.0 * correct / total:.2f}% ({correct}/{total})")
        acc = 100.0 * correct / max(total, 1)
        msg = f"final top-1 accuracy: {acc:.2f}% ({correct}/{total})"
        print(msg, flush=True)
        if log_path:
            logger.info(msg)
    finally:
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()
    return acc


def warmup_linear_schedule(lr: float, warmup_steps: int, total_steps: int):
    """optax's ``join_schedules([linear_schedule(0, lr, warmup),
    linear_schedule(lr, 0, max(total - warmup, 1))], [warmup])`` in f32:
    count -> learning rate."""
    f32 = np.float32
    decay = max(total_steps - warmup_steps, 1)

    def linear(init, end, steps, count):
        if steps <= 0:  # optax: a constant schedule at init
            return f32(init)
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return (f32(init) - f32(end)) * frac + f32(end)

    def sched(count: int) -> float:
        if count < warmup_steps:
            return float(linear(0.0, lr, warmup_steps, count))
        return float(linear(lr, 0.0, decay, count - warmup_steps))

    return sched


class AdamW:
    """optax's ``adamw(schedule, weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8)
    on a module's parameters: the moments, their bias corrections at the
    incremented count, the update mu_hat / (sqrt(nu_hat) + eps), weight
    decay added to it on every parameter, then scaled by -schedule(count)
    at the count before the increment (so a warmup's first step moves
    nothing)."""

    def __init__(self, params, schedule, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.schedule, self.wd = schedule, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        f32 = np.float32
        count_inc = self.count + 1
        c1 = float(f32(1) - f32(self.b1) ** f32(count_inc))
        c2 = float(f32(1) - f32(self.b2) ** f32(count_inc))
        step_size = self.schedule(self.count)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            u = u + self.wd * p
            p.add_(-step_size * u)
        self.count = count_inc


def finetune(
    train_dataset,
    val_dataset,
    model: torch.nn.Module,
    output_dir: str,
    num_epochs: int = 5,
    batch_size: int = 4,
    lr: float = 5e-5,
    warmup_steps: int = 500,
    weight_decay: float = 0.01,
    num_workers: int = 4,
    compute_dtype=torch.float32,
    max_steps_per_epoch: int = 0,
    log_every: int = 500,
):
    """Supervised finetune of the classification model (an f32 model with
    its head) on selected frames (ref: timesformer_finetuning.py:61-104),
    on the plain f32 route with bf16-rounded pixels under
    ``compute_dtype=bfloat16``, as JAX. Mirrors HF Trainer defaults:
    AdamW, linear warmup -> linear decay, per-epoch eval, and
    ``training_log_history.json`` with HF Trainer's three key sets
    (loss/learning_rate/epoch/step; eval_loss/eval_runtime/
    eval_samples_per_second/eval_steps_per_second/epoch/step; the
    train_* summary with total_flos). Returns (model, log_history)."""
    from ..data.loader import PrefetchLoader
    from ..utils.flops import timesformer_forward_flops

    os.makedirs(output_dir, exist_ok=True)
    cfg = model.cfg
    dev = next(model.parameters()).device
    steps_per_epoch = max(len(train_dataset) // batch_size, 1)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    total_steps = steps_per_epoch * num_epochs
    sched = warmup_linear_schedule(lr, warmup_steps, total_steps)
    params = dict(model.named_parameters())
    opt = AdamW(params.items(), sched, weight_decay)

    def loss_fn(x, y):
        x = torch.as_tensor(x, device=dev).permute(0, 2, 1, 3, 4).to(compute_dtype)
        feats = model.forward_train(x, compute_dtype=torch.float32, route="plain")
        logits = F.linear(feats, model.head.weight, model.head.bias)
        return F.cross_entropy(logits.float(), torch.as_tensor(y, device=dev))

    def collate(items):
        return (np.stack([it["pixel_values"] for it in items]),
                np.asarray([it["label"] for it in items]))

    log_history = []
    step = 0
    t_train = time.time()
    loss_sum = 0.0
    for epoch in range(num_epochs):
        loader = PrefetchLoader(train_dataset, num_workers=num_workers,
                                batch_size=batch_size, collate=collate)
        for it, (x, y) in enumerate(loader):
            if it >= steps_per_epoch or x.shape[0] < batch_size:
                break
            loss = loss_fn(x, y)
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(dict(zip(params, grads)))
            step += 1
            loss = float(loss.detach())
            loss_sum += loss
            if log_every and step % log_every == 0:
                log_history.append({
                    "loss": loss, "learning_rate": sched(step),
                    "epoch": epoch + it / steps_per_epoch, "step": step})
        # per-epoch eval (evaluation_strategy="epoch")
        eval_losses = []
        t_eval = time.time()
        vloader = PrefetchLoader(val_dataset, num_workers=num_workers,
                                 batch_size=batch_size, collate=collate)
        with torch.no_grad():
            for x, y in vloader:
                if x.shape[0] < batch_size:
                    continue
                eval_losses.append(float(loss_fn(x, y)))
        eval_runtime = max(time.time() - t_eval, 1e-9)
        log_history.append({
            "eval_loss": float(np.mean(eval_losses)) if eval_losses else math.nan,
            "eval_runtime": eval_runtime,
            "eval_samples_per_second": len(eval_losses) * batch_size / eval_runtime,
            "eval_steps_per_second": len(eval_losses) / eval_runtime,
            "epoch": epoch + 1.0, "step": step})
        print(f"epoch {epoch + 1}: eval_loss={log_history[-1]['eval_loss']:.4f}",
              flush=True)

    # HF Trainer's end-of-train summary (the third key set of the
    # reference's committed log); total_flos counts fwd + bwd as 3x forward
    train_runtime = max(time.time() - t_train, 1e-9)
    log_history.append({
        "train_loss": loss_sum / max(step, 1),
        "train_runtime": train_runtime,
        "train_samples_per_second": step * batch_size / train_runtime,
        "train_steps_per_second": step / train_runtime,
        "total_flos": 3.0 * timesformer_forward_flops(cfg, cfg.num_frames) * batch_size * step,
        "epoch": float(num_epochs), "step": step})
    with open(os.path.join(output_dir, "training_log_history.json"), "w") as f:
        json.dump(log_history, f)
    return model, log_history
