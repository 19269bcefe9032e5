"""Meters and logging (ref: utils/meters.py:18-192, utils/utils.py:194-370),
copied from the JAX package's ``engine/meters.py``.

``TestMeter`` accumulates multi-view clip predictions into per-video scores
(sum or max ensemble) and finalizes top-k accuracy. ``SmoothedValue`` /
``MetricLogger`` mirror the reference's windowed stats + ETA logging. The
port runs one process: the cross-process sum does nothing there, as JAX's
does at ``process_count() == 1``; with more processes it raises (ROADMAP
queue 1 item 8, parallelism).
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np

from .metrics import topk_accuracies


class TestMeter:
    """Multi-view ensemble accumulator (ref: utils/meters.py:18-192)."""

    __test__ = False  # not a pytest class

    def __init__(self, num_videos: int, num_clips: int, num_cls: int,
                 overall_iters: int = 0, multi_label: bool = False,
                 ensemble_method: str = "sum"):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float32)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = np.zeros(
            (num_videos, num_cls) if multi_label else (num_videos,),
            np.float32 if multi_label else np.int64)
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats = {}

    def reset(self):
        self.clip_count[:] = 0
        self.video_preds[:] = -1e10 if self.multi_label else 0
        self.video_labels[:] = 0

    def update_stats(self, preds: np.ndarray, labels: np.ndarray,
                     clip_ids: np.ndarray):
        """(ref: utils/meters.py:84-133): clip_id // num_clips is the video id;
        verifies label consistency across a video's clips."""
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.video_labels[vid_id].sum() > 0:
                assert np.array_equal(
                    self.video_labels[vid_id], labels[ind]
                ) if self.multi_label else self.video_labels[vid_id] == labels[ind]
            self.video_labels[vid_id] = labels[ind]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[ind]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[ind])
            self.clip_count[vid_id] += 1

    def finalize_metrics(self, ks=(1, 5)) -> dict:
        """(ref: utils/meters.py:153-192)."""
        if not np.all(self.clip_count == self.num_clips):
            bad = np.argwhere(self.clip_count != self.num_clips).flatten()
            print(f"clip count incomplete for videos {bad.tolist()}")
        accs = topk_accuracies(self.video_preds, self.video_labels, ks)
        self.stats = {"split": "test_final"}
        for k, acc in zip(ks, accs):
            self.stats[f"top{k}_acc"] = f"{acc:.2f}"
        print(self.stats, flush=True)
        return self.stats


class SmoothedValue:
    """Windowed value tracker (ref: utils/utils.py:194-253)."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.6f} ({global_avg:.6f})"

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Cross-process (count, total) sum (ref: utils/utils.py:211-224):
        nothing to do in one process; several raise (ROADMAP queue 1 item
        8)."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        raise NotImplementedError(
            "SmoothedValue.synchronize_between_processes across processes: "
            "multi-process runs are not ported (ROADMAP queue 1 item 8, parallelism)")

    @property
    def median(self):
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class MetricLogger:
    """Iteration logger with ETA (ref: utils/utils.py:283-370)."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = SmoothedValue(fmt="{avg:.6f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or (total and i == total - 1)):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_str = "?"
                print(self.delimiter.join([
                    header, f"[{i}{'/' + str(total) if total else ''}]",
                    f"eta: {eta_str}", str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                ]), flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(total_time)))} "
              f"({total_time / max(i, 1):.6f} s / it)", flush=True)
