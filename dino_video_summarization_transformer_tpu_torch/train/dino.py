"""DINO losses and the teacher EMA (counterpart of the JAX package's
``train/dino.py``), for one device: the per-frame scoring loss and the
training loss with centering, temperature warmup and same-view skipping.
Under data parallelism the center's batch mean is the global batch's
(``batch_mean``: the mean over the data group of the replicas' equal-sized
batch means, the reference's all_reduce at train_ssl.py:681-687)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn


def scoring_dino_loss(
    student_output: torch.Tensor,
    teacher_output: torch.Tensor,
    center: Optional[torch.Tensor] = None,
    teacher_temp: float = 0.02,
    student_temp: float = 0.3,
) -> torch.Tensor:
    """Per-frame cross-entropy H(p_teacher, p_student) in float32
    (ref: dino_similarity.py:120-135). Reduces over the last axis only, so
    a batch of frames maps to a batch of losses."""
    s = student_output.float()
    t = teacher_output.float()
    if center is not None:
        t = t - center
    p_teacher = torch.softmax(t / teacher_temp, dim=-1)
    logp_student = torch.log_softmax(s / student_temp, dim=-1)
    return -torch.sum(p_teacher * logp_student, dim=-1)


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float,
                          warmup_teacher_temp_epochs: int,
                          nepochs: int) -> np.ndarray:
    """Teacher temperature warmup, per epoch (ref: train_ssl.py:620-625)."""
    return np.concatenate((
        np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
        np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp))


def update_center(teacher_output: torch.Tensor, center: torch.Tensor,
                  center_momentum: float = 0.9,
                  batch_mean: Optional[Callable] = None) -> torch.Tensor:
    """EMA of the teacher outputs' batch mean (ref: train_ssl.py:673-691);
    ``batch_mean`` maps the local mean to the global batch's (data
    parallelism)."""
    batch_center = teacher_output.sum(dim=0, keepdim=True) / teacher_output.shape[0]
    if batch_mean is not None:
        batch_center = batch_mean(batch_center)
    return center * center_momentum + batch_center * (1.0 - center_momentum)


def dino_loss(student_output: torch.Tensor, teacher_output: torch.Tensor,
              center: torch.Tensor, temp: float, n_crops: int,
              global_crops: int = 2, student_temp: float = 0.1,
              center_momentum: float = 0.9,
              batch_mean: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full DINO training loss (ref: train_ssl.py:626-671).

    student_output (n_crops * B, out_dim), crops concatenated;
    teacher_output (global_crops * B, out_dim). Returns (scalar loss,
    updated center); no gradient flows through the teacher."""
    s = student_output.float() / student_temp
    t = torch.softmax((teacher_output.float() - center) / temp, dim=-1).detach()
    student_chunks = s.tensor_split(n_crops, dim=0)
    teacher_chunks = t.tensor_split(global_crops, dim=0)
    total = 0.0
    n_terms = 0
    for iq, q in enumerate(teacher_chunks):
        for v in range(n_crops):
            if v == iq:
                continue  # skip same-view pairs (ref: train_ssl.py:663-665)
            logp = torch.log_softmax(student_chunks[v], dim=-1)
            total = total + torch.sum(-q * logp, dim=-1).mean()
            n_terms += 1
    new_center = update_center(teacher_output.float().detach(), center,
                               center_momentum, batch_mean)
    return total / n_terms, new_center


def dino_loss_two_token(student_pair, teacher_pair, center: torch.Tensor,
                        temp: float, student_temp: float = 0.1,
                        center_momentum: float = 0.9,
                        batch_mean: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-token DINO loss (ref: train_ssl.py:632-651): ``student_pair`` the
    (main, aux) head outputs of the 4 student views, ``teacher_pair`` those
    of the 2 teacher views, each (views * B, out_dim) view-major. Views 0-1
    learn from the main teacher's first chunk, views 2-3 from the aux
    teacher's second chunk. ``center`` (2, out_dim): the main and aux rows.
    Returns (scalar loss, updated center)."""
    s_main = student_pair[0].float() / student_temp
    s_aux = student_pair[1].float() / student_temp
    t_main = torch.softmax((teacher_pair[0].float() - center[0]) / temp, dim=-1).detach()
    t_aux = torch.softmax((teacher_pair[1].float() - center[1]) / temp, dim=-1).detach()
    s_main_chunks = s_main.tensor_split(4, dim=0)
    s_aux_chunks = s_aux.tensor_split(4, dim=0)
    q_main = t_main.tensor_split(2, dim=0)[0]
    q_aux = t_aux.tensor_split(2, dim=0)[1]
    total = 0.0
    for iv in range(4):
        q, v = (q_main, s_main_chunks[iv]) if iv < 2 else (q_aux, s_aux_chunks[iv])
        total = total + torch.sum(-q * torch.log_softmax(v, dim=-1), dim=-1).mean()
    new_center = torch.cat([
        update_center(teacher_pair[i].float().detach(), center[i:i + 1],
                      center_momentum, batch_mean) for i in range(2)])
    return total / 4.0, new_center


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, momentum: float) -> None:
    """Teacher EMA t = t * m + s * (1 - m), in place, parameter by parameter
    (ref: train_ssl.py:554-563)."""
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(t * momentum + s.to(t.dtype) * (1.0 - momentum))
