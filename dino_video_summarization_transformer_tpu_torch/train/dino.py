"""The per-frame scoring loss (counterpart of the JAX package's
``train/dino.py:scoring_dino_loss``). The training losses wait for the
training slice (ROADMAP)."""

from __future__ import annotations

from typing import Optional

import torch


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
