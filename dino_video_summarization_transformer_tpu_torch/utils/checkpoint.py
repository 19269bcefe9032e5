"""Checkpoint save / restore of the whole ``TrainState`` plus run variables
(counterpart of the JAX package's ``utils/checkpoint.py``; ref:
utils/utils.py:122-154, train_ssl.py:441-455), with ``torch.save``.

The contract is the JAX package's: ``save_checkpoint(path, state,
run_vars)`` writes ``path`` (``output_dir/checkpoint`` for the resume
point, ``checkpoint%04d`` for epoch snapshots); ``restore_checkpoint(path,
template)`` returns ``(state, run_vars)``, or ``(None, {})`` when ``path``
does not exist (the reference's silent return). There is no Orbax
compatibility: the JAX package's checkpoints are Orbax directories, and
neither package reads the other's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(path: str, state, run_vars: Optional[dict] = None) -> None:
    """Write ``state`` (a ``train.ssl.TrainState``) and ``run_vars`` to
    ``path``, through a temporary file and a rename, so a crash never leaves
    half a checkpoint."""
    payload = {
        "student": state.student.state_dict(),
        "teacher": state.teacher.state_dict(),
        "center": state.center,
        "opt_state": state.opt_state,
        "step": int(state.step),
        "run_vars": dict(run_vars or {}),
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template):
    """Load ``path`` into ``template`` (a ``TrainState`` of the same model,
    on the device to restore to) and return ``(template, run_vars)``;
    ``(None, {})`` when ``path`` does not exist."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None, {}
    dev = template.center.device
    ck = torch.load(path, map_location=dev, weights_only=False)
    template.student.load_state_dict(ck["student"])
    template.teacher.load_state_dict(ck["teacher"])
    template.center = ck["center"].to(dev)
    template.opt_state = ck["opt_state"]
    template.step = int(ck["step"])
    return template, dict(ck["run_vars"])
