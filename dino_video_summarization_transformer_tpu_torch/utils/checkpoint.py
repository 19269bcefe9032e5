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

import dataclasses
import os
from typing import Optional

import torch
from torch import nn


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def save_checkpoint(path: str, state, run_vars: Optional[dict] = None) -> None:
    """Write ``state`` (a ``train.ssl.TrainState`` or ``TwoStreamState``:
    each module's state dict, each center, the optimizer state and the step)
    and ``run_vars`` to ``path``, through a temporary file and a rename, so
    a crash never leaves half a checkpoint."""
    payload = {k: v.state_dict() if isinstance(v, nn.Module) else v
               for k, v in _fields(state).items()}
    payload["run_vars"] = dict(run_vars or {})
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template):
    """Load ``path`` into ``template`` (a state of the same kind and model,
    on the device to restore to) and return ``(template, run_vars)``;
    ``(None, {})`` when ``path`` does not exist."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None, {}
    fields = _fields(template)
    dev = next(v for v in fields.values() if isinstance(v, torch.Tensor)).device
    ck = torch.load(path, map_location=dev, weights_only=False)
    for k, v in fields.items():
        if isinstance(v, nn.Module):
            v.load_state_dict(ck[k])
        elif isinstance(v, torch.Tensor):
            setattr(template, k, ck[k].to(dev))
        else:
            setattr(template, k, ck[k])
    return template, dict(ck["run_vars"])
