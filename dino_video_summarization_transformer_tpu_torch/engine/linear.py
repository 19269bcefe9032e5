"""Frozen-backbone linear probe (ref: eval_linear.py:30-320; the JAX
package's ``engine/linear.py``).

The backbone runs under ``torch.no_grad`` and its features are detached
(JAX's ``stop_gradient``); the linear head trains by SGD with momentum as
optax's ``sgd`` computes it: weight decay added to the gradient, the trace
``g + momentum * trace``, the update ``-trace`` scaled by the epoch's
learning rate, which follows torch's ``CosineAnnealingLR`` over the epochs
(eta_min 0, ref: eval_linear.py:127-133, 182-261).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.heads import LinearClassifier


class LinearProbeState(NamedTuple):
    head: LinearClassifier
    opt_state: dict  # parameter name -> momentum trace


def make_linear_probe(
    backbone: torch.nn.Module,
    num_labels: int,
    lr: float,
    epochs: int,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Returns (state, train_step, eval_step, epoch_lr):
    ``train_step(state, x, y, lr_t) -> (state, loss)``,
    ``eval_step(state, x) -> logits``, ``epoch_lr(epoch) -> lr``.
    The head reads the (B, D) CLS features of
    ``backbone.forward_features``; it is N(0, 0.01) from ``generator``, on
    the backbone's device."""
    dev = next(backbone.parameters()).device
    head = LinearClassifier(backbone.cfg.embed_dim, num_labels, generator).to(dev)
    state = LinearProbeState(head=head, opt_state={
        name: torch.zeros_like(p) for name, p in head.named_parameters()})

    def features(x):
        with torch.no_grad():
            return backbone.forward_features(x).float()

    def train_step(state: LinearProbeState, x, y, lr_t):
        feats = features(x)
        names, params = zip(*state.head.named_parameters())
        loss = F.cross_entropy(state.head(feats), y)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for name, p, g in zip(names, params, grads):
                if weight_decay:
                    g = g + weight_decay * p
                trace = g + momentum * state.opt_state[name]
                state.opt_state[name] = trace
                p.add_(trace.neg().mul(float(lr_t)))
        return state, loss.detach()

    def eval_step(state: LinearProbeState, x):
        with torch.no_grad():
            return state.head(features(x))

    def epoch_lr(epoch: int) -> float:
        # torch CosineAnnealingLR(optimizer, epochs, eta_min=0)
        return lr * 0.5 * (1 + math.cos(math.pi * epoch / epochs))

    return state, train_step, eval_step, epoch_lr
