"""DINO self-supervised training: state and the plain train step
(counterpart of the JAX package's ``train/ssl.py``; ref:
train_ssl.py:154-599), for one device.

One step (``make_train_step``) runs both student forwards (the 2 global
and the n local crops), the teacher forward on the global crops without
gradients, the DINO head on each, ``dino_loss`` with centering, the
backward, ``apply_updates_with_schedules`` (clip, weight decay, last-layer
freeze, the optimizer, -lr) and the teacher EMA. The backbone runs
``TimeSformer.forward_train`` on the route ``train_route`` picks once for
the model (``route="auto"``: bf16 on ViT-B runs the per-phase Hopper
kernels forward and backward, f32 the plain route). ``route="kernels"``
with ``compute_dtype=torch.float32`` is the mixed tier, JAX's
``make_train_step`` on a ``use_fused=True`` config at f32: both student
forwards, the teacher forward and the student backward run the kernels'
f32 tiers (f32 activations and carries, bf16 matmul operands). Like the
JAX step, it never runs drop-path (the forward is called with
``train=False``, ``train/ssl.py:139-142`` of the JAX package).

The two-token, rand-fr, two-stream, CNN-distill, remat and parallel
variants are not ported (ROADMAP) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models import timesformer as tsf
from ..models.heads import DINOHead
from .dino import dino_loss, ema_update
from .optim import Optimizer, apply_updates_with_schedules, wd_mask


@dataclasses.dataclass
class TrainState:
    """student and teacher: ``nn.ModuleDict({"backbone", "head"})`` with f32
    parameters; center (1, out_dim); opt_state: the optimizer's tensors by
    parameter name; step: steps taken."""
    student: nn.ModuleDict
    teacher: nn.ModuleDict
    center: torch.Tensor
    opt_state: dict
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.student.named_parameters())


def init_train_state(model_cfg: tsf.TimeSformerConfig, out_dim: int = 65536,
                     optimizer: str = "adamw", momentum: float = 0.9,
                     seed: int = 0, pretrained_backbone: Optional[Mapping] = None,
                     head_state_dict: Optional[Mapping] = None, device=None,
                     two_token: bool = False, cnn_distill_dim: int = 0):
    """Student (backbone + DINO head), a teacher copy, a zero center and the
    optimizer state (ref: train_ssl.py:330-333). Returns (state, core,
    mask), as the JAX function does. Weights come from a reference-layout
    state dict where given (``pretrained_backbone``, ``head_state_dict``),
    else from a ``torch.Generator`` seeded with ``seed``. ``device``
    defaults to the CUDA card."""
    if two_token or cnn_distill_dim:
        raise NotImplementedError("the two-token and CNN-distill trainer "
                                  "variants are not ported (ROADMAP)")
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if pretrained_backbone is not None:
        with torch.device("cpu"):
            backbone = tsf.TimeSformer(model_cfg)
        backbone.load_reference_state_dict(pretrained_backbone)
    else:
        backbone = tsf.init_timesformer(model_cfg, gen, device="cpu")
    head = DINOHead(model_cfg.embed_dim, out_dim,
                    generator=None if head_state_dict is not None else gen)
    if head_state_dict is not None:
        tsf.load_reference_state_dict(head, head_state_dict)
    student = nn.ModuleDict({"backbone": backbone, "head": head}).to(dev)
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    core = Optimizer(optimizer, momentum)
    mask = wd_mask(student)
    state = TrainState(student=student, teacher=teacher,
                       center=torch.zeros((1, out_dim), device=dev),
                       opt_state=core.init(dict(student.named_parameters())))
    return state, core, mask


class TrainStep:
    """``step(state, g_crops, l_crops, lr, wd, teacher_momentum,
    teacher_temp, freeze_last) -> (state, {"loss": tensor})``, the state
    updated in place. g_crops (2B, C, T, S, S), l_crops (n_local * B, C,
    T, s, s). ``loss_and_grads`` is its first half (loss, new center, f32
    gradients by parameter name), for tests and measurement."""

    def __init__(self, model_cfg, core, mask, n_local_crops, clip_grad,
                 student_temp, center_momentum, compute_dtype, route):
        self.cfg = model_cfg
        self.core = core
        self.mask = mask
        self.n_crops = 2 + n_local_crops
        self.clip_grad = clip_grad
        self.student_temp = student_temp
        self.center_momentum = center_momentum
        self.compute_dtype = compute_dtype
        self.route = tsf.train_route(model_cfg, compute_dtype, route)

    def _features(self, model: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        return model["backbone"].forward_train(x, self.compute_dtype, self.route)

    def loss_and_grads(self, state: TrainState, g_crops: torch.Tensor,
                       l_crops: torch.Tensor, teacher_temp: float):
        params = state.params()
        s_g = self._features(state.student, g_crops)
        s_l = self._features(state.student, l_crops)
        s_out = state.student["head"](torch.cat([s_g, s_l], dim=0))
        with torch.no_grad():
            t_out = state.teacher["head"](self._features(state.teacher, g_crops))
        loss, new_center = dino_loss(
            s_out.float(), t_out.float(), state.center, teacher_temp,
            n_crops=self.n_crops, student_temp=self.student_temp,
            center_momentum=self.center_momentum)
        names = list(params)
        gs = torch.autograd.grad(loss, [params[n] for n in names],
                                 allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g.float()
                 for n, g in zip(names, gs)}
        return loss.detach(), new_center, grads

    def __call__(self, state: TrainState, g_crops, l_crops, lr: float,
                 wd: float, teacher_momentum: float, teacher_temp: float,
                 freeze_last: bool):
        loss, new_center, grads = self.loss_and_grads(state, g_crops, l_crops,
                                                      teacher_temp)
        state.opt_state = apply_updates_with_schedules(
            state.params(), grads, state.opt_state, self.core, self.mask,
            float(lr), float(wd), clip=self.clip_grad,
            freeze_last_layer=bool(freeze_last))
        ema_update(state.teacher, state.student, float(teacher_momentum))
        state.center = new_center
        state.step += 1
        return state, {"loss": loss}


def make_train_step(model_cfg: tsf.TimeSformerConfig, core: Optimizer, mask,
                    n_local_crops: int = 8, clip_grad: Optional[float] = 3.0,
                    student_temp: float = 0.1, center_momentum: float = 0.9,
                    compute_dtype: torch.dtype = torch.float32,
                    route: str = "auto", remat: bool = False,
                    two_token: bool = False, cnn_params=None,
                    cnn_distill_weight: float = 0.0,
                    backbone_forward=None) -> TrainStep:
    """The plain DINO step (the JAX ``make_train_step`` default variant).
    ``route``: ``"auto"`` (``train_route``, once for the model),
    ``"plain"`` or ``"kernels"`` (bf16, or f32: the mixed tier; raises where
    the kernels' gate refuses the model)."""
    if remat or two_token or backbone_forward is not None or (
            cnn_params is not None and cnn_distill_weight > 0):
        raise NotImplementedError("the remat, two-token, CNN-distill and "
                                  "parallel trainer variants are not ported "
                                  "(ROADMAP)")
    if route not in ("auto", "plain", "kernels"):
        raise ValueError(f"route {route!r}")
    return TrainStep(model_cfg, core, mask, n_local_crops, clip_grad,
                     student_temp, center_momentum, compute_dtype, route)


def make_rand_fr_train_step(*args, **kw):
    raise NotImplementedError("the DATA.RAND_FR trainer variant is not "
                              "ported (ROADMAP)")


def make_two_stream_train_step(*args, **kw):
    raise NotImplementedError("the MODEL.TWO_STREAM trainer variant is not "
                              "ported (ROADMAP)")


def build_schedules(args_like, niter_per_ep: int, world: int = 1):
    """The lr, wd and teacher-momentum cosine schedules (ref:
    train_ssl.py:395-408); lr scaled by the global batch / 256."""
    from .schedules import cosine_scheduler

    lr = cosine_scheduler(
        args_like.lr * (args_like.batch_size_per_gpu * world) / 256.0,
        args_like.min_lr, args_like.epochs, niter_per_ep,
        warmup_epochs=args_like.warmup_epochs)
    wd = cosine_scheduler(args_like.weight_decay, args_like.weight_decay_end,
                          args_like.epochs, niter_per_ep)
    mom = cosine_scheduler(args_like.momentum_teacher, 1.0, args_like.epochs,
                           niter_per_ep)
    return lr, wd, mom
