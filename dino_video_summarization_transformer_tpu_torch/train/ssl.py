"""DINO self-supervised training: state and the plain train step
(counterpart of the JAX package's ``train/ssl.py``; ref:
train_ssl.py:154-599), on one card or over a mesh of ranks.

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

The variants that need no other backbone:

* ``remat=True``: the student's two backbone passes rematerialized block
  by block (``timesformer.checkpoint_block``), the teacher's not, on every
  route; the same values;
* ``two_token=True`` (with ``init_train_state(two_token=True)``): the
  aux-token backbone, the dual head, a (2, out_dim) center and the 6-view
  protocol, on the plain route only (JAX runs no Pallas kernel there);
* ``make_rand_fr_train_step``: DATA.RAND_FR's variable-frame-count crops,
  one student forward per frame-count group and one teacher forward per
  global group, on ``make_train_step``'s routes (``"auto"`` on bf16 ViT-B
  runs the kernels at every group's T).

The variants on the other backbones:

* CNN distillation (``init_train_state(cnn_distill_dim=...)`` adds the
  student's ``cnn_proj``; ``make_train_step(cnn_params=S3D,
  cnn_distill_weight=w)``): w times the negative cosine between the
  projected student CLS features of the global crops and the frozen S3D's
  pooled, normalized features of the same crops, on every route of the
  step (bf16 ViT-B: the student on the kernels, the S3D in plain torch);
* two-stream (MODEL.TWO_STREAM; ``TwoStreamState``,
  ``init_two_stream_state``, ``make_two_stream_train_step``): the RGB
  student and teacher with the dual head (both streams reading the same CLS
  features, the intended wiring), 2D ViT motion nets over two flow frames,
  three DINO terms with three centers, one optimizer over ``rgb.`` and
  ``motion.`` parameters and an EMA for both teachers. The RGB backbones
  take the step's route (bf16 ViT-B: the per-phase kernels), the motion
  nets plain torch, as JAX runs them on XLA.

Parallel steps (the ``parallel`` modules; JAX's ``mesh=``,
``state_sharding=`` and ``backbone_forward=``):

* ``mesh`` (``parallel.build_mesh``): data parallelism over its data axis.
  Each rank runs the step on its own rows of the global batch; the
  gradients are averaged over the data group before the clip and the
  optimizer, the DINO center's batch mean is the global batch's and the
  returned losses are the global means (JAX takes both over the sharded
  batch). The teacher EMA stays rank-local: it runs on identical values.
  Every variant takes it, as every JAX variant takes its mesh;
* ``state_sharding`` (``parallel.shard_train_state``): "tp", tensor
  parallelism over the mesh's model axis, the state the rank's shards; the
  backbone runs ``backbone_forward`` (by default the plain TP route,
  ``parallel.tp.tp_forward_features``; the head-sharded kernels are
  ``parallel.tp_fused.tp_fused_forward_features``), the DINO head
  ``parallel.tp.head_forward`` (its logits gathered over the model group
  before the softmax and centering) and every leaf norm covers the whole
  tensor; "zero1", the moments sharded over the data axis;
* ``backbone_forward``: ``(backbone, x) -> (B, D) CLS features`` in place
  of ``forward_train`` for the student's and the teacher's passes of the
  plain variant (remat wraps the student's call whole).

A step with none of them is the single-card step, bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models import timesformer as tsf
from ..models.heads import DINOHead, MultiDINOHead
from .dino import dino_loss, dino_loss_two_token, ema_update
from .optim import Optimizer, apply_updates_with_schedules, wd_mask


@dataclasses.dataclass
class TrainState:
    """student and teacher: ``nn.ModuleDict({"backbone", "head"})`` with f32
    parameters; center (1, out_dim), or (2, out_dim) for the two-token
    variant; opt_state: the optimizer's tensors by parameter name; step:
    steps taken."""
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
    else from a ``torch.Generator`` seeded with ``seed``. ``two_token``: the
    aux-token backbone, the dual head (``MultiDINOHead``) and a (2,
    out_dim) center (ref: train_ssl.py:610-620). ``cnn_distill_dim`` > 0
    adds ``cnn_proj``, a linear layer embed_dim -> cnn_distill_dim (JAX's
    ``_linear_init``: truncated normal, zero bias), the CNN-distillation
    term's projection; the teacher copies it and the EMA moves it, as in
    JAX. ``device`` defaults to the CUDA card."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if pretrained_backbone is not None:
        with torch.device("cpu"):
            backbone = (tsf.AuxTokenTimeSformer if two_token else tsf.TimeSformer)(model_cfg)
        backbone.load_reference_state_dict(pretrained_backbone)
    elif two_token:
        backbone = tsf.init_aux_token_timesformer(model_cfg, gen, device="cpu")
    else:
        backbone = tsf.init_timesformer(model_cfg, gen, device="cpu")
    head = (MultiDINOHead if two_token else DINOHead)(
        model_cfg.embed_dim, out_dim,
        generator=None if head_state_dict is not None else gen)
    if head_state_dict is not None:
        tsf.load_reference_state_dict(head, head_state_dict)
    student = nn.ModuleDict({"backbone": backbone, "head": head})
    if cnn_distill_dim:
        proj = nn.Linear(model_cfg.embed_dim, cnn_distill_dim)
        with torch.no_grad():
            tsf._trunc_normal(proj.weight, gen)
            proj.bias.zero_()
        student["cnn_proj"] = proj
    student = student.to(dev)
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    core = Optimizer(optimizer, momentum)
    mask = wd_mask(student)
    state = TrainState(student=student, teacher=teacher,
                       center=torch.zeros((2 if two_token else 1, out_dim), device=dev),
                       opt_state=core.init(dict(student.named_parameters())))
    return state, core, mask


class TrainStep:
    """``step(state, g_crops, l_crops, lr, wd, teacher_momentum,
    teacher_temp, freeze_last) -> (state, {"loss": tensor})``, the state
    updated in place. g_crops (2B, C, T, S, S), l_crops (n_local * B, C,
    T, s, s). ``loss_and_grads(state, g_crops, l_crops, teacher_temp)`` is
    its first half (loss, the loss's aux: the new center, f32 gradients by
    parameter name), for tests and measurement. Subclasses change the crops
    the step takes and the loss (``_loss``), and what follows the update
    (``_after_update``); the update is this class's."""

    def __init__(self, model_cfg, core, mask, clip_grad, student_temp,
                 center_momentum, compute_dtype, route, n_crops, remat=False,
                 cnn=None, cnn_distill_weight=0.0, mesh=None, sharding=None,
                 backbone_forward=None):
        self.cfg = model_cfg
        self.core = core
        self.mask = mask
        self.n_crops = n_crops
        self.clip_grad = clip_grad
        self.student_temp = student_temp
        self.center_momentum = center_momentum
        self.compute_dtype = compute_dtype
        self.route = tsf.train_route(model_cfg, compute_dtype, route)
        self.remat = remat
        self.cnn = cnn
        self.cnn_distill_weight = cnn_distill_weight
        self.sharding = sharding
        self.mesh = sharding.mesh if mesh is None and sharding is not None else mesh
        self.backbone_forward = backbone_forward
        self.tp = sharding is not None and sharding.kind == "tp"
        group = None if self.mesh is None else self.mesh.data_group
        self._data_group = group
        self.batch_mean = None if group is None else self.global_mean

    def global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group (t where it has one rank)."""
        from ..parallel.mesh import all_reduce

        if self._data_group is None:
            return t
        return all_reduce(t, self._data_group) / self.mesh.data

    def _features(self, model: nn.ModuleDict, x: torch.Tensor,
                  student: bool = False) -> torch.Tensor:
        if self.backbone_forward is not None:
            if student and self.remat:
                from torch.utils import checkpoint

                return checkpoint.checkpoint(self.backbone_forward, model["backbone"], x,
                                             use_reentrant=False)
            return self.backbone_forward(model["backbone"], x)
        return model["backbone"].forward_train(x, self.compute_dtype, self.route,
                                               remat=student and self.remat)

    def _head(self, model: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        if self.tp:
            from ..parallel import tp

            return tp.head_forward(model["head"], x, self.mesh)
        return model["head"](x)

    def _dino(self, state: TrainState, s_feats, g_crops, teacher_temp):
        """The head on the student's features and the teacher's on its
        forward of ``g_crops``, then ``dino_loss``."""
        s_out = self._head(state.student, torch.cat(s_feats, dim=0))
        with torch.no_grad():
            t_out = self._head(state.teacher, torch.cat(
                [self._features(state.teacher, g) for g in g_crops], dim=0))
        return dino_loss(s_out.float(), t_out.float(), state.center, teacher_temp,
                         n_crops=self.n_crops, student_temp=self.student_temp,
                         center_momentum=self.center_momentum, batch_mean=self.batch_mean)

    def _loss(self, state: TrainState, g_crops, l_crops, teacher_temp):
        s_feats = [self._features(state.student, c, student=True)
                   for c in (g_crops, l_crops)]
        loss, center = self._dino(state, s_feats, [g_crops], teacher_temp)
        if self.cnn is not None:
            loss = loss + self.cnn_distill_weight * self._cnn_distill_term(
                state.student, g_crops, s_feats[0])
        return loss, center

    def _cnn_distill_term(self, student: nn.ModuleDict, g_crops: torch.Tensor,
                          s_g: torch.Tensor) -> torch.Tensor:
        """JAX ``cnn_distill_term``: mean(1 - cos) between the student's
        projected CLS features ``s_g`` of the global crops (in f32) and the
        frozen S3D's features of the same crops (eval-mode BatchNorm, in the
        step's compute dtype, pooled over (t, h, w), f32, L2-normalized)."""
        with torch.no_grad():
            feats = self.cnn(g_crops, training=False, compute_dtype=self.compute_dtype)
            feats = feats.mean(dim=(2, 3, 4)).float()
            feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        proj = student["cnn_proj"]
        p = torch.matmul(s_g.float(), proj.weight.t()) + proj.bias
        p = p / p.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.mean(1.0 - (p * feats).sum(dim=-1))

    def loss_and_grads(self, state: TrainState, *batch):
        """``batch``: the step's crops, then the teacher temperature. Under
        data parallelism the loss and the gradients are the global batch's
        (the means over the data group)."""
        from ..parallel.mesh import all_reduce_flat

        params = state.params()
        loss, new_center = self._loss(state, *batch)
        names = list(params)
        gs = torch.autograd.grad(loss, [params[n] for n in names],
                                 allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g.float()
                 for n, g in zip(names, gs)]
        if self._data_group is not None:
            grads = all_reduce_flat(grads, self._data_group, 1.0 / self.mesh.data)
        return self.global_mean(loss.detach()), new_center, dict(zip(names, grads))

    def __call__(self, state: TrainState, *args):
        """``args``: the step's crops, then lr, wd, teacher momentum,
        teacher temperature and the last-layer freeze."""
        *crops, lr, wd, teacher_momentum, teacher_temp, freeze_last = args
        return self.update(state, *self.loss_and_grads(state, *crops, teacher_temp),
                           lr, wd, teacher_momentum, freeze_last)

    def update(self, state: TrainState, loss, aux, grads, lr, wd, teacher_momentum,
               freeze_last):
        """The step's second half: the optimizer on ``loss_and_grads``'s
        gradients, then ``_after_update``; -> (state, metrics)."""
        state.opt_state = apply_updates_with_schedules(
            state.params(), grads, state.opt_state, self.core, self.mask,
            float(lr), float(wd), clip=self.clip_grad,
            freeze_last_layer=bool(freeze_last), sharding=self.sharding)
        metrics = self._after_update(state, loss, aux, float(teacher_momentum))
        state.step += 1
        return state, metrics

    def _after_update(self, state: TrainState, loss, new_center, teacher_momentum):
        """The teacher EMA and the new center; -> the step's metrics."""
        ema_update(state.teacher, state.student, teacher_momentum)
        state.center = new_center
        return {"loss": loss}


class TwoTokenTrainStep(TrainStep):
    """The two-token step (JAX ``make_train_step(two_token=True)``; ref:
    train_ssl.py:516-525, decoder.py:401-414): ``g_crops`` the 2 teacher
    views (2B, C, T, S, S), ``l_crops = (s96, s224)`` the student's 4:
    the two 96-px crops and the two temporally-local 224-px views, in the
    order [2 x 96 px, 2 x 224 px]. Aux-token backbone, dual head,
    ``dino_loss_two_token``; the plain route only, without remat, as in
    JAX (its two-token branch never calls the rematerialized forward)."""

    def _loss(self, state: TrainState, g_crops, l_crops, teacher_temp):
        s96, s224 = l_crops
        s_a = self._features(state.student, s96)
        s_b = self._features(state.student, s224)
        s_out = state.student["head"]((torch.cat([s_a[0], s_b[0]], dim=0),
                                       torch.cat([s_a[1], s_b[1]], dim=0)))
        with torch.no_grad():
            t_out = state.teacher["head"](self._features(state.teacher, g_crops))
        return dino_loss_two_token(s_out, t_out, state.center, teacher_temp,
                                   student_temp=self.student_temp,
                                   center_momentum=self.center_momentum,
                                   batch_mean=self.batch_mean)


class RandFrTrainStep(TrainStep):
    """The DATA.RAND_FR step (JAX ``make_rand_fr_train_step``): ``step(state,
    crops, lr, wd, teacher_momentum, teacher_temp, freeze_last)``, crops the
    6 frame-count groups (g4 (B, C, 4, S, S), g8 (B, C, 8, S, S), l2 (2B,
    C, 2, s, s), l4, l8, l16), the reference's vary_fr grouping (ref:
    utils/utils.py:583-588, decoder.py:418-427). One student forward per
    group, one teacher forward per global group, ``dino_loss`` over 10
    crops."""

    def _loss(self, state: TrainState, crops, teacher_temp):
        if len(crops) != 6:
            raise ValueError(f"rand-fr crops: 6 groups, got {len(crops)}")
        s_feats = [self._features(state.student, c, student=True) for c in crops]
        return self._dino(state, s_feats, crops[:2], teacher_temp)


def _step_route(route: str, two_token: bool) -> str:
    if route not in ("auto", "plain", "kernels"):
        raise ValueError(f"route {route!r}")
    if not two_token:
        return route
    if route == "kernels":
        raise ValueError(f"route='kernels': {tsf.TWO_TOKEN_PLAIN_ONLY}")
    return "plain"


def make_train_step(model_cfg: tsf.TimeSformerConfig, core: Optimizer, mask,
                    n_local_crops: int = 8, clip_grad: Optional[float] = 3.0,
                    student_temp: float = 0.1, center_momentum: float = 0.9,
                    compute_dtype: torch.dtype = torch.float32,
                    route: str = "auto", remat: bool = False,
                    two_token: bool = False, cnn_params=None,
                    cnn_distill_weight: float = 0.0, mesh=None,
                    state_sharding=None, backbone_forward=None) -> TrainStep:
    """The DINO step (the JAX ``make_train_step``). ``route``: ``"auto"``
    (``train_route``, once for the model), ``"plain"`` or ``"kernels"``
    (bf16, or f32: the mixed tier; raises where the kernels' gate refuses
    the model). ``remat``: the student's backbone passes rematerialized per
    block (``timesformer.checkpoint_block``), on every route, the same
    values. ``two_token``: ``TwoTokenTrainStep`` (``n_local_crops`` and
    ``remat`` unused; ``"auto"`` is the plain route, ``"kernels"``
    raises). ``cnn_params`` (a frozen ``s3d.S3D``) with ``cnn_distill_weight``
    > 0 adds the CNN-distillation term (the state needs ``cnn_proj``:
    ``init_train_state(cnn_distill_dim=1024)``); weight 0 is the reference's
    behaviour, the S3D built and no term. ``mesh``, ``state_sharding`` and
    ``backbone_forward``: the parallel step (module docstring); a
    "tp" sharding without a ``backbone_forward`` runs the plain TP route.
    The two-token variant takes a mesh (data parallelism) and nothing
    else, as the JAX CLI allows it."""
    route = _step_route(route, two_token)
    tp = state_sharding is not None and state_sharding.kind == "tp"
    if two_token:
        if backbone_forward is not None or tp:
            raise ValueError("backbone_forward and tensor parallelism run the plain "
                             "variant; the two-token step takes data parallelism only")
        return TwoTokenTrainStep(model_cfg, core, mask, clip_grad, student_temp,
                                 center_momentum, compute_dtype, route, n_crops=4,
                                 mesh=mesh, sharding=state_sharding)
    if tp and backbone_forward is None:
        from functools import partial

        from ..parallel.tp import tp_forward_features

        backbone_forward = partial(tp_forward_features, cfg=model_cfg,
                                   mesh=mesh or state_sharding.mesh,
                                   compute_dtype=compute_dtype)
    use_cnn = cnn_params is not None and cnn_distill_weight > 0.0
    return TrainStep(model_cfg, core, mask, clip_grad, student_temp,
                     center_momentum, compute_dtype, route,
                     n_crops=2 + n_local_crops, remat=remat,
                     cnn=cnn_params if use_cnn else None,
                     cnn_distill_weight=cnn_distill_weight, mesh=mesh,
                     sharding=state_sharding, backbone_forward=backbone_forward)


def make_rand_fr_train_step(model_cfg: tsf.TimeSformerConfig, core: Optimizer, mask,
                            clip_grad: Optional[float] = 3.0,
                            student_temp: float = 0.1, center_momentum: float = 0.9,
                            compute_dtype: torch.dtype = torch.float32,
                            route: str = "auto", mesh=None) -> RandFrTrainStep:
    """The variable-frame-count multi-crop step (DATA.RAND_FR; JAX
    ``make_rand_fr_train_step``), on ``make_train_step``'s routes;
    ``mesh``: data parallelism."""
    route = _step_route(route, False)
    return RandFrTrainStep(model_cfg, core, mask, clip_grad, student_temp,
                           center_momentum, compute_dtype, route, n_crops=10, mesh=mesh)


@dataclasses.dataclass
class TwoStreamState:
    """The MODEL.TWO_STREAM state (ref: train_ssl.py:280-346; JAX
    ``TwoStreamState``): the RGB student and teacher (``{"backbone": a
    TimeSformer, "head": MultiDINOHead}``), the motion student and teacher
    (``{"backbone": vit2d.ViT2D, "head": DINOHead}``), the three centers
    (1, out_dim) and one optimizer state over both students' parameters,
    named ``rgb.<name>`` and ``motion.<name>``."""
    student: nn.ModuleDict
    teacher: nn.ModuleDict
    motion_student: nn.ModuleDict
    motion_teacher: nn.ModuleDict
    center_rgb: torch.Tensor
    center_flow: torch.Tensor
    center_cross: torch.Tensor
    opt_state: dict
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return {**{"rgb." + n: p for n, p in self.student.named_parameters()},
                **{"motion." + n: p for n, p in self.motion_student.named_parameters()}}


def init_two_stream_state(model_cfg: tsf.TimeSformerConfig, motion_cfg,
                          out_dim: int = 65536, optimizer: str = "adamw",
                          momentum: float = 0.9, seed: int = 0,
                          pretrained_backbone: Optional[Mapping] = None,
                          pretrained_motion: Optional[Mapping] = None,
                          head_state_dict: Optional[Mapping] = None,
                          motion_head_state_dict: Optional[Mapping] = None,
                          device=None):
    """(ref: train_ssl.py:222-231, 280-346; JAX ``init_two_stream_state``)
    -> (state, core, mask). The RGB student gets the dual head with the
    intended wiring (both streams read the same CLS features: the reference's
    shipped wiring row-slices one tensor, SURVEY section 7); the motion
    student is a ``vit2d.ViT2D`` of ``motion_cfg`` with a ``DINOHead``.
    Weights from reference-layout state dicts where given, else from a
    ``torch.Generator`` seeded with ``seed``; the teachers copy the
    students."""
    from ..models import vit2d
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if pretrained_backbone is not None:
        with torch.device("cpu"):
            backbone = tsf.TimeSformer(model_cfg)
        backbone.load_reference_state_dict(pretrained_backbone)
    else:
        backbone = tsf.init_timesformer(model_cfg, gen, device="cpu")
    head = MultiDINOHead(model_cfg.embed_dim, out_dim,
                         generator=None if head_state_dict is not None else gen)
    if head_state_dict is not None:
        tsf.load_reference_state_dict(head, head_state_dict)
    if pretrained_motion is not None:
        with torch.device("cpu"):
            mbackbone = vit2d.ViT2D(motion_cfg)
        mbackbone.load_reference_state_dict(pretrained_motion)
    else:
        mbackbone = vit2d.init_vit2d(motion_cfg, gen, device="cpu")
    mhead = DINOHead(motion_cfg.embed_dim, out_dim,
                     generator=None if motion_head_state_dict is not None else gen)
    if motion_head_state_dict is not None:
        tsf.load_reference_state_dict(mhead, motion_head_state_dict)
    student = nn.ModuleDict({"backbone": backbone, "head": head}).to(dev)
    motion = nn.ModuleDict({"backbone": mbackbone, "head": mhead}).to(dev)
    teacher, motion_teacher = copy.deepcopy(student), copy.deepcopy(motion)
    teacher.requires_grad_(False)
    motion_teacher.requires_grad_(False)
    # one optimizer over both students (ref: train_ssl.py:377-381)
    core = Optimizer(optimizer, momentum)
    mask = wd_mask(nn.ModuleDict({"rgb": student, "motion": motion}))
    zeros = lambda: torch.zeros((1, out_dim), device=dev)  # noqa: E731
    state = TwoStreamState(student, teacher, motion, motion_teacher, zeros(),
                           zeros(), zeros(), opt_state=None)
    state.opt_state = core.init(state.params())
    return state, core, mask


class TwoStreamTrainStep(TrainStep):
    """The TWO_STREAM step (ref: train_ssl.py:507-519; JAX
    ``make_two_stream_train_step``): ``step(state, g_crops (2B, C, T, S, S),
    l_crops (nB, C, T, s, s), flow (2B, C, H, W), lr, wd, teacher_momentum,
    teacher_temp, freeze_last) -> (state, {"loss", "loss_rgb", "loss_flow",
    "loss_cross"})``::

        loss = dino(rgb_student(2+n crops), rgb_teacher(2 globals))
             + dino(motion_student(flow), motion_teacher(flow))
             + dino(cross_student(2+n crops), motion_teacher(flow))

    The RGB backbones on the step's route, the motion nets plain."""

    def __init__(self, motion_cfg, *args, **kw):
        super().__init__(*args, **kw)
        self.motion_cfg = motion_cfg

    def _motion(self, model: nn.ModuleDict, flow: torch.Tensor) -> torch.Tensor:
        return model["head"](model["backbone"](flow, self.compute_dtype))

    def _loss(self, state: TwoStreamState, g_crops, l_crops, flow, teacher_temp):
        feats = torch.cat([self._features(state.student, c, student=True)
                           for c in (g_crops, l_crops)], dim=0)
        s_rgb, s_cross = state.student["head"]((feats, feats))
        s_flow = self._motion(state.motion_student, flow)
        with torch.no_grad():
            # the teacher's dual head on (t, t): only its rgb stream is read
            t_rgb = state.teacher["head"].main(self._features(state.teacher, g_crops))
            t_flow = self._motion(state.motion_teacher, flow)
        kw = dict(student_temp=self.student_temp, center_momentum=self.center_momentum,
                  batch_mean=self.batch_mean)
        l_rgb, c_rgb = dino_loss(s_rgb.float(), t_rgb.float(), state.center_rgb,
                                 teacher_temp, n_crops=self.n_crops, **kw)
        l_flow, c_flow = dino_loss(s_flow.float(), t_flow.float(), state.center_flow,
                                   teacher_temp, n_crops=2, **kw)
        l_cross, c_cross = dino_loss(s_cross.float(), t_flow.float(), state.center_cross,
                                     teacher_temp, n_crops=self.n_crops, **kw)
        loss = l_rgb + l_flow + l_cross
        return loss, ((c_rgb, c_flow, c_cross),
                      {"loss_rgb": self.global_mean(l_rgb.detach()),
                       "loss_flow": self.global_mean(l_flow.detach()),
                       "loss_cross": self.global_mean(l_cross.detach())})

    def _after_update(self, state: TwoStreamState, loss, aux, teacher_momentum):
        centers, metrics = aux
        ema_update(state.teacher, state.student, teacher_momentum)
        ema_update(state.motion_teacher, state.motion_student, teacher_momentum)
        state.center_rgb, state.center_flow, state.center_cross = centers
        return {"loss": loss, **metrics}


def make_two_stream_train_step(model_cfg: tsf.TimeSformerConfig, motion_cfg,
                               core: Optimizer, mask, n_local_crops: int = 8,
                               clip_grad: Optional[float] = 3.0,
                               student_temp: float = 0.1, center_momentum: float = 0.9,
                               compute_dtype: torch.dtype = torch.float32,
                               route: str = "auto", remat: bool = False, mesh=None
                               ) -> TwoStreamTrainStep:
    """The TWO_STREAM step (JAX ``make_two_stream_train_step``) on
    ``make_train_step``'s routes for the RGB backbones (``"auto"`` on bf16
    ViT-B: the per-phase kernels); ``remat`` rematerializes the RGB
    student's passes; ``mesh``: data parallelism."""
    route = _step_route(route, False)
    return TwoStreamTrainStep(motion_cfg, model_cfg, core, mask, clip_grad,
                              student_temp, center_momentum, compute_dtype, route,
                              n_crops=2 + n_local_crops, remat=remat, mesh=mesh)


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
