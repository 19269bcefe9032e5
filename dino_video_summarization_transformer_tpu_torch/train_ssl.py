"""DINO self-supervised video-transformer pretraining on the card
(ref: train_ssl.py:50-463; counterpart of the repo root's ``train_ssl.py``,
with the same flag set plus ``--device``).

    python -m dino_video_summarization_transformer_tpu_torch.train_ssl \\
        --cfg configs/kinetics/timesformer_divst_8x32_224.yaml \\
        --data_path /data/kinetics400 --output_dir out/svt \\
        --batch_size_per_gpu 8 --epochs 20

Runs multi-crop DINO (2 global + N local clips from ``ClipDataset``),
AdamW / SGD / LARS, the cosine
lr / wd / teacher-momentum schedules, teacher-temperature warmup, gradient
clip and last-layer freeze, the EMA teacher, a checkpoint at
``output_dir/checkpoint`` with resume from it, and one ``log.txt`` JSON
line per epoch. ``--use_fp16`` (the default) is bf16 compute, which on
ViT-B and ViT-S runs the per-phase Hopper kernels forward and backward;
f32 compute runs with TF32 off. The loss is checked every ``SYNC_EVERY``
steps; a non-finite one stops the run with exit code 1.

The variants of the JAX CLI: ``--two_token`` or ``MODEL.TWO_TOKEN`` (the
aux-token backbone and the 6-view protocol, on the plain route),
``DATA.RAND_FR`` (variable-frame-count crops, one forward per frame-count
group), ``--use_remat`` (rematerialized student forwards),
``--profile_dir`` (a ``torch.profiler`` Chrome trace of steps
``--profile_start_step`` to ``+ --profile_steps``, also written when the
run stops on a non-finite loss), ``MODEL.TWO_STREAM`` (with
``DATA.NO_FLOW_AUG``: the optical-flow companion of each video, two flow
frames a step drawn from ``RandomState(seed + 1)`` and shared across the
batch, ViT-S/16 motion nets at ``DATA.CROP_SIZE``, ``--pretrained_motion``
a DINO ViT-S ``.pth``; the log adds ``train_loss_rgb``, ``train_loss_flow``
and ``train_loss_cross``) and ``MODEL.CNN_DISTILL`` (a frozen S3D teacher,
``--pretrained_cnn`` a CoCLR ``.pth.tar`` or seeded weights, and with
``--cnn_distill_weight`` > 0 the distillation term; weight 0 builds the
teacher and adds no term, as the reference).

The online kNN hook (``--knn_eval_freq`` N with ``--knn_data_path``):
every N epochs and after the last, the teacher backbone's f32 features of
the ``--knn_dataset`` train and val splits, a ``--nb_knn`` vote, and
``knn_top1`` / ``knn_top5`` in the epoch's ``log.txt`` line. The teacher
runs its training forward in f32 under ``torch.no_grad``, on the train
step's route: the kernel route's f32 tiers (rows 1f, 4f and 3f) where the
step runs the kernels, as JAX's hook runs ``use_fused`` at f32.

Parallelism, with JAX's flags and rules (``train_ssl.py:236-252,
313-350, 419-441`` there), over the ranks torchrun starts::

    torchrun --nproc_per_node 4 -m \
        dino_video_summarization_transformer_tpu_torch.train_ssl \
        --model_parallel 2 --tp_fused true ...

Data parallelism over the ranks is the default, as JAX's mesh spans every
device: the node's batch is ``--batch_size_per_gpu`` x (ranks of the node
// the parallelism group), drawn in JAX's order (``shard_indices`` over the
nodes), and data rank r trains on its contiguous rows r * b .. (r + 1) * b
(every rank decodes the node's batch, whose augmentations draw one
``RandomState`` stream, as JAX's host does). ``--model_parallel N``: tensor
parallelism over N ranks, the plain route, or with ``--tp_fused true``
(bf16 on the kernels' geometry, heads divisible by N, the plain variant)
the head-sharded per-phase kernels; ``--zero1 true``: the Adam moments
over the data axis (exclusive of ``--model_parallel``); ``--num_shards
N``: fail unless the launch brought up at least N ranks. Only the main
process writes ``config.json``, ``log.txt`` and the checkpoints; the
checkpoint is always the single-card layout (the ranks gather the state
first), so a TP run's checkpoint loads into the single-card trainer and
scorer and a resume under another ``--model_parallel`` cuts it anew.
``--pipeline`` and ``--seq_parallel`` raise ``NotImplementedError``
unless they are at their defaults.
``--norm_last_layer`` is parsed and never read, as in the JAX CLI
(ROADMAP section 3).
"""

import argparse
import datetime
import json
import math
import os
import sys
import time
from functools import partial

from .utils.misc import bool_flag

SYNC_EVERY = 10

# flag -> (default, what it selects)
UNPORTED_FLAGS = {
    "pipeline": (1, "pipeline parallelism (JAX parallel/pp.py; the next parallel slice)"),
    "seq_parallel": (1, "sequence parallelism (JAX parallel/sp.py; the next parallel slice)"),
}


def get_args_parser():
    p = argparse.ArgumentParser("DINO-SVT (CUDA)", add_help=False)
    p.add_argument("--arch", default="vit_base", type=str,
                   choices=["vit_tiny", "vit_small", "vit_base", "timesformer", "swin"])
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--out_dim", default=65536, type=int)
    p.add_argument("--norm_last_layer", default=True, type=bool_flag)
    p.add_argument("--momentum_teacher", default=0.996, type=float)
    p.add_argument("--use_bn_in_head", default=False, type=bool_flag)
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--teacher_temp", default=0.04, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=0, type=int)
    p.add_argument("--use_fp16", default=True, type=bool_flag,
                   help="bfloat16 compute (the Hopper kernels on ViT-B/S)")
    p.add_argument("--weight_decay", type=float, default=0.04)
    p.add_argument("--weight_decay_end", type=float, default=0.4)
    p.add_argument("--clip_grad", type=float, default=3.0)
    p.add_argument("--batch_size_per_gpu", default=8, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--freeze_last_layer", default=1, type=int)
    p.add_argument("--lr", default=0.0005, type=float)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--optimizer", default="adamw", type=str,
                   choices=["adamw", "sgd", "lars"])
    p.add_argument("--global_crops_scale", type=float, nargs="+", default=(0.4, 1.0))
    p.add_argument("--local_crops_number", type=int, default=8)
    p.add_argument("--local_crops_scale", type=float, nargs="+", default=(0.05, 0.4))
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--pretrained_rgb", default=None, type=str)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--saveckp_freq", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--dist_url", default="env://", type=str)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--max_steps_per_epoch", default=0, type=int,
                   help="debug: cap iterations per epoch (0 = full epoch)")
    p.add_argument("--two_token", default=False, type=bool_flag)
    p.add_argument("--pretrained_motion", default=None, type=str)
    p.add_argument("--pretrained_cnn", default=None, type=str)
    p.add_argument("--cnn_distill_weight", default=0.0, type=float)
    p.add_argument("--use_remat", default=False, type=bool_flag)
    p.add_argument("--profile_dir", default="", type=str)
    p.add_argument("--profile_start_step", default=10, type=int)
    p.add_argument("--profile_steps", default=5, type=int)
    p.add_argument("--knn_eval_freq", default=0, type=int)
    p.add_argument("--knn_data_path", default="", type=str)
    p.add_argument("--knn_dataset", default="ucf101", type=str)
    p.add_argument("--nb_knn", default=5, type=int)
    p.add_argument("--temperature", default=0.07, type=float)
    p.add_argument("--eval_batch_size_per_gpu", default=8, type=int)
    p.add_argument("--model_parallel", default=1, type=int)
    p.add_argument("--tp_fused", default=False, type=bool_flag)
    p.add_argument("--zero1", default=False, type=bool_flag)
    p.add_argument("--num_shards", default=1, type=int)
    p.add_argument("--pipeline", default=1, type=int)
    p.add_argument("--pipe_micro", default=2, type=int)
    p.add_argument("--seq_parallel", default=1, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def check_unported(args) -> None:
    for flag, (default, what) in UNPORTED_FLAGS.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)!r}: {what} is not ported to "
                "the CUDA package yet (ROADMAP)")


class StepProfiler:
    """The ``--profile_dir`` trace (the JAX CLI's ``jax.profiler`` window):
    ``torch.profiler`` over the CPU and, on a card, CUDA activities, started
    before step ``start`` and stopped before step ``start + steps`` (or by
    ``stop``), which writes ``trace.json``, a Chrome trace, into
    ``profile_dir`` and prints ``profiler trace written to <dir>``."""

    def __init__(self, profile_dir: str, start: int, steps: int, device):
        self.profile_dir = profile_dir
        self.start, self.steps = start, steps
        self.device = device
        self.prof = None
        self.path = os.path.join(profile_dir, "trace.json") if profile_dir else None

    def step(self, gi: int) -> None:
        """Call before global step ``gi``."""
        if self.profile_dir and self.prof is None and gi == self.start:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        if self.prof is not None and gi >= self.start + self.steps:
            self.stop()

    def stop(self) -> None:
        """Flush a running trace (a no-op otherwise)."""
        if self.prof is None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print(f"profiler trace written to {self.profile_dir}", flush=True)


def parallel_plan(args, two_token: bool, two_stream: bool, rand_fr: bool,
                  local_ranks: int):
    """JAX's parallelism rules (its ``train_ssl.py:236-249, 344-350,
    419-421``): -> the parallelism group's size. Raises ValueError where
    JAX asserts."""
    sizes = (args.model_parallel, args.pipeline, args.seq_parallel)
    if min(sizes) < 1:
        raise ValueError("--model_parallel / --pipeline / --seq_parallel must be >= 1")
    if sum(x > 1 for x in sizes) > 1:
        raise ValueError("--model_parallel / --pipeline / --seq_parallel are exclusive "
                         "(compose dp with ONE of them)")
    group = max(sizes)
    if local_ranks % group:
        raise ValueError(f"the parallelism group size ({group}) must divide the ranks "
                         f"of the node ({local_ranks}); otherwise the per-node batch "
                         "would silently floor")
    if not ((group == 1 and not args.zero1) or not (two_stream or rand_fr)):
        raise ValueError("--model_parallel/--pipeline/--seq_parallel/--zero1 support "
                         "the plain/two_token trainer variants")
    if not (group == 1 or not two_token):
        raise ValueError("--pipeline/--seq_parallel/--model_parallel support the plain "
                         "trainer variant")
    if args.zero1 and args.model_parallel > 1:
        raise ValueError("--zero1 and --model_parallel are exclusive (the TP tree "
                         "already shards the moments over the model axis)")
    return group


def online_knn_eval(args, cfg, backbone, epoch, route, device):
    """Online kNN probe on the teacher backbone (ref: train_ssl.py:576-599;
    JAX ``online_knn_eval``): f32 features of the ``--knn_dataset`` splits
    through ``forward_train(compute_dtype=float32, route=route)``."""
    import numpy as np
    import torch

    from .config import set_data_path
    from .data.datasets import build_dataset
    from .engine.knn import extract_features, knn_classifier, l2_normalize
    from .eval_knn import ReturnIndexDataset

    knn_cfg = cfg.clone()
    knn_cfg.TEST.NUM_SPATIAL_CROPS = 1
    set_data_path(knn_cfg, args.knn_data_path)
    ds_train = build_dataset(args.knn_dataset, knn_cfg, "train", num_retries=10)
    ds_val = build_dataset(args.knn_dataset, knn_cfg, "val", num_retries=10)

    def feats(ds):
        return l2_normalize(extract_features(
            backbone, ReturnIndexDataset(ds), batch_size=args.eval_batch_size_per_gpu,
            num_workers=args.num_workers,
            forward=lambda x: backbone.forward_train(
                x, compute_dtype=torch.float32, route=route)))

    top1, top5 = knn_classifier(
        feats(ds_train), np.asarray(ds_train.labels, np.int64),
        feats(ds_val), np.asarray(ds_val.labels, np.int64),
        args.nb_knn, args.temperature, num_classes=max(ds_train.labels) + 1,
        device=device)
    print(f"[epoch {epoch}] online kNN: top1 {top1:.2f} top5 {top5:.2f}", flush=True)
    return {"knn_top1": top1, "knn_top5": top5}


def train_svt(args):
    """(ref: train_ssl.py:154-463). Returns the final ``TrainState``."""
    import numpy as np
    import torch

    from .config import load_config, set_data_path
    from .data.datasets import ClipDataset
    from .data.loader import PrefetchLoader, shard_indices
    from .models import convert
    from .models.timesformer import config_from_cfg, train_route
    from .parallel import mesh as pmesh
    from .train.dino import teacher_temp_schedule
    from .train.ssl import (build_schedules, init_train_state, init_two_stream_state,
                            make_rand_fr_train_step, make_train_step,
                            make_two_stream_train_step)
    from .utils.checkpoint import restore_checkpoint, save_checkpoint
    from .utils.device import resolve_device
    from .utils.flops import train_step_flops

    cfg = load_config(args)
    check_unported(args)
    set_data_path(cfg, args.data_path)
    dist_info = pmesh.init_distributed_mode(num_shards=args.num_shards, device=args.device)
    world = dist_info["world_size"]
    dev = pmesh.rank_device(args.device) if world > 1 else resolve_device(args.device)
    main_process = pmesh.is_main_process()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    print("\n".join(f"{k}: {v}" for k, v in sorted(dict(vars(args)).items())))
    os.makedirs(args.output_dir, exist_ok=True)
    if main_process:
        with open(os.path.join(args.output_dir, "config.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    # ---------------- data -------------------------------------------------
    two_token = args.two_token or cfg.MODEL.TWO_TOKEN
    two_stream = cfg.MODEL.TWO_STREAM
    rand_fr = cfg.DATA.RAND_FR
    if two_stream and not cfg.DATA.NO_FLOW_AUG:
        raise ValueError("TWO_STREAM requires DATA.NO_FLOW_AUG: the reference's "
                         "aug'd flow path never defines flow_images (ref: "
                         "train_ssl.py:498-502)")
    if two_token and args.knn_eval_freq:
        raise NotImplementedError(
            "--knn_eval_freq with the two-token variant: JAX's hook runs the "
            "one-token forward on the two-token backbone; the port does not "
            "(ROADMAP section 3)")
    # JAX's parallelism rules, before any rank reads data
    local_ranks = pmesh.local_world_size() if world > 1 else 1
    group = parallel_plan(args, two_token, two_stream, rand_fr, local_ranks)
    dataset = ClipDataset(cfg, "train", temporal_aug=not two_token,
                          two_token=two_token, rand_fr=rand_fr, get_flow=two_stream,
                          seed=args.seed)
    # the node's batch (JAX's per-host batch) and this rank's rows of it
    nodes, node = max(world // local_ranks, 1), pmesh.get_rank() // local_ranks
    per_host = args.batch_size_per_gpu * (local_ranks // group)
    data_rank = (pmesh.get_rank() % local_ranks) // group
    rows = slice(data_rank * args.batch_size_per_gpu,
                 (data_rank + 1) * args.batch_size_per_gpu)
    n_local = 2 if two_token else args.local_crops_number
    idx = shard_indices(len(dataset), node, nodes, shuffle=True, seed=args.seed,
                        drop_last=True)
    niter_per_ep = max(len(idx) // per_host, 1)
    print(f"Data loaded: {len(dataset)} videos, {niter_per_ep} it/epoch.")

    flow_rng = np.random.RandomState(args.seed + 1)

    def collate(items):
        """The step's crops: views stacked view-major, as the reference's
        multi-crop wrapper concatenates them (ref: utils/utils.py:582-609);
        items are the dataset's (crops, label, index, meta)."""
        def stack(arrays):
            return torch.from_numpy(np.concatenate(arrays)).to(dev, non_blocking=True)

        def views(sel):
            return stack([np.stack([it[0][c] for it in items]) for c in sel])

        if two_token:
            # teacher [v0, v1]; student ([v2, v3] at 96 px, [v4, v5] at 224)
            # (ref: transform.py:738-743)
            return views((0, 1)), (views((2, 3)), views((4, 5)))
        if rand_fr:
            # the vary_fr groups [1, 2, 4, 6, 8, 10] (ref: utils/utils.py:583-588)
            return (tuple(views(sel) for sel in
                          ((0,), (1,), (2, 3), (4, 5), (6, 7), (8, 9))),)
        if two_stream:
            # 2 random flow frames, shared across the batch (ref:
            # train_ssl.py:500-502)
            n_flow = min(len(it[3]["flow"]) for it in items)
            fi = flow_rng.choice(range(min(cfg.DATA.NUM_FRAMES, n_flow)), 2,
                                 replace=False)
            flow = stack([np.stack([np.asarray(it[3]["flow"][i]) for it in items])
                          for i in fi])
            return views(range(2)), views(range(2, 2 + n_local)), flow
        return views(range(2)), views(range(2, 2 + n_local))

    def rank_rows(tree):
        """This rank's rows of the node's batch: of each view-major tensor,
        its rows of every view."""
        if isinstance(tree, tuple):
            return tuple(rank_rows(c) for c in tree)
        v = tree.reshape((-1, per_host) + tree.shape[1:])[:, rows]
        return v.reshape((-1,) + tree.shape[1:])

    # the node's first rank decodes and collates the node's batch (JAX's one
    # process a host) and every rank of the node takes its rows of it
    src = node * local_ranks
    node_ranks = pmesh.node_group(local_ranks) if local_ranks > 1 else None

    def batches(epoch):
        order = shard_indices(len(dataset), node, nodes, shuffle=True,
                              seed=args.seed + epoch, drop_last=True)
        if pmesh.get_rank() != src:
            for _ in range(len(order) // per_host):
                yield rank_rows(pmesh.broadcast_tree(None, src, node_ranks, dev))
            return
        items = []
        for item in PrefetchLoader(dataset, indices=order,
                                   num_workers=args.num_workers):
            items.append(item)
            if len(items) == per_host:
                full = collate(items)
                if local_ranks > 1:
                    pmesh.broadcast_tree(full, src, node_ranks, dev)
                yield rank_rows(full)
                items = []

    # ---------------- model ------------------------------------------------
    mcfg = config_from_cfg(cfg, no_head=True, arch=args.arch)
    backbone_sd = None
    if args.pretrained_rgb:
        backbone_sd = convert.convert_svt_checkpoint(
            args.pretrained_rgb, mcfg, checkpoint_key="teacher")
        print(f"Loaded pretrained RGB backbone from {args.pretrained_rgb}")
    # the optional S3D teacher (MODEL.CNN_DISTILL; ref: train_ssl.py:263-277)
    cnn = None
    if cfg.MODEL.CNN_DISTILL:
        from .models import s3d

        if args.pretrained_cnn:
            with torch.device("cpu"):
                cnn = s3d.S3D()
            cnn.load_reference_state_dict(convert.convert_coclr_s3d(args.pretrained_cnn))
            cnn = cnn.to(dev)
            print(f"Loaded CoCLR S3D teacher from {args.pretrained_cnn}")
        else:
            cnn = s3d.init_s3d(torch.Generator().manual_seed(args.seed + 7), device=dev)
        cnn.requires_grad_(False)
    compute_dtype = torch.bfloat16 if args.use_fp16 else torch.float32
    # JAX's fuse_tp: the head-sharded kernels where the kernels take the
    # model (bf16), its heads split evenly, on the plain variant
    kernels = train_route(mcfg, compute_dtype, "auto") == "kernels"
    fuse_tp = (args.tp_fused and kernels and args.model_parallel > 1
               and mcfg.num_heads % args.model_parallel == 0
               and not two_token and not (two_stream or rand_fr))
    if kernels and group > 1 and not fuse_tp:
        print("NOTE: --model_parallel runs the plain TP route by default; "
              "--tp_fused true opts into the head-sharded kernels", flush=True)
    mesh = pmesh.build_mesh(model=args.model_parallel) if world > 1 else None
    if two_stream:
        from .models.vit2d import vit2d_small

        motion_cfg = vit2d_small(img_size=cfg.DATA.CROP_SIZE)
        motion_sd = None
        if args.pretrained_motion:
            motion_sd = convert.convert_dino_vit2d_checkpoint(args.pretrained_motion,
                                                              motion_cfg)
            print(f"Loaded motion ViT from {args.pretrained_motion}")
        state, core, mask = init_two_stream_state(
            mcfg, motion_cfg, out_dim=args.out_dim, optimizer=args.optimizer,
            seed=args.seed, pretrained_backbone=backbone_sd,
            pretrained_motion=motion_sd, device=dev)
        step_fn = make_two_stream_train_step(
            mcfg, motion_cfg, core, mask, n_local_crops=n_local,
            clip_grad=args.clip_grad, compute_dtype=compute_dtype, remat=args.use_remat,
            mesh=mesh)
    elif rand_fr:
        state, core, mask = init_train_state(
            mcfg, out_dim=args.out_dim, optimizer=args.optimizer, seed=args.seed,
            pretrained_backbone=backbone_sd, device=dev)
        step_fn = make_rand_fr_train_step(mcfg, core, mask, clip_grad=args.clip_grad,
                                          compute_dtype=compute_dtype, mesh=mesh)
    else:
        distill = cnn is not None and args.cnn_distill_weight > 0
        state, core, mask = init_train_state(
            mcfg, out_dim=args.out_dim, optimizer=args.optimizer, seed=args.seed,
            pretrained_backbone=backbone_sd, device=dev, two_token=two_token,
            cnn_distill_dim=1024 if distill else 0)
    sharding_kind = ("tp" if args.model_parallel > 1 else "zero1" if args.zero1 and mesh
                     else None)

    def make_step(sharding):
        if two_stream or rand_fr:
            return step_fn
        fwd = None
        if fuse_tp:
            from .parallel.tp_fused import tp_fused_forward_features

            fwd = partial(tp_fused_forward_features, cfg=mcfg, mesh=mesh,
                          compute_dtype=compute_dtype)
        return make_train_step(mcfg, core, mask, n_local_crops=n_local,
                               clip_grad=args.clip_grad, compute_dtype=compute_dtype,
                               remat=args.use_remat, two_token=two_token,
                               cnn_params=cnn, cnn_distill_weight=args.cnn_distill_weight,
                               mesh=mesh, state_sharding=sharding, backbone_forward=fwd)

    # ---------------- schedules --------------------------------------------
    # lr scaled by batch_size_per_gpu x every card of the world, as JAX scales
    # it by its device count whatever the parallelism group
    lr_sched, wd_sched, mom_sched = build_schedules(args, niter_per_ep, world=world)
    tt_sched = teacher_temp_schedule(
        args.warmup_teacher_temp, args.teacher_temp,
        args.warmup_teacher_temp_epochs, args.epochs)

    # ---------------- resume ------------------------------------------------
    # the checkpoint is the single-card layout: restore the whole state,
    # then cut this rank's shards
    ckpt_path = os.path.join(args.output_dir, "checkpoint")
    restored, run_vars = restore_checkpoint(ckpt_path, state)
    start_epoch = 0
    if restored is not None:
        state = restored
        start_epoch = int(run_vars.get("epoch", 0))
        print(f"Resumed from {ckpt_path} at epoch {start_epoch}")
    sharding = None
    if sharding_kind is not None:
        from .parallel.state import shard_train_state

        sharding = shard_train_state(state, sharding_kind, mesh, mcfg.num_heads)
    step_fn = make_step(sharding)
    if fuse_tp:
        print(f"TP x{args.model_parallel}: head-sharded per-phase kernels "
              "(parallel/tp_fused.py)", flush=True)
    route = step_fn.route
    if sharding_kind == "tp":  # the backbone runs one of the TP forwards
        route = "kernels (TP-fused)" if fuse_tp else "plain (TP)"
    print(f"Block route: {route} ({compute_dtype})")

    if rand_fr or two_token or two_stream:
        step_flops = 0.0  # mixed-geometry steps: no analytic model, as in JAX
    else:  # the step's global batch, over every card of the world
        step_flops = train_step_flops(mcfg, per_host * nodes, n_local_crops=n_local,
                                      local_size_px=96)

    # ---------------- train loop -------------------------------------------
    profiler = StepProfiler(args.profile_dir, args.profile_start_step,
                            args.profile_steps, dev)
    start_time = time.time()
    for epoch in range(start_epoch, args.epochs):
        sums = {}
        count = 0
        pending = []  # (global step, metrics): drained every SYNC_EVERY

        def drain():
            nonlocal count
            for gi, metrics in pending:
                vals = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(vals["loss"]):
                    print(f"Loss is {vals['loss']}, stopping training", flush=True)
                    profiler.stop()  # flush the profile of the dying run
                    sys.exit(1)
                vals.update(lr=float(lr_sched[gi]), wd=float(wd_sched[gi]))
                for k, v in vals.items():
                    sums[k] = sums.get(k, 0.0) + v
                count += 1
            pending.clear()

        epoch_t0 = time.time()
        steps_done = 0
        for it, crops in enumerate(batches(epoch)):
            if args.max_steps_per_epoch and it >= args.max_steps_per_epoch:
                break
            gi = min(epoch * niter_per_ep + it, len(lr_sched) - 1)
            profiler.step(gi)
            state, metrics = step_fn(
                state, *crops, float(lr_sched[gi]), float(wd_sched[gi]),
                float(mom_sched[gi]), float(tt_sched[min(epoch, len(tt_sched) - 1)]),
                epoch < args.freeze_last_layer)
            pending.append((gi, metrics))
            steps_done += 1
            if len(pending) >= SYNC_EVERY:
                drain()
            if it % 10 == 0:
                print(f"Epoch: [{epoch}/{args.epochs}] [{it}/{niter_per_ep}]",
                      flush=True)
        drain()
        epoch_dt = time.time() - epoch_t0

        # every rank gathers the whole state (a collective); the main
        # process writes it, in the single-card layout
        if sharding is not None:
            from .parallel.state import gather_train_state

            ckpt_state = gather_train_state(state, sharding)
        else:
            ckpt_state = state
        if main_process:
            save_checkpoint(ckpt_path, ckpt_state, {"epoch": epoch + 1})
            if args.saveckp_freq and epoch % args.saveckp_freq == 0:
                save_checkpoint(os.path.join(args.output_dir, f"checkpoint{epoch:04d}"),
                                ckpt_state, {"epoch": epoch + 1})
        # the losses are the global batch's already (the step's means over
        # the data group), so every rank's averages agree
        log_stats = {f"train_{k}": v / max(count, 1) for k, v in sums.items()}
        log_stats["epoch"] = epoch
        if step_flops and steps_done and dev.type == "cuda":
            log_stats["achieved_tflops"] = round(
                step_flops * steps_done / epoch_dt / 1e12, 2)
        if (args.knn_eval_freq and args.knn_data_path
                and (epoch % args.knn_eval_freq == 0 or epoch == args.epochs - 1)):
            log_stats.update(online_knn_eval(args, cfg, ckpt_state.teacher["backbone"], epoch,
                                             step_fn.route, dev))
        del ckpt_state
        if main_process:
            with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
                f.write(json.dumps(log_stats) + "\n")
        print(json.dumps(log_stats), flush=True)

    # the run ended inside the trace window: flush the trace, as JAX does
    profiler.stop()
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    return state


def main(argv=None):
    parser = argparse.ArgumentParser("DINO-SVT (CUDA)", parents=[get_args_parser()])
    train_svt(parser.parse_args(argv))


if __name__ == "__main__":
    main()
