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

The variants of the JAX CLI that need no other backbone: ``--two_token``
or ``MODEL.TWO_TOKEN`` (the aux-token backbone and the 6-view protocol,
on the plain route), ``DATA.RAND_FR`` (variable-frame-count crops, one
forward per frame-count group), ``--use_remat`` (rematerialized student
forwards) and ``--profile_dir`` (a ``torch.profiler`` Chrome trace of
steps ``--profile_start_step`` to ``+ --profile_steps``, also written when
the run stops on a non-finite loss).

The online kNN hook (``--knn_eval_freq`` N with ``--knn_data_path``):
every N epochs and after the last, the teacher backbone's f32 features of
the ``--knn_dataset`` train and val splits, a ``--nb_knn`` vote, and
``knn_top1`` / ``knn_top5`` in the epoch's ``log.txt`` line. The teacher
runs its training forward in f32 under ``torch.no_grad``, on the train
step's route: the kernel route's f32 tiers (rows 1f, 4f and 3f) where the
step runs the kernels, as JAX's hook runs ``use_fused`` at f32.

Flags of the variants that are not ported (two-stream, CNN distillation,
the parallel strategies) raise ``NotImplementedError`` unless they are at
their defaults, as do configs that select those variants.
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

from .utils.misc import bool_flag

SYNC_EVERY = 10

# flag -> (default, what it selects)
UNPORTED_FLAGS = {
    "pretrained_motion": (None, "the two-stream trainer variant"),
    "pretrained_cnn": (None, "the CNN-distillation variant"),
    "cnn_distill_weight": (0.0, "the CNN-distillation variant"),
    "model_parallel": (1, "tensor parallelism (parallelism)"),
    "tp_fused": (False, "tensor parallelism (parallelism)"),
    "zero1": (False, "ZeRO-1 (parallelism)"),
    "pipeline": (1, "pipeline parallelism (parallelism)"),
    "seq_parallel": (1, "sequence parallelism (parallelism)"),
    "num_shards": (1, "multi-process data parallelism (parallelism)"),
}
UNPORTED_CFG = ("MODEL.TWO_STREAM", "MODEL.CNN_DISTILL")


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


def check_unported(args, cfg) -> None:
    for flag, (default, what) in UNPORTED_FLAGS.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)!r}: {what} is not ported to "
                "the CUDA package yet (ROADMAP)")
    for key in UNPORTED_CFG:
        node, name = key.split(".")
        if getattr(getattr(cfg, node), name):
            raise NotImplementedError(f"{key}: the trainer variant it selects "
                                      "is not ported yet (ROADMAP)")


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
    from .models.timesformer import config_from_cfg
    from .train.dino import teacher_temp_schedule
    from .train.ssl import (build_schedules, init_train_state,
                            make_rand_fr_train_step, make_train_step)
    from .utils.checkpoint import restore_checkpoint, save_checkpoint
    from .utils.device import resolve_device
    from .utils.flops import train_step_flops

    cfg = load_config(args)
    check_unported(args, cfg)
    set_data_path(cfg, args.data_path)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    print("\n".join(f"{k}: {v}" for k, v in sorted(dict(vars(args)).items())))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)

    # ---------------- data -------------------------------------------------
    two_token = args.two_token or cfg.MODEL.TWO_TOKEN
    rand_fr = cfg.DATA.RAND_FR
    if two_token and args.knn_eval_freq:
        raise NotImplementedError(
            "--knn_eval_freq with the two-token variant: JAX's hook runs the "
            "one-token forward on the two-token backbone; the port does not "
            "(ROADMAP section 3)")
    dataset = ClipDataset(cfg, "train", temporal_aug=not two_token,
                          two_token=two_token, rand_fr=rand_fr, seed=args.seed)
    per_host = args.batch_size_per_gpu
    n_local = 2 if two_token else args.local_crops_number
    idx = shard_indices(len(dataset), 0, 1, shuffle=True, seed=args.seed,
                        drop_last=True)
    niter_per_ep = max(len(idx) // per_host, 1)
    print(f"Data loaded: {len(dataset)} videos, {niter_per_ep} it/epoch.")

    def collate(items):
        """The step's crops: views stacked view-major, as the reference's
        multi-crop wrapper concatenates them (ref: utils/utils.py:582-609)."""
        def views(sel):
            return torch.from_numpy(np.concatenate(
                [np.stack([it[c] for it in items]) for c in sel])).to(
                    dev, non_blocking=True)

        if two_token:
            # teacher [v0, v1]; student ([v2, v3] at 96 px, [v4, v5] at 224)
            # (ref: transform.py:738-743)
            return views((0, 1)), (views((2, 3)), views((4, 5)))
        if rand_fr:
            # the vary_fr groups [1, 2, 4, 6, 8, 10] (ref: utils/utils.py:583-588)
            return (tuple(views(sel) for sel in
                          ((0,), (1,), (2, 3), (4, 5), (6, 7), (8, 9))),)
        return views(range(2)), views(range(2, 2 + n_local))

    def batches(epoch):
        order = shard_indices(len(dataset), 0, 1, shuffle=True,
                              seed=args.seed + epoch, drop_last=True)
        items = []
        for item in PrefetchLoader(dataset, indices=order,
                                   num_workers=args.num_workers):
            items.append(item[0])
            if len(items) == per_host:
                yield collate(items)
                items = []

    # ---------------- model ------------------------------------------------
    mcfg = config_from_cfg(cfg, no_head=True, arch=args.arch)
    backbone_sd = None
    if args.pretrained_rgb:
        backbone_sd = convert.convert_svt_checkpoint(
            args.pretrained_rgb, mcfg, checkpoint_key="teacher")
        print(f"Loaded pretrained RGB backbone from {args.pretrained_rgb}")
    compute_dtype = torch.bfloat16 if args.use_fp16 else torch.float32
    state, core, mask = init_train_state(
        mcfg, out_dim=args.out_dim, optimizer=args.optimizer, seed=args.seed,
        pretrained_backbone=backbone_sd, device=dev, two_token=two_token)
    if rand_fr:
        step_fn = make_rand_fr_train_step(mcfg, core, mask, clip_grad=args.clip_grad,
                                          compute_dtype=compute_dtype)
    else:
        step_fn = make_train_step(mcfg, core, mask, n_local_crops=n_local,
                                  clip_grad=args.clip_grad,
                                  compute_dtype=compute_dtype,
                                  remat=args.use_remat, two_token=two_token)
    print(f"Block route: {step_fn.route} ({compute_dtype})")

    # ---------------- schedules --------------------------------------------
    lr_sched, wd_sched, mom_sched = build_schedules(args, niter_per_ep)
    tt_sched = teacher_temp_schedule(
        args.warmup_teacher_temp, args.teacher_temp,
        args.warmup_teacher_temp_epochs, args.epochs)

    # ---------------- resume ------------------------------------------------
    ckpt_path = os.path.join(args.output_dir, "checkpoint")
    restored, run_vars = restore_checkpoint(ckpt_path, state)
    start_epoch = 0
    if restored is not None:
        state = restored
        start_epoch = int(run_vars.get("epoch", 0))
        print(f"Resumed from {ckpt_path} at epoch {start_epoch}")

    if rand_fr or two_token:
        step_flops = 0.0  # mixed-geometry steps: no analytic model, as in JAX
    else:
        step_flops = train_step_flops(mcfg, per_host, n_local_crops=n_local,
                                      local_size_px=96)

    # ---------------- train loop -------------------------------------------
    profiler = StepProfiler(args.profile_dir, args.profile_start_step,
                            args.profile_steps, dev)
    start_time = time.time()
    for epoch in range(start_epoch, args.epochs):
        sums = {"loss": 0.0, "lr": 0.0, "wd": 0.0}
        count = 0
        pending = []  # (global step, loss tensor): drained every SYNC_EVERY

        def drain():
            nonlocal count
            for gi, loss in pending:
                v = float(loss)
                if not math.isfinite(v):
                    print(f"Loss is {v}, stopping training", flush=True)
                    profiler.stop()  # flush the profile of the dying run
                    sys.exit(1)
                sums["loss"] += v
                sums["lr"] += float(lr_sched[gi])
                sums["wd"] += float(wd_sched[gi])
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
            pending.append((gi, metrics["loss"]))
            steps_done += 1
            if len(pending) >= SYNC_EVERY:
                drain()
            if it % 10 == 0:
                print(f"Epoch: [{epoch}/{args.epochs}] [{it}/{niter_per_ep}]",
                      flush=True)
        drain()
        epoch_dt = time.time() - epoch_t0

        save_checkpoint(ckpt_path, state, {"epoch": epoch + 1})
        if args.saveckp_freq and epoch % args.saveckp_freq == 0:
            save_checkpoint(os.path.join(args.output_dir, f"checkpoint{epoch:04d}"),
                            state, {"epoch": epoch + 1})
        log_stats = {f"train_{k}": v / max(count, 1) for k, v in sums.items()}
        log_stats["epoch"] = epoch
        if step_flops and steps_done and dev.type == "cuda":
            log_stats["achieved_tflops"] = round(
                step_flops * steps_done / epoch_dt / 1e12, 2)
        if (args.knn_eval_freq and args.knn_data_path
                and (epoch % args.knn_eval_freq == 0 or epoch == args.epochs - 1)):
            log_stats.update(online_knn_eval(args, cfg, state.teacher["backbone"], epoch,
                                             step_fn.route, dev))
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
