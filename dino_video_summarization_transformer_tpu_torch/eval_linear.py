"""Linear probe CLI (ref: eval_linear.py:30-359; counterpart of the repo
root's ``eval_linear.py``, with the same flags plus ``--device``).

    python -m dino_video_summarization_transformer_tpu_torch.eval_linear \\
        --pretrained_weights ckpt.pth --dataset ucf101 \\
        --data_path /data/ucf101 --num_labels 101 --output_dir out/lin

A frozen TimeSformer backbone (the kernel pair under ``--precision
bfloat16`` on the card, as ``eval_knn``) and an SGD linear classifier with
per-epoch cosine annealing, single-view validation every ``--val_freq``
epochs, one ``log.txt`` JSON line and ``checkpoint_linear.npz`` (JAX's
``kernel`` (dim, L), ``bias`` and ``epoch``) per epoch, then the
multi-view (``NUM_ENSEMBLE_VIEWS`` x 3 crops) ``TestMeter`` evaluation.
``--lc_pretrained_weights`` evaluates a saved classifier only. The learning
rate scales by the number of cards the port runs on, which is one.
"""

import argparse
import json
import os

from .utils.misc import bool_flag

N_CARDS = 1  # multi-card runs: ROADMAP queue 1 item 8


def get_args_parser():
    # flags mirror the reference CLI (ref: eval_linear.py:323-359)
    p = argparse.ArgumentParser("Linear evaluation (CUDA)")
    p.add_argument("--n_last_blocks", default=1, type=int)
    p.add_argument("--avgpool_patchtokens", default=False, type=bool_flag)
    p.add_argument("--arch", default="vit_base", type=str,
                   choices=["vit_tiny", "vit_small", "vit_base", "swin"])
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--lc_pretrained_weights", default="", type=str,
                   help="eval-only: load a trained linear classifier")
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--batch_size_per_gpu", default=8, type=int)
    p.add_argument("--dist_url", default="env://", type=str)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--val_freq", default=1, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--num_labels", default=101, type=int)
    p.add_argument("--dataset", default="ucf101",
                   choices=["ucf101", "hmdb51", "kinetics400"])
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--precision", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--max_steps_per_epoch", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def _batches(dataset, args, with_index=False):
    """(x, y[, index]) batches of ``--batch_size_per_gpu`` items on the
    device; the last may be short."""
    import numpy as np
    import torch

    from .data.loader import PrefetchLoader

    def collate(items):
        return (np.stack([it[0] for it in items]),
                np.asarray([it[1] for it in items]),
                np.asarray([it[2] for it in items]))

    for x, y, idx in PrefetchLoader(dataset, num_workers=args.num_workers,
                                    batch_size=args.batch_size_per_gpu, collate=collate):
        out = (torch.from_numpy(x).to(args.device), torch.from_numpy(y).to(args.device))
        yield (*out, idx) if with_index else out


def eval_linear(args):
    """(ref: eval_linear.py:30-176). Returns the probe's state."""
    import numpy as np
    import torch

    from .config import load_config, set_data_path
    from .data.datasets import build_dataset
    from .engine.linear import make_linear_probe
    from .engine.meters import MetricLogger
    from .eval_knn import frozen_backbone
    from .models.timesformer import config_from_cfg
    from .utils.device import resolve_device
    from .utils.misc import get_sha

    if args.arch == "swin":
        raise NotImplementedError(
            "--arch swin: the Swin3D backbone is not ported (ROADMAP queue 1 item 7)")
    dev = resolve_device(args.device)
    print(f"git:\n  {get_sha()}\n")
    print("\n".join(f"{k}: {v}" for k, v in sorted(dict(vars(args)).items())))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)

    config = load_config(args)
    config.TEST.NUM_SPATIAL_CROPS = 1
    set_data_path(config, args.data_path)

    ds_name = "kinetics" if args.dataset == "kinetics400" else args.dataset
    dataset_train = build_dataset(ds_name, config, "train", num_retries=10)
    dataset_val = build_dataset(ds_name, config, "val", num_retries=10)
    print(f"Data loaded: {len(dataset_train)} train / {len(dataset_val)} val videos.")

    model = frozen_backbone(args, config_from_cfg(config, no_head=True, arch=args.arch),
                            dev)
    scaled_lr = args.lr * args.batch_size_per_gpu * N_CARDS / 256.0
    print(f"scaled lr {scaled_lr} (lr x batch {args.batch_size_per_gpu} x {N_CARDS} "
          "card / 256)")
    state, train_step, eval_step, epoch_lr = make_linear_probe(
        model, num_labels=args.num_labels, lr=scaled_lr, epochs=args.epochs,
        generator=torch.Generator().manual_seed(0))

    if args.lc_pretrained_weights:
        z = np.load(args.lc_pretrained_weights)
        with torch.no_grad():
            state.head.linear.weight.copy_(torch.from_numpy(z["kernel"].T.copy()))
            state.head.linear.bias.copy_(torch.from_numpy(z["bias"]))
        acc = validate_network(args, state, eval_step, dataset_val)
        print(f"Eval-only accuracy: {acc:.2f}%")
        return state

    B = args.batch_size_per_gpu
    best_acc = 0.0
    for epoch in range(args.epochs):
        lr_t = epoch_lr(epoch)
        logger = MetricLogger(delimiter="  ")
        for it, (x, y) in enumerate(logger.log_every(
                _batches(dataset_train, args), 20, f"Epoch: [{epoch}]")):
            if args.max_steps_per_epoch and it >= args.max_steps_per_epoch:
                break
            if x.shape[0] < B:
                continue  # the tail batch is dropped, as in JAX
            state, loss = train_step(state, x, y, lr_t)
            logger.update(loss=float(loss), lr=lr_t)

        log_stats = {"epoch": epoch, "lr": lr_t,
                     "train_loss": logger.loss.global_avg if "loss" in logger.meters else None}
        if epoch % args.val_freq == 0 or epoch == args.epochs - 1:
            acc = validate_network(args, state, eval_step, dataset_val)
            best_acc = max(best_acc, acc)
            print(f"Accuracy at epoch {epoch}: {acc:.2f}% (best {best_acc:.2f}%)")
            log_stats["val_acc1"] = acc
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(log_stats) + "\n")
        lin = state.head.linear
        np.savez(os.path.join(args.output_dir, "checkpoint_linear.npz"),
                 kernel=lin.weight.detach().cpu().numpy().T,
                 bias=lin.bias.detach().cpu().numpy(), epoch=epoch)

    # final multi-view evaluation (ref: eval_linear.py:264-303)
    config.TEST.NUM_SPATIAL_CROPS = 3
    dataset_test = build_dataset(ds_name, config, "test", num_retries=10)
    stats = validate_network_multi_view(args, state, eval_step, dataset_test, config)
    print(f"Multi-view test: {stats}")
    return state


class _WithIndex:
    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        x, y, _, _ = self.dataset[i]
        return x, y, i


def validate_network(args, state, eval_step, dataset):
    """Single-view top-1 (ref: eval_linear.py:224-261)."""
    correct = total = 0
    for x, y in _batches(dataset, args):
        logits = eval_step(state, x)
        correct += int((logits.argmax(1) == y).sum())
        total += x.shape[0]
    return 100.0 * correct / max(total, 1)


def validate_network_multi_view(args, state, eval_step, dataset, config):
    """Ensemble eval with TestMeter (ref: eval_linear.py:264-303)."""
    from .engine.meters import TestMeter

    num_clips = config.TEST.NUM_ENSEMBLE_VIEWS * config.TEST.NUM_SPATIAL_CROPS
    meter = TestMeter(len(dataset) // num_clips, num_clips, args.num_labels)
    for x, y, idx in _batches(_WithIndex(dataset), args, with_index=True):
        logits = eval_step(state, x)
        meter.update_stats(logits.cpu().numpy(), y.cpu().numpy(), idx)
    return meter.finalize_metrics(ks=(1, 5))


def main(argv=None):
    return eval_linear(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
