"""kNN evaluation CLI (ref: eval_knn.py:30-250; counterpart of the repo
root's ``eval_knn.py``, with the same flags plus ``--device``).

    python -m dino_video_summarization_transformer_tpu_torch.eval_knn \\
        --pretrained_weights ckpt.pth --checkpoint_key teacher \\
        --dataset ucf101 --data_path /data/ucf101 --num_labels 101

Extracts backbone features of the train and val splits (``build_dataset``,
``TEST.NUM_SPATIAL_CROPS`` 1) with the frozen TimeSformer, then runs the
temperature-weighted kNN classifier for each k of ``--nb_knn``.
``--precision bfloat16`` (the default) on the card runs every block through
the whole-block kernel pair (``timesformer.eval_kernels``); ``--device
cpu`` or ``--precision float32`` takes the plain route. ``--dump_features``
/ ``--load_features`` write / read ``features.npz`` with JAX's keys.
"""

import argparse
import os

from .utils.misc import bool_flag


def get_args_parser():
    # flag set mirrors the reference CLI (ref: eval_knn.py:193-222)
    p = argparse.ArgumentParser("Evaluation with weighted k-NN (CUDA)")
    p.add_argument("--batch_size_per_gpu", default=8, type=int)
    p.add_argument("--nb_knn", default=[10, 20, 100, 200], nargs="+", type=int)
    p.add_argument("--temperature", default=0.07, type=float)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default=None, type=str)
    p.add_argument("--use_cuda", default=True, type=bool_flag,
                   help="kept for CLI parity; --device picks the device")
    p.add_argument("--arch", default="vit_base", type=str)
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--dump_features", default=None, type=str)
    p.add_argument("--load_features", default=None, type=str)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--dist_url", default="env://", type=str)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--dataset", default="ucf101", choices=["ucf101", "hmdb51"])
    p.add_argument("--num_labels", default=101, type=int)
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--precision", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


class ReturnIndexDataset:
    """Wrap a clip dataset to yield (clip, index) (ref: eval_knn.py:181-190)."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx):
        clip, _, _, _ = self.inner[idx]
        return clip, idx


def frozen_backbone(args, mcfg, dev):
    """The no-head backbone of ``--pretrained_weights`` (or a seeded random
    init) in ``--precision``, on the kernel pair where
    ``timesformer.eval_kernels`` admits it."""
    import dataclasses

    import torch

    from .models import convert
    from .models import timesformer as tsf

    if args.pretrained_weights:
        sd = convert.convert_svt_checkpoint(
            args.pretrained_weights, mcfg, checkpoint_key=args.checkpoint_key)
    else:
        print("WARNING: random init (no --pretrained_weights)")
        sd = tsf.init_timesformer(mcfg, torch.Generator().manual_seed(0),
                                  device="cpu").state_dict()
    dtype = torch.bfloat16 if args.precision == "bfloat16" else torch.float32
    kern = tsf.eval_kernels(mcfg, dtype, dev)
    print(f"Backbone route: {'kernels' if kern else 'plain'} ({dtype})")
    return tsf.build_timesformer(dataclasses.replace(mcfg, use_kernels=kern), sd,
                                 device=dev, dtype=dtype)


def extract_feature_pipeline(args):
    """(ref: eval_knn.py:30-91)."""
    import numpy as np

    from .config import load_config, set_data_path
    from .data.datasets import build_dataset
    from .engine.knn import extract_features, l2_normalize
    from .models.timesformer import config_from_cfg
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    config = load_config(args)
    config.TEST.NUM_SPATIAL_CROPS = 1
    set_data_path(config, args.data_path)

    dataset_train = ReturnIndexDataset(
        build_dataset(args.dataset, config, "train", num_retries=10))
    dataset_val = ReturnIndexDataset(
        build_dataset(args.dataset, config, "val", num_retries=10))
    print(f"Data loaded with {len(dataset_train)} train and "
          f"{len(dataset_val)} val videos.")

    model = frozen_backbone(args, config_from_cfg(config, no_head=True, arch=args.arch),
                            dev)
    print("Extracting features for train set...")
    train_features = extract_features(model, dataset_train,
                                      batch_size=args.batch_size_per_gpu,
                                      num_workers=args.num_workers)
    print("Extracting features for val set...")
    test_features = extract_features(model, dataset_val,
                                     batch_size=args.batch_size_per_gpu,
                                     num_workers=args.num_workers)

    train_features = l2_normalize(train_features)
    test_features = l2_normalize(test_features)
    train_labels = np.asarray(dataset_train.inner.labels, np.int64)
    test_labels = np.asarray(dataset_val.inner.labels, np.int64)

    if args.dump_features:
        os.makedirs(args.dump_features, exist_ok=True)
        np.savez(os.path.join(args.dump_features, "features.npz"),
                 trainfeat=train_features, testfeat=test_features,
                 trainlabels=train_labels, testlabels=test_labels)
    return train_features, test_features, train_labels, test_labels


def run(args):
    """Returns {k: (top1, top5)}."""
    import numpy as np

    from .engine.knn import knn_classifier
    from .utils.misc import get_sha

    print(f"git:\n  {get_sha()}\n")
    print("\n".join(f"{k}: {v}" for k, v in sorted(dict(vars(args)).items())))
    if args.load_features:
        z = np.load(os.path.join(args.load_features, "features.npz"))
        train_features, test_features = z["trainfeat"], z["testfeat"]
        train_labels, test_labels = z["trainlabels"], z["testlabels"]
    else:
        (train_features, test_features,
         train_labels, test_labels) = extract_feature_pipeline(args)

    print("Features are ready!\nStart the k-NN classification.")
    results = {}
    for k in args.nb_knn:
        top1, top5 = knn_classifier(
            train_features, train_labels, test_features, test_labels,
            k, args.temperature, num_classes=args.num_labels, device=args.device)
        print(f"{k}-NN classifier result: Top1: {top1}, Top5: {top5}")
        results[k] = (top1, top5)
    return results


def main(argv=None):
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
