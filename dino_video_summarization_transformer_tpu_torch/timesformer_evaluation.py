"""Kinetics-400 selection-quality evaluation CLI
(ref: timesformer_evaluation.py:33-109; counterpart of the repo root's
``timesformer_evaluation.py``, with the same flags plus ``--device``).

    python -m dino_video_summarization_transformer_tpu_torch.timesformer_evaluation \\
        --model_path hf_timesformer_k400/ --loss_file loss.json \\
        --data_path /data/k400 --selection_method adaptive

Selects N frames per video (uniform, or the adaptive CDF quantiles of the
per-frame loss JSON; ``--sharpen`` squares the scores), decodes only the
selected frames, classifies with the port's TimeSformer (an HF checkpoint
directory, ``--model_format hf``, its geometry from ``config.json``; or an
SVT ``.pth``) and logs the running top-1 accuracy, as behind the
reference's ``eval_logs/k400_*.log`` baselines (72.41% uniform / 73.14%
adaptive, BASELINE.md). The model computes in f32; ``--precision
bfloat16`` rounds the pixels to bf16 first (as the JAX CLI does) and, on
the card, runs the blocks on the whole-block kernel pair's f32 tier.
"""

import argparse
import os


def get_args_parser():
    p = argparse.ArgumentParser("Selection-quality K400 evaluation (CUDA)")
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--model_path", required=True, type=str,
                   help="HF Timesformer checkpoint dir/file, or SVT .pth")
    p.add_argument("--model_format", default="hf", choices=["hf", "svt"])
    p.add_argument("--loss_file", default="", type=str,
                   help="per-frame loss JSON (required for adaptive)")
    p.add_argument("--selection_method", default="adaptive",
                   choices=["adaptive", "uniform"])
    p.add_argument("--sharpen", default=False, action="store_true",
                   help="square the loss scores (adaptive_sharp variant)")
    p.add_argument("--pre_sampling_rate", default=4, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--num_labels", default=400, type=int)
    p.add_argument("--dataset", default="Kinetics", type=str)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--log_path", default="eval_logs/k400_eval.log", type=str)
    p.add_argument("--limit", default=0, type=int)
    p.add_argument("--probe_indices", default=False, action="store_true",
                   help="derive selection indices from container metadata "
                        "instead of decoding the whole video")
    p.add_argument("--precision", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def classification_model(args, attention_type: str, dev, compute_dtype):
    """The f32 classifier of ``--model_path``: its geometry from the HF
    ``config.json`` where there is one (depth, heads and width must match
    the checkpoint), its head where the checkpoint has one of the right
    width (JAX's ``forward(use_head=True)`` returns the features
    otherwise); its blocks on the kernel pair's f32 tier where
    ``timesformer.eval_kernels`` admits ``compute_dtype`` on ``dev``."""
    import dataclasses
    import json

    from .models import convert
    from .models import timesformer as tsf

    mcfg = tsf.TimeSformerConfig(img_size=224, num_frames=args.num_frames,
                                 num_classes=args.num_labels,
                                 attention_type=attention_type)
    if args.model_format == "hf":
        hf_cfg_path = os.path.join(args.model_path, "config.json")
        if os.path.isdir(args.model_path) and os.path.exists(hf_cfg_path):
            with open(hf_cfg_path) as f:
                hc = json.load(f)
            mcfg = dataclasses.replace(
                mcfg,
                img_size=hc.get("image_size", 224),
                patch_size=hc.get("patch_size", 16),
                embed_dim=hc.get("hidden_size", 768),
                depth=hc.get("num_hidden_layers", 12),
                num_heads=hc.get("num_attention_heads", 12),
                num_classes=len(hc.get("id2label", {})) or args.num_labels)
        sd = convert.convert_hf_timesformer(args.model_path, mcfg)
    else:
        sd = convert.convert_svt_checkpoint(args.model_path, mcfg)
    if "head.weight" not in sd:
        mcfg = dataclasses.replace(mcfg, num_classes=0)
    mcfg = dataclasses.replace(mcfg, use_kernels=tsf.eval_kernels(mcfg, compute_dtype, dev))
    return tsf.build_timesformer(mcfg, sd, device=dev)


def evaluation(args):
    import torch

    from .config import load_config, set_data_path
    from .data.datasets import FrameSelectionDataset
    from .engine.classification import evaluate_selection
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    config = load_config(args)
    config.DATASET = args.dataset
    set_data_path(config, args.data_path)
    config.LOSS_FILE = args.loss_file or os.path.join(
        "loss_values", "loss_kinetics_test_4_3_30.json")

    compute_dtype = torch.bfloat16 if args.precision == "bfloat16" else torch.float32
    model = classification_model(args, config.TIMESFORMER.ATTENTION_TYPE, dev,
                                 compute_dtype)
    print(f"Classifier route: {'kernels (f32 tier)' if model.cfg.use_kernels else 'plain'}"
          f", pixels in {compute_dtype}")

    dataset = FrameSelectionDataset(
        config, pre_sampling_rate=args.pre_sampling_rate,
        selection_method=args.selection_method, num_frames=args.num_frames,
        augmentations=False, return_type="Indices", mode="test",
        sharpen=args.sharpen, probe_only=args.probe_indices)
    return evaluate_selection(
        dataset, model, num_frames=args.num_frames, log_path=args.log_path,
        compute_dtype=compute_dtype, limit=args.limit or None)


def main(argv=None):
    return evaluation(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
