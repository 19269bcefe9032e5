"""TimeSformer classification finetuning on adaptively selected frames
(ref: timesformer_finetuning.py:13-104; counterpart of the repo root's
``timesformer_finetuning.py``, with the same flags plus ``--device``).

    python -m dino_video_summarization_transformer_tpu_torch.timesformer_finetuning \\
        --model_path hf_timesformer_k400/ --train_loss_file train.json \\
        --val_loss_file val.json --data_path /data/k400

The experiment of the reference: 16 adaptively selected frames per clip, 5
epochs, batch 4, AdamW with linear warmup and decay, per-epoch eval,
``training_log_history.json``, the parameters as ``finetuned_params.npz``
under the JAX package's ``/``-joined pytree keys, and the loss plot where
matplotlib imports. The step runs the plain f32 route (``--precision
bfloat16`` rounds the pixels to bf16 first), as the JAX CLI's.
"""

import argparse
import os


def get_args_parser():
    p = argparse.ArgumentParser("TimeSformer finetuning on selected frames (CUDA)")
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--model_path", required=True, type=str)
    p.add_argument("--model_format", default="hf", choices=["hf", "svt"])
    p.add_argument("--train_loss_file", required=True, type=str)
    p.add_argument("--val_loss_file", required=True, type=str)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--output_dir", default="timesformer_finetuning_out", type=str)
    p.add_argument("--num_train_epochs", default=5, type=int)
    p.add_argument("--per_device_train_batch_size", default=4, type=int)
    p.add_argument("--warmup_steps", default=500, type=int)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--learning_rate", default=5e-5, type=float)
    p.add_argument("--pre_sampling_rate", default=4, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--num_labels", default=400, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--precision", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--max_steps_per_epoch", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def finetuning(args):
    import numpy as np
    import torch

    from .config import load_config, set_data_path
    from .data.datasets import FrameSelectionDataset
    from .engine.classification import finetune
    from .models import convert, timesformer as tsf
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    config = load_config(args)
    config.DATASET = "Kinetics"
    set_data_path(config, args.data_path)

    mcfg = tsf.TimeSformerConfig(
        img_size=224, num_frames=args.num_frames, num_classes=args.num_labels,
        attention_type=config.TIMESFORMER.ATTENTION_TYPE)
    if args.model_format == "hf":
        sd = convert.convert_hf_timesformer(args.model_path, mcfg)
    else:
        sd = convert.convert_svt_checkpoint(args.model_path, mcfg)
    model = tsf.build_timesformer(mcfg, sd, device=dev).train()

    config.LOSS_FILE = args.train_loss_file
    dataset_train = FrameSelectionDataset(
        config, pre_sampling_rate=args.pre_sampling_rate,
        selection_method="adaptive", num_frames=args.num_frames,
        augmentations=True, return_type="Dict", mode="train")
    print(f"Loaded dataset of length: {len(dataset_train)}")

    config.LOSS_FILE = args.val_loss_file
    dataset_val = FrameSelectionDataset(
        config, pre_sampling_rate=args.pre_sampling_rate,
        selection_method="adaptive", num_frames=args.num_frames,
        augmentations=False, return_type="Dict", mode="val")
    print(f"Loaded dataset of length: {len(dataset_val)}")

    model, log_history = finetune(
        dataset_train, dataset_val, model, output_dir=args.output_dir,
        num_epochs=args.num_train_epochs,
        batch_size=args.per_device_train_batch_size,
        lr=args.learning_rate, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, num_workers=args.num_workers,
        compute_dtype=torch.bfloat16 if args.precision == "bfloat16" else torch.float32,
        max_steps_per_epoch=args.max_steps_per_epoch)

    # the finetuned parameters + the loss plot (ref: timesformer_finetuning.py:85-104)
    params = convert.jax_params_from_state_dict(
        {k: v.detach().cpu() for k, v in model.state_dict().items()}, mcfg)
    np.savez(os.path.join(args.output_dir, "finetuned_params.npz"),
             **{"/".join(map(str, path)): np.asarray(leaf)
                for path, leaf in convert.flatten_params(params)})
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        train_loss = [e["loss"] for e in log_history if "loss" in e]
        val_loss = [e["eval_loss"] for e in log_history if "eval_loss" in e]
        plt.plot(train_loss, label="Training Loss")
        plt.plot(val_loss, label="Validation Loss")
        plt.xlabel("Epochs")
        plt.ylabel("Loss")
        plt.title("Training vs Validation Loss")
        plt.legend()
        plt.savefig(os.path.join(args.output_dir, "finetuning_loss.png"))
    except Exception as e:  # the JAX CLI's own guard: the plot is optional
        print(f"plotting skipped: {e}")
    return model


def main(argv=None):
    return finetuning(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
