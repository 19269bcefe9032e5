"""Per-frame DINO importance scoring CLI on the card
(ref: dino_similarity.py:138-191; counterpart of the repo root's
``dino_similarity.py``, with the same flag set).

    python -m dino_video_summarization_transformer_tpu_torch.dino_similarity \\
        --cfg configs/kinetics/timesformer_divst_8x32_224.yaml \\
        --pretrained_weights checkpoints/kinetics400_vitb_ssl.pth \\
        --precision bfloat16 --batch_size_per_gpu 8 \\
        --opts DATA.PATH_TO_DATA_DIR /data/msvd DATA.PATH_PREFIX /data/msvd/videos

The approximation flags of the JAX CLI are accepted but not ported yet: any
of them away from its default raises NotImplementedError naming the ROADMAP
item. ``--device`` defaults to ``cuda``. Without ``--pretrained_weights``
the model gets numpy-seeded random weights (``utils/synthetic.py``, seed
``RNG_SEED``).
"""

import argparse

from .config import load_config
from .utils.misc import bool_flag

# flag -> (default, ROADMAP item that ports it)
UNPORTED_FLAGS = {
    "global_subsample": (1, "scorer approximation knobs"),
    "teacher_stride": (1, "scorer approximation knobs"),
    "teacher_interp": ("linear", "scorer approximation knobs"),
    "teacher_adaptive": (0.0, "scorer approximation knobs"),
    "teacher_refine": (0.0, "scorer approximation knobs"),
    "score_stride": (1, "scorer approximation knobs"),
    "score_refine": (0.0, "scorer approximation knobs"),
    "teacher_precision": ("same", "mixed teacher (teacher_dtype=f32)"),
    "band": ("none", "banded one-pass scoring"),
    "student_quant": ("none", "int8 tiers"),
    "teacher_quant": ("none", "int8 tiers"),
    "wire_format": ("rgb8", "yuv420 wire"),
}


def get_args_parser():
    # flag set mirrors the reference CLI (ref: dino_similarity.py:140-183)
    p = argparse.ArgumentParser("Per-frame DINO similarity scoring (CUDA)")
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--avgpool_patchtokens", default=False, type=bool_flag)
    p.add_argument("--arch", default="vit_base", type=str,
                   choices=["vit_tiny", "vit_small", "vit_base", "swin", "timesformer"])
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default=None, type=str)
    p.add_argument("--batch_size_per_gpu", default=8, type=int,
                   help="frames scored per device step (chunk size)")
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--data_path", default="", type=str)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default="configs/kinetics/timesformer_divst_8x32_224.yaml")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--out_dim", default=768, type=int)
    p.add_argument("--local_clip_size", default=3, type=int)
    p.add_argument("--global_clip_size", default=30, type=int)
    p.add_argument("--sampling_rate", default=4, type=int)
    p.add_argument("--file_path", default="loss_values/loss_kinetics_test_4_3_30.json")
    p.add_argument("--shard_id", default=0, type=int)
    p.add_argument("--num_shards", default=1, type=int)
    p.add_argument("--precision", default="float32",
                   choices=["float32", "bfloat16"],
                   help="float32 = reference-compat numerics (TF32 off); "
                        "bfloat16 = the Hopper kernels")
    p.add_argument("--global_subsample", default=1, type=int)
    p.add_argument("--teacher_stride", default=1, type=int)
    p.add_argument("--teacher_interp", default="linear",
                   choices=["linear", "catmullrom"])
    p.add_argument("--teacher_precision", default="same",
                   choices=["same", "float32"])
    p.add_argument("--teacher_adaptive", default=0.0, type=float)
    p.add_argument("--teacher_refine", default=0.0, type=float)
    p.add_argument("--score_stride", default=1, type=int)
    p.add_argument("--score_refine", default=0.0, type=float)
    p.add_argument("--band", default="none", choices=["none", "both", "teacher"])
    p.add_argument("--student_quant", default="none", choices=["none", "int8"])
    p.add_argument("--teacher_quant", default="none", choices=["none", "int8"])
    p.add_argument("--wire_format", default="rgb8",
                   choices=["rgb8", "yuv420", "yuv420q"])
    p.add_argument("--local_devices", default=1, type=int,
                   help="score with N local cards from this one process "
                        "(0 = all): videos are dealt round-robin to "
                        "per-card scorer replicas")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def check_unported(cli) -> None:
    for flag, (default, item) in UNPORTED_FLAGS.items():
        if getattr(cli, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(cli, flag)!r}: not ported to the CUDA "
                f"package yet (ROADMAP: {item})")


def dino_similarity(cli, local_clip_size, global_clip_size, sampling_rate,
                    file_path):
    """(ref: dino_similarity.py:16-93)."""
    import torch

    from .data.datasets import DinoLossDataset
    from .engine.scoring import make_scorers, run_scoring
    from .models import convert
    from .models.timesformer import config_from_cfg
    from .utils.synthetic import make_numpy_params

    check_unported(cli)
    config = load_config(cli)
    mcfg = config_from_cfg(config, no_head=True, arch=cli.arch)
    if cli.pretrained_weights:
        sd = convert.convert_svt_checkpoint(
            cli.pretrained_weights, mcfg, checkpoint_key=cli.checkpoint_key)
    else:
        print("WARNING: no --pretrained_weights; scoring with random init")
        sd = convert.state_dict_from_jax_params(
            make_numpy_params(mcfg, seed=config.RNG_SEED), mcfg)

    dataset = DinoLossDataset(
        cfg=config, mode="test", local_clip_size=local_clip_size,
        global_clip_size=global_clip_size, sampling_rate=sampling_rate)
    bf16 = cli.precision == "bfloat16"
    scorer = make_scorers(
        sd, mcfg, n_devices=cli.local_devices, device=cli.device,
        local_size=local_clip_size, global_size=global_clip_size,
        chunk=cli.batch_size_per_gpu,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        precision=None if bf16 else "highest")
    run_scoring(dataset, scorer, file_path, num_workers=cli.num_workers,
                shard_id=cli.shard_id, num_shards=cli.num_shards)


def main(argv=None):
    cli = get_args_parser().parse_args(argv)
    dino_similarity(cli, cli.local_clip_size, cli.global_clip_size,
                    cli.sampling_rate, cli.file_path)


if __name__ == "__main__":
    main()
