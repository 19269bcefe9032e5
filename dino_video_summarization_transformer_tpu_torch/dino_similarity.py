"""Per-frame DINO importance scoring CLI on the card
(ref: dino_similarity.py:138-191; counterpart of the repo root's
``dino_similarity.py``, with the same flag set).

    python -m dino_video_summarization_transformer_tpu_torch.dino_similarity \\
        --cfg configs/kinetics/timesformer_divst_8x32_224.yaml \\
        --pretrained_weights checkpoints/kinetics400_vitb_ssl.pth \\
        --precision bfloat16 --batch_size_per_gpu 8 \\
        --opts DATA.PATH_TO_DATA_DIR /data/msvd DATA.PATH_PREFIX /data/msvd/videos

``--band both|teacher`` runs banded one-pass scoring (``band_mode``;
``engine/scoring.py``): "both" scores every frame from one banded teacher
and one banded student pass per segment, "teacher" keeps the exact windowed
students against banded teacher rows; in bf16 on the card both run the
banded Hopper kernels. ``--teacher_precision float32`` runs the teacher
forward in f32 while the students keep ``--precision`` (the mixed teacher,
``teacher_dtype=torch.float32``: with ``--precision bfloat16`` on the card,
through the kernels' f32 tiers, on exact windows and with ``--band``).
``--wire_format yuv420`` decodes straight to
packed I420 (the codec's planar 4:2:0, half the bytes of RGB) and the card
unpacks, colour-converts and normalizes the frames in its view gathers
(``ops/wire.py``); ``yuv420q`` further box-averages the chroma to 1/8
resolution per axis (experimental); ``rgb8`` (the default) ships
normalized floats as before. ``--teacher_quant int8`` / ``--student_quant
int8`` quantize the teacher's / the students' dense block weights (W8A8,
``ops/quant.py``; in bf16 on the card the int8 tier of the whole-block
kernels, s8 wgmma GEMMs; with ``--teacher_precision float32`` the int8
teacher takes their f32 tier). With ``--band`` they run on the plain route
only (``--precision float32`` or ``--device cpu``), as JAX runs banded int8
on its XLA route only: in bfloat16 on the card they raise
NotImplementedError. The approximation flags are the JAX CLI's
(``--global_subsample``, ``--teacher_stride``, ``--teacher_interp``,
``--teacher_adaptive``, ``--teacher_refine``, ``--score_stride``,
``--score_refine``; ``engine/scoring.py``): e.g. JAX's default bench mode
``turbo2e-mt`` is ``--precision bfloat16 --teacher_precision float32
--teacher_stride 8 --teacher_interp catmullrom --teacher_refine 0.035``.
With ``--band`` they raise ValueError. ``--device`` defaults to ``cuda``.
Without ``--pretrained_weights`` the model gets numpy-seeded random weights
(``utils/synthetic.py``, seed ``RNG_SEED``).
"""

import argparse

from .config import load_config
from .utils.misc import bool_flag

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
                   choices=["same", "float32"],
                   help="float32 runs the teacher forward with f32 "
                        "activations while the students keep --precision "
                        "(the mixed teacher; exact windows and --band)")
    p.add_argument("--teacher_adaptive", default=0.0, type=float)
    p.add_argument("--teacher_refine", default=0.0, type=float)
    p.add_argument("--score_stride", default=1, type=int)
    p.add_argument("--score_refine", default=0.0, type=float)
    p.add_argument("--band", default="none", choices=["none", "both", "teacher"])
    p.add_argument("--student_quant", default="none", choices=["none", "int8"])
    p.add_argument("--teacher_quant", default="none", choices=["none", "int8"])
    p.add_argument("--wire_format", default="rgb8",
                   choices=["rgb8", "yuv420", "yuv420q"],
                   help="host->device frame transport: yuv420 ships the "
                        "codec's own planar 4:2:0 (half the bytes) and "
                        "color-converts on device; yuv420q further "
                        "box-averages chroma to 1/8 resolution per axis "
                        "(~1.03 B/px) — EXPERIMENTAL, measured far above "
                        "the quality floor on the synthetic validators "
                        "(BENCH.md: The wire); revalidate before use")
    p.add_argument("--local_devices", default=1, type=int,
                   help="score with N local cards from this one process "
                        "(0 = all): videos are dealt round-robin to "
                        "per-card scorer replicas")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def check_unported(cli) -> None:
    """The combination the scorer refuses, before any loading: ``--band``
    with an int8 tier where the scorer takes the kernel route
    (``--precision bfloat16`` on a card); on ``--device cpu`` or in f32 it
    runs on the plain route, as in JAX."""
    if (cli.band != "none" and "int8" in (cli.teacher_quant, cli.student_quant)
            and cli.precision == "bfloat16" and cli.device != "cpu"):
        from .models.banded import BANDED_INT8_KERNELS

        raise NotImplementedError(
            f"--band with an int8 tier in bfloat16 on the card: {BANDED_INT8_KERNELS}; "
            "score it with --precision float32 or --device cpu")


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
        global_clip_size=global_clip_size, sampling_rate=sampling_rate,
        wire_format=cli.wire_format)
    bf16 = cli.precision == "bfloat16"
    scorer = make_scorers(
        sd, mcfg, n_devices=cli.local_devices, device=cli.device,
        local_size=local_clip_size, global_size=global_clip_size,
        chunk=cli.batch_size_per_gpu,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        precision=None if bf16 else "highest",
        global_subsample=cli.global_subsample,
        teacher_stride=cli.teacher_stride, score_stride=cli.score_stride,
        teacher_interp=cli.teacher_interp,
        teacher_adaptive=cli.teacher_adaptive,
        teacher_refine=cli.teacher_refine,
        score_refine=cli.score_refine,
        band_mode=None if cli.band == "none" else cli.band,
        teacher_dtype=(torch.float32 if cli.teacher_precision == "float32"
                       else None),
        teacher_quant=None if cli.teacher_quant == "none" else cli.teacher_quant,
        student_quant=None if cli.student_quant == "none" else cli.student_quant,
        wire_format=cli.wire_format if cli.wire_format != "rgb8" else "yuv420")
    approx = (cli.global_subsample > 1 or cli.teacher_stride > 1
              or cli.score_stride > 1 or cli.teacher_adaptive > 0
              or cli.teacher_refine > 0 or cli.wire_format != "rgb8"
              or cli.band != "none" or cli.teacher_quant != "none"
              or cli.student_quant != "none")
    if approx and not bf16:
        print("NOTE: approximation/wire flags change scores; "
              "f32 bit-parity does not apply")
    run_scoring(dataset, scorer, file_path, num_workers=cli.num_workers,
                shard_id=cli.shard_id, num_shards=cli.num_shards)


def main(argv=None):
    cli = get_args_parser().parse_args(argv)
    dino_similarity(cli, cli.local_clip_size, cli.global_clip_size,
                    cli.sampling_rate, cli.file_path)


if __name__ == "__main__":
    main()
