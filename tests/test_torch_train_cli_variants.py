"""The port's train CLI against the JAX CLI (``train_ssl.py`` at the repo
root, in process, seeing one device) on the two variants that need the
other backbones: ``MODEL.TWO_STREAM`` (with ``DATA.NO_FLOW_AUG``: flow
folders beside the videos, two flow frames a step from ``RandomState(seed
+ 1)``, ViT-S motion nets) and ``MODEL.CNN_DISTILL`` with
``--pretrained_cnn`` (a CoCLR checkpoint) and ``--cnn_distill_weight``.

Both CLIs start from the same numpy weights (each package's init is
patched to load them; their own initializers draw from different
generators) and read the same corpus, so one f32 step must print and log
the same numbers: ``log.txt``'s keys, its losses within 1e-5 relative and
its lr / wd exactly (JAX's v5e throughput keys aside); the checkpoint
holds the state's fields. Skipped
where the native decoder is not built."""

import json
import os

import numpy as np
import pytest
import torch

import conftest

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.train import optim as joptim
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch import train_ssl
from dino_video_summarization_transformer_tpu_torch.data import video as vio
from dino_video_summarization_transformer_tpu_torch.models import convert, s3d
from dino_video_summarization_transformer_tpu_torch.train import ssl
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

CFG = os.path.join(conftest.REPO_ROOT, "configs/kinetics/timesformer_divst_8x32_224.yaml")
OUT = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_card(monkeypatch):
    """The JAX CLI sees one device: no data mesh over conftest's eight."""
    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev0])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """JAX's ``tests/test_train_cli.py`` corpus: two videos under
    train_d256 and their flow JPEGs under train_flow."""
    if not vio.native_available():
        pytest.skip("native decoder not built")
    from PIL import Image

    d = tmp_path_factory.mktemp("variant_corpus")
    r = np.random.RandomState(0)
    (d / "train_d256").mkdir()
    for name in ("a", "b"):
        vio.write_video(str(d / "train_d256" / f"{name}.avi"),
                        r.randint(0, 256, (40, 128, 160, 3), np.uint8), fps=30)
        (d / "train_flow" / name).mkdir(parents=True)
        for i in range(6):
            Image.fromarray(r.randint(0, 256, (64, 80, 3), np.uint8)).save(
                str(d / "train_flow" / name / f"{i:03d}.jpg"))
    (d / "train.csv").write_text("train_d256/a.avi 0\ntrain_d256/b.avi 1\n")
    return d


def _argv(d, out, *opts):
    return ["--arch", "vit_tiny", "--cfg", CFG, "--data_path", str(d),
            "--output_dir", str(out), "--batch_size_per_gpu", "2", "--epochs", "1",
            "--warmup_epochs", "0", "--local_crops_number", "2", "--out_dim", str(OUT),
            "--num_workers", "1", "--use_fp16", "false", "--max_steps_per_epoch", "1",
            "--saveckp_freq", "0", "--opts", "DATA.SAMPLING_RATE", "4", *opts]


def _vit_tree(embed_dim, depth, heads, img, frames, seed, video=True):
    """numpy weights in JAX's layout: a TimeSformer's, or a 2D ViT's (no
    temporal half, no time embedding)."""
    from dino_video_summarization_transformer_tpu.models import timesformer as jtsf

    cfg = jtsf.TimeSformerConfig(img_size=img, embed_dim=embed_dim, depth=depth,
                                 num_heads=heads, num_frames=frames, num_classes=0)
    p = jax.tree.map(np.asarray, jsyn.make_numpy_params(cfg, seed=seed))
    if not video:
        for k in ("temporal_norm1", "temporal_attn", "temporal_fc"):
            p["blocks"].pop(k)
        p.pop("time_embed")
    return p


def _dual_head(dim, seed):
    h, a = (make_numpy_head_params(dim, OUT, seed=seed + i) for i in (0, 1))
    return {"mlp": h["mlp"], "aux_mlp": a["mlp"], "last_layer": h["last_layer"],
            "aux_last_layer": a["last_layer"]}


def _run_both(argv_j, argv_p, capsys):
    import train_ssl as jcli

    jcli.train_svt(jcli.get_args_parser().parse_args(argv_j))
    jout = capsys.readouterr().out
    train_ssl.main(["--device", "cpu"] + argv_p)
    return jout, capsys.readouterr().out


def _check_logs(jdir, pdir, keys):
    lj = json.loads((jdir / "log.txt").read_text().splitlines()[-1])
    lp = json.loads((pdir / "log.txt").read_text().splitlines()[-1])
    # JAX logs its v5e MFU; the port logs TFLOP/s on a card only
    tpu = {"achieved_tflops", "mfu_vs_v5e_bf16_peak"}
    assert set(lp) == set(lj) - tpu and keys <= set(lj), (sorted(lp), sorted(lj))
    for k in keys:
        assert abs(lp[k] - lj[k]) <= 1e-5 * abs(lj[k]), (k, lp[k], lj[k])
    assert lp["train_lr"] == pytest.approx(lj["train_lr"], rel=1e-12)
    assert lp["train_wd"] == pytest.approx(lj["train_wd"], rel=1e-12)
    return lp


def test_two_stream_cli_matches_jax(corpus, tmp_path, monkeypatch, one_card, capsys):
    weights = {}

    def numpy_weights(mcfg, motion_cfg):
        if not weights:
            weights.update(
                rgb=_vit_tree(mcfg.embed_dim, mcfg.depth, mcfg.num_heads, mcfg.img_size,
                              mcfg.num_frames, 1),
                head=_dual_head(mcfg.embed_dim, 2),
                motion=_vit_tree(motion_cfg.embed_dim, motion_cfg.depth,
                                 motion_cfg.num_heads, motion_cfg.img_size, 1, 4, video=False),
                mhead=make_numpy_head_params(motion_cfg.embed_dim, OUT, seed=5))
        return weights

    def jax_init(rng, mcfg, motion_cfg, out_dim=OUT, optimizer="adamw", **kw):
        w = numpy_weights(mcfg, motion_cfg)
        student = jax.tree.map(jnp.asarray, {"backbone": w["rgb"], "head": w["head"]})
        motion = jax.tree.map(jnp.asarray, {"backbone": w["motion"], "head": w["mhead"]})
        combined = {"rgb": student, "motion": motion}
        core, mask = joptim.build_optimizer(optimizer, combined)
        z = [jnp.zeros((1, out_dim)) for _ in range(3)]  # three buffers: donated
        return jssl.TwoStreamState(student, jax.tree.map(jnp.copy, student), motion,
                                   jax.tree.map(jnp.copy, motion), *z,
                                   core.init(combined), jnp.zeros((), jnp.int32)), core, mask

    port_init = ssl.init_two_stream_state

    def port_init_numpy(mcfg, motion_cfg, **kw):
        w = numpy_weights(mcfg, motion_cfg)
        kw.update(pretrained_backbone=convert.state_dict_from_jax_params(w["rgb"], mcfg),
                  pretrained_motion=convert.state_dict_from_jax_params(w["motion"], motion_cfg),
                  head_state_dict=convert.head_state_dict_from_jax(w["head"]),
                  motion_head_state_dict=convert.head_state_dict_from_jax(w["mhead"]))
        return port_init(mcfg, motion_cfg, **kw)

    monkeypatch.setattr(jssl, "init_two_stream_state", jax_init)
    monkeypatch.setattr(ssl, "init_two_stream_state", port_init_numpy)
    opts = ("DATA.NUM_FRAMES", "2", "MODEL.TWO_STREAM", "True", "DATA.NO_FLOW_AUG", "True",
            "DATA.CROP_SIZE", "64")
    jout, out = _run_both(_argv(corpus, tmp_path / "jax", *opts),
                          _argv(corpus, tmp_path / "port", *opts), capsys)
    _check_logs(tmp_path / "jax", tmp_path / "port",
                {"train_loss", "train_loss_rgb", "train_loss_flow", "train_loss_cross"})
    assert "Block route: plain (torch.float32)" in out
    ck = torch.load(tmp_path / "port" / "checkpoint", weights_only=False)
    assert set(jssl.TwoStreamState._fields) <= set(ck)
    assert ck["step"] == 1 and ck["motion_student"]["backbone.pos_embed"].shape == (1, 17, 384)
    # resume: the run starts at its last epoch and trains no further
    train_ssl.main(["--device", "cpu"] + _argv(corpus, tmp_path / "port", *opts))
    assert "Resumed from" in capsys.readouterr().out


def test_cnn_distill_cli_matches_jax(corpus, tmp_path, monkeypatch, one_card, capsys):
    """``MODEL.CNN_DISTILL`` with a CoCLR checkpoint (the port's seeded
    S3D, saved in CoCLR's layout), on 5-frame clips (the S3D's shortest:
    T' = 1 after its strides and pools). At weight 0 (the reference: the
    teacher built, no term) both CLIs log the same loss. At weight 0.5 the
    port adds half its distillation term; JAX's CLI raises there (its
    ``jnp.asarray`` of the S3D tree turns the layers' static ``_meta`` into
    arrays its jitted step cannot read: ROADMAP section 3)."""
    cnn = s3d.init_s3d(torch.Generator().manual_seed(3), device="cpu")
    torch.save({"state_dict": {"encoder_q.0." + k: v for k, v in cnn.state_dict().items()}},
               tmp_path / "coclr.pth.tar")
    weights = {}

    def numpy_weights(mcfg):
        if not weights:
            r = np.random.RandomState(6)
            weights.update(
                backbone=_vit_tree(mcfg.embed_dim, mcfg.depth, mcfg.num_heads, mcfg.img_size,
                                   mcfg.num_frames, 7),
                head=make_numpy_head_params(mcfg.embed_dim, OUT, seed=8),
                cnn_proj={"kernel": (0.02 * r.randn(mcfg.embed_dim, 1024)).astype(np.float32),
                          "bias": (0.01 * r.randn(1024)).astype(np.float32)})
        return weights

    def jax_init(rng, mcfg, out_dim=OUT, optimizer="adamw", cnn_distill_dim=0, **kw):
        w = numpy_weights(mcfg)
        student = jax.tree.map(jnp.asarray, {k: w[k] for k in (
            "backbone", "head", "cnn_proj")[:3 if cnn_distill_dim else 2]})
        core, mask = joptim.build_optimizer(optimizer, student)
        return jssl.TrainState(student, jax.tree.map(jnp.copy, student),
                               jnp.zeros((1, out_dim)), core.init(student),
                               jnp.zeros((), jnp.int32)), core, mask

    port_orig = ssl.init_train_state

    def port_init_numpy(mcfg, **kw):
        w = numpy_weights(mcfg)
        kw.update(pretrained_backbone=convert.state_dict_from_jax_params(w["backbone"], mcfg),
                  head_state_dict=convert.head_state_dict_from_jax(w["head"]))
        state, core, mask = port_orig(mcfg, **kw)
        with torch.no_grad():
            for mod in (state.student, state.teacher):
                if "cnn_proj" in mod:
                    mod["cnn_proj"].weight.copy_(torch.from_numpy(w["cnn_proj"]["kernel"].T))
                    mod["cnn_proj"].bias.copy_(torch.from_numpy(w["cnn_proj"]["bias"]))
        return state, core, mask

    monkeypatch.setattr(jssl, "init_train_state", jax_init)
    monkeypatch.setattr(ssl, "init_train_state", port_init_numpy)
    opts = ("DATA.NUM_FRAMES", "5", "MODEL.CNN_DISTILL", "True")
    ckpt = ["--pretrained_cnn", str(tmp_path / "coclr.pth.tar")]
    jout, out = _run_both(ckpt + _argv(corpus, tmp_path / "jax", *opts),
                          ckpt + _argv(corpus, tmp_path / "port", *opts), capsys)
    base = _check_logs(tmp_path / "jax", tmp_path / "port", {"train_loss"})["train_loss"]
    line = f"Loaded CoCLR S3D teacher from {tmp_path / 'coclr.pth.tar'}"
    assert line in jout and line in out
    w = ["--cnn_distill_weight", "0.5"]
    train_ssl.main(["--device", "cpu"] + w + ckpt + _argv(corpus, tmp_path / "port_w", *opts))
    rec = json.loads((tmp_path / "port_w" / "log.txt").read_text().splitlines()[-1])
    term = (rec["train_loss"] - base) / 0.5
    assert 1e-3 < term < 2.0, term  # 1 - cos of the projected and S3D features
    ck = torch.load(tmp_path / "port_w" / "checkpoint", weights_only=False)
    assert ck["student"]["cnn_proj.weight"].shape == (1024, 192)
    import train_ssl as jcli

    with pytest.raises(jax.errors.ConcretizationTypeError):
        jcli.train_svt(jcli.get_args_parser().parse_args(
            w + ckpt + _argv(corpus, tmp_path / "jax_w", *opts)))
