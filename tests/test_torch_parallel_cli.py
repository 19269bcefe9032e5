"""The port's train CLI over a world of 2 ranks (``parallel.launch``:
each rank runs ``train_ssl.main`` under a gloo process group, as torchrun
would start it) against the JAX CLI (``train_ssl.py`` at the repo root,
in process, its device count set to 2 so its mesh spans two devices),
from the same numpy weights and corpus, at the same global batch
(``--batch_size_per_gpu 2`` on both sides).

* ``--model_parallel 2 --tp_fused true`` in bf16 (ViT-S: 6 heads, 3 a
  shard, Dq 192): the port runs the head-sharded per-phase ops (their
  twins on the CPU); JAX's CLI runs its XLA TP route, since its
  ``fuse_tp`` gate takes the kernels on a TPU only. The logged loss
  within 2e-3 relative (JAX's bound for its TP-fused step against the
  plain one), lr and wd exactly.
* ``--zero1 true`` in f32: the logged loss within 1e-5 relative (the
  port's single-card CLI bound against JAX's), lr and wd exactly.
* The TP-fused run's checkpoint is the single-card layout: the one-card
  CLI resumes it for a second epoch, and a TP world (plain route) resumes
  that for a third, cutting its shards anew.
* Refusals: JAX's group and variant rules (``parallel_plan``),
  ``--num_shards`` beyond the world.

Skipped where the native decoder is not built.
"""

import json
import os
import shutil

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
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.parallel import launch, worlds
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

CFG = os.path.join(conftest.REPO_ROOT, "configs/kinetics/timesformer_divst_8x32_224.yaml")
OUT = 256
MODULE = "dino_video_summarization_transformer_tpu_torch.train_ssl"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def two_devices(monkeypatch):
    """The JAX CLI sees two devices: its mesh spans them."""
    devs = jax.devices()[:2]
    monkeypatch.setattr(jax, "device_count", lambda *a: 2)
    monkeypatch.setattr(jax, "local_device_count", lambda *a: 2)
    monkeypatch.setattr(jax, "devices", lambda *a: devs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not vio.native_available():
        pytest.skip("native decoder not built")
    d = tmp_path_factory.mktemp("parallel_corpus")
    r = np.random.RandomState(0)
    (d / "train_d256").mkdir()
    for name in ("a", "b", "c", "e"):
        vio.write_video(str(d / "train_d256" / f"{name}.avi"),
                        r.randint(0, 256, (40, 128, 160, 3), np.uint8), fps=30)
    (d / "train.csv").write_text("".join(f"train_d256/{n}.avi {i % 2}\n"
                                         for i, n in enumerate("abce")))
    return d


@pytest.fixture(scope="module")
def weights():
    """ViT-S (the CLI's ``--arch vit_small``, frames and size as the
    flags below set them) and a head, in JAX's layout and the port's."""
    from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

    kw = dict(img_size=32, embed_dim=384, depth=12, num_heads=6, num_frames=2, num_classes=0)
    backbone = jax.tree.map(np.asarray, jsyn.make_numpy_params(jtsf.TimeSformerConfig(**kw),
                                                               seed=5))
    head = make_numpy_head_params(384, OUT, seed=6)
    return {"jax": {"backbone": backbone, "head": head},
            "port": {"backbone": convert.state_dict_from_jax_params(
                backbone, tsf.TimeSformerConfig(**kw)),
                "head": convert.head_state_dict_from_jax(head)}}


def _argv(d, out, *flags, fp16=False, epochs=1):
    return ["--arch", "vit_small", "--cfg", CFG, "--data_path", str(d),
            "--output_dir", str(out), "--batch_size_per_gpu", "2", "--epochs", str(epochs),
            "--warmup_epochs", "0", "--local_crops_number", "2", "--out_dim", str(OUT),
            "--num_workers", "1", "--use_fp16", str(fp16).lower(),
            "--max_steps_per_epoch", "1", "--saveckp_freq", "0", *flags,
            "--opts", "DATA.SAMPLING_RATE", "4", "DATA.NUM_FRAMES", "2",
            "DATA.TRAIN_CROP_SIZE", "32"]


def _jax_cli(monkeypatch, weights, argv):
    """The JAX CLI in process; its checkpoint (no check reads it) is
    deleted after the run to keep the tests' disk footprint small."""
    import train_ssl as jcli

    def jax_init(rng, mcfg, out_dim=OUT, optimizer="adamw", **kw):
        student = jax.tree.map(jnp.asarray, weights["jax"])
        core, mask = joptim.build_optimizer(optimizer, student)
        return jssl.TrainState(student, jax.tree.map(jnp.copy, student),
                               jnp.zeros((1, out_dim)), core.init(student),
                               jnp.zeros((), jnp.int32)), core, mask

    monkeypatch.setattr(jssl, "init_train_state", jax_init)
    args = jcli.get_args_parser().parse_args(argv)
    jcli.train_svt(args)
    ckpt = os.path.join(args.output_dir, "checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)


def _port_world(weights, argv):
    launch.run_world(worlds.run_main, 2, MODULE, ["--device", "cpu"] + argv,
                     weights["port"])


def _last_log(d):
    return json.loads((d / "log.txt").read_text().splitlines()[-1])


def _check(jdir, pdir, rtol):
    lj, lp = _last_log(jdir), _last_log(pdir)
    assert abs(lp["train_loss"] - lj["train_loss"]) <= rtol * abs(lj["train_loss"]), \
        (lp["train_loss"], lj["train_loss"])
    assert lp["train_lr"] == pytest.approx(lj["train_lr"], rel=1e-12)
    assert lp["train_wd"] == pytest.approx(lj["train_wd"], rel=1e-12)
    return lp


def test_tp_fused_cli_matches_jax_and_resumes_across_layouts(
        corpus, weights, tmp_path, monkeypatch, two_devices, capsys):
    flags = ["--model_parallel", "2", "--tp_fused", "true"]
    _jax_cli(monkeypatch, weights, _argv(corpus, tmp_path / "jax", *flags, fp16=True))
    _port_world(weights, _argv(corpus, tmp_path / "port", *flags, fp16=True))
    _check(tmp_path / "jax", tmp_path / "port", 2e-3)
    capsys.readouterr()
    # the checkpoint is the single-card layout: one card resumes it ...
    ck = torch.load(tmp_path / "port" / "checkpoint", weights_only=False)
    assert ck["student"]["backbone.blocks.0.attn.qkv.weight"].shape == (3 * 384, 384)
    # the head-major permutation moves rows by whole head widths, so the
    # unpermuted teacher (1 - 0.996 of one step from the start) is the
    # start's qkv to a few ulps of lr
    start = weights["port"]["backbone"]["blocks.0.attn.qkv.weight"]
    assert np.abs(ck["teacher"]["backbone.blocks.0.attn.qkv.weight"].float().numpy()
                  - start).max() <= 1e-6
    train_ssl.main(["--device", "cpu"] + _argv(corpus, tmp_path / "port", fp16=True, epochs=2))
    out = capsys.readouterr().out
    assert "Resumed from" in out and "at epoch 1" in out
    assert [json.loads(x)["epoch"] for x in
            (tmp_path / "port" / "log.txt").read_text().splitlines()] == [0, 1]
    # ... and a TP world resumes the one-card checkpoint, cut anew
    _port_world(weights, _argv(corpus, tmp_path / "port", "--model_parallel", "2",
                               fp16=True, epochs=3))
    log = [json.loads(x) for x in (tmp_path / "port" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in log] == [0, 1, 2] and np.isfinite(log[-1]["train_loss"])
    assert torch.load(tmp_path / "port" / "checkpoint", weights_only=False)["step"] == 3
    os.remove(tmp_path / "port" / "checkpoint")  # the disk footprint


def test_zero1_cli_matches_jax(corpus, weights, tmp_path, monkeypatch, two_devices):
    _jax_cli(monkeypatch, weights, _argv(corpus, tmp_path / "jax", "--zero1", "true"))
    _port_world(weights, _argv(corpus, tmp_path / "port", "--zero1", "true"))
    _check(tmp_path / "jax", tmp_path / "port", 1e-5)
    assert json.loads((tmp_path / "port" / "config.json").read_text())["zero1"] is True
    os.remove(tmp_path / "port" / "checkpoint")  # the disk footprint: nothing reads it


def test_cli_refuses_what_jax_refuses(corpus, tmp_path):
    """JAX's asserts (its ``train_ssl.py:236-249, 344-350, 419-421``) as
    ValueError, before any rank starts work; ``--num_shards`` beyond the
    world fails fast (one process here)."""
    import argparse

    def plan(local_ranks, two_token=False, rand_fr=False, **flags):
        args = argparse.Namespace(**{**dict(model_parallel=1, pipeline=1, seq_parallel=1,
                                            zero1=False), **flags})
        return train_ssl.parallel_plan(args, two_token, False, rand_fr, local_ranks)

    assert plan(4, model_parallel=2) == 2 and plan(2, zero1=True) == 1
    for kw, match in [(dict(model_parallel=2, zero1=True), "exclusive"),
                      (dict(model_parallel=2, seq_parallel=2), "exclusive"),
                      (dict(model_parallel=4), "must divide"),
                      (dict(model_parallel=2, two_token=True), "plain trainer"),
                      (dict(zero1=True, rand_fr=True), "plain/two_token"),
                      (dict(model_parallel=0), ">= 1")]:
        with pytest.raises(ValueError, match=match):
            plan(2, **kw)
    with pytest.raises(ValueError, match="must divide"):
        train_ssl.main(["--device", "cpu", "--model_parallel", "2"]
                       + _argv(corpus, tmp_path / "b"))
    with pytest.raises(RuntimeError, match="num_shards"):
        train_ssl.main(["--device", "cpu", "--num_shards", "2"] + _argv(corpus, tmp_path / "c"))
