"""The port's evaluation CLIs and the train CLI's online kNN hook against
the JAX CLIs, in-process on the CPU at ``--precision float32 --device cpu``
(the JAX CLIs with ``jax.device_count`` seen as 1: one card, no mesh), on
fixtures in the style of ``tests/test_eval_clis.py``:

* ``eval_knn``: the same printed ``k-NN classifier result`` lines, and
  ``features.npz`` with JAX's keys and features within 1e-5;
* ``eval_linear``: the same files (``log.txt`` keys, ``checkpoint_linear.npz``
  keys and shapes, ``Multi-view test``); with ``--lc_pretrained_weights``
  (JAX's trained classifier) the same printed accuracy. The trained heads
  differ: each package draws its own initial head;
* ``timesformer_evaluation``: the same final top-1 line and log line, from a
  tiny HuggingFace checkpoint, adaptive (sharpened, probed indices) and
  uniform;
* ``timesformer_finetuning``: the same ``training_log_history.json`` keys
  and losses (1e-5), ``finetuned_params.npz`` with JAX's keys, each within
  1e-5 x max|JAX's| but for the qkv biases' key thirds (zero gradient in
  exact arithmetic: Adam's steps of float noise, held within 2 x the summed
  learning rates; tests/test_torch_eval_engine.py);
* the online kNN hook: the same printed line as JAX's ``online_knn_eval``
  on the same teacher, and ``knn_top1`` / ``knn_top5`` in the train CLI's
  ``log.txt``.

The clips are made deterministic where both packages draw them at random
from unseeded generators: 224 x 224 frames, jitter scales [224, 224], no
flip, and 12-frame videos shorter than the 16-frame clip window.
Skipped where the native decoder is not built."""

import json
import os

import numpy as np
import pytest
import torch

import conftest

import jax

from dino_video_summarization_transformer_tpu.models import convert as jconvert
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch import (
    eval_knn, eval_linear, timesformer_evaluation, timesformer_finetuning, train_ssl)
from dino_video_summarization_transformer_tpu_torch.data import video as vio

CFG = os.path.join(conftest.REPO_ROOT, "configs/kinetics/timesformer_divst_8x32_224.yaml")
OPTS = ["DATA.NUM_FRAMES", "2", "DATA.SAMPLING_RATE", "8", "TEST.NUM_ENSEMBLE_VIEWS", "1",
        "DATA.TRAIN_JITTER_SCALES", "[224, 224]", "DATA.TEST_CROP_SIZE", "224",
        "DATA.RANDOM_FLIP", "False"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_card(monkeypatch):
    """The JAX CLIs see one device (no data mesh), as the port runs one
    card; conftest's 8 virtual CPU devices are for the sharding tests."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    if not vio.native_available():
        pytest.skip("native decoder not built")
    d = tmp_path_factory.mktemp("ucf_eval")
    r = np.random.RandomState(0)
    rows = []
    for i in range(4):
        vio.write_video(str(d / f"v{i}.avi"), r.randint(0, 256, (12, 224, 224, 3), np.uint8))
        rows.append(f"v{i}.avi {i % 2}")
    for split in ("train", "val", "test"):
        (d / f"ucf101_{split}_split_1_videos.txt").write_text("\n".join(rows) + "\n")
    (d / "train.csv").write_text("\n".join(rows) + "\n")
    jcfg = jtsf.vit_tiny_config(num_frames=8, num_classes=0)
    jconvert.save_reference_checkpoint(
        str(d / "ckpt.pth"), jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=0)),
        jcfg)
    return d


def _common(ucf, *extra):
    return ["--arch", "vit_tiny", "--dataset", "ucf101", "--data_path", str(ucf),
            "--batch_size_per_gpu", "2", "--num_workers", "1", "--num_labels", "2",
            "--pretrained_weights", str(ucf / "ckpt.pth"), "--checkpoint_key", "teacher",
            "--precision", "float32", "--cfg", CFG, *extra, "--opts", *OPTS]


def _lines(out, key):
    return [ln for ln in out.splitlines() if key in ln]


def test_eval_knn_cli_matches_jax(ucf, tmp_path, one_card, capsys):
    import eval_knn as jcli

    jargs = _common(ucf, "--nb_knn", "1", "3", "--dump_features", str(tmp_path / "jax"))
    jcli.main(jcli.get_args_parser().parse_args(jargs))
    want = _lines(capsys.readouterr().out, "-NN classifier result")
    got = eval_knn.main(_common(ucf, "--nb_knn", "1", "3", "--dump_features",
                                str(tmp_path / "port"), "--device", "cpu"))
    out = capsys.readouterr().out
    assert _lines(out, "-NN classifier result") == want and len(want) == 2
    assert "Backbone route: plain (torch.float32)" in out
    assert set(got) == {1, 3}
    zp, zj = (np.load(tmp_path / name / "features.npz") for name in ("port", "jax"))
    assert sorted(zp.files) == sorted(zj.files) == [
        "testfeat", "testlabels", "trainfeat", "trainlabels"]
    for k in zj.files:
        np.testing.assert_allclose(zp[k], zj[k], atol=1e-5, rtol=1e-5, err_msg=k)
    eval_knn.main(["--load_features", str(tmp_path / "jax"), "--nb_knn", "1", "3",
                   "--num_labels", "2", "--device", "cpu"])
    assert _lines(capsys.readouterr().out, "-NN classifier result") == want


def test_eval_linear_cli_matches_jax(ucf, tmp_path, one_card, capsys):
    import eval_linear as jcli

    extra = ("--epochs", "1", "--max_steps_per_epoch", "2")
    jcli.eval_linear(jcli.get_args_parser().parse_args(
        _common(ucf, "--output_dir", str(tmp_path / "jax"), *extra)))
    jout = capsys.readouterr().out
    eval_linear.main(_common(ucf, "--output_dir", str(tmp_path / "port"), "--device", "cpu",
                             *extra))
    out = capsys.readouterr().out
    assert "scaled lr 7.8125e-06" in out
    for o in (out, jout):
        assert len(_lines(o, "Multi-view test: {'split': 'test_final'")) == 1
        assert len(_lines(o, "Accuracy at epoch 0")) == 1
    for name in ("log.txt", "config.json", "checkpoint_linear.npz"):
        assert (tmp_path / "port" / name).exists(), name
    lp, lj = (json.loads((tmp_path / n / "log.txt").read_text()) for n in ("port", "jax"))
    assert sorted(lp) == sorted(lj) and lp["epoch"] == lj["epoch"] == 0
    assert lp["lr"] == lj["lr"]
    zp, zj = (np.load(tmp_path / n / "checkpoint_linear.npz") for n in ("port", "jax"))
    assert sorted(zp.files) == sorted(zj.files) == ["bias", "epoch", "kernel"]
    assert [zp[k].shape for k in zp.files] == [zj[k].shape for k in zp.files]
    # JAX's trained classifier, evaluated by both
    lc = ("--lc_pretrained_weights", str(tmp_path / "jax" / "checkpoint_linear.npz"))
    jcli.eval_linear(jcli.get_args_parser().parse_args(
        _common(ucf, "--output_dir", str(tmp_path / "j2"), *lc)))
    want = _lines(capsys.readouterr().out, "Eval-only accuracy")
    eval_linear.main(_common(ucf, "--output_dir", str(tmp_path / "p2"), "--device", "cpu", *lc))
    assert _lines(capsys.readouterr().out, "Eval-only accuracy") == want and want


def test_eval_linear_cli_swin_matches_jax(ucf, tmp_path, one_card, capsys):
    """``--arch swin`` builds the ViT-B TimeSformer in both CLIs (JAX's
    ``_ARCH_DIMS.get(arch, vit_base)``): a ViT-B checkpoint at 32-px crops;
    a saved 768-wide classifier evaluated by both prints the same accuracy,
    and the port's training run writes JAX's files at ViT-B's width."""
    import eval_linear as jcli

    jcfg = jtsf.vit_base_config(num_frames=8, num_classes=0, img_size=32)
    ckpt = tmp_path / "vitb.pth"
    jconvert.save_reference_checkpoint(
        str(ckpt), jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=1)), jcfg)
    small = ["DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
             "DATA.TRAIN_JITTER_SCALES", "[32, 32]"]

    def argv(out, *extra):
        a = _common(ucf, "--output_dir", str(tmp_path / out), *extra) + small
        a[a.index("vit_tiny")] = "swin"
        a[a.index(str(ucf / "ckpt.pth"))] = str(ckpt)
        return a

    r = np.random.RandomState(2)
    np.savez(tmp_path / "lc.npz", kernel=(0.01 * r.randn(768, 2)).astype(np.float32),
             bias=np.zeros(2, np.float32), epoch=np.asarray(0))
    eval_linear.main(argv("port", "--device", "cpu", "--epochs", "1",
                          "--max_steps_per_epoch", "1"))
    assert len(_lines(capsys.readouterr().out,
                      "Multi-view test: {'split': 'test_final'")) == 1
    zp = np.load(tmp_path / "port" / "checkpoint_linear.npz")
    assert sorted(zp.files) == ["bias", "epoch", "kernel"]
    assert zp["kernel"].shape == (768, 2)
    lc = ("--lc_pretrained_weights", str(tmp_path / "lc.npz"))
    jcli.eval_linear(jcli.get_args_parser().parse_args(argv("j2", *lc)))
    want = _lines(capsys.readouterr().out, "Eval-only accuracy")
    eval_linear.main(argv("p2", "--device", "cpu", *lc))
    assert _lines(capsys.readouterr().out, "Eval-only accuracy") == want and want


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    if not vio.native_available():
        pytest.skip("native decoder not built")
    from transformers import TimesformerConfig, TimesformerForVideoClassification

    d = tmp_path_factory.mktemp("k400_eval")
    r = np.random.RandomState(0)
    losses, rows = {}, []
    for split in ("test", "train", "val"):
        (d / split).mkdir()
    for i in range(4):
        fr = r.randint(0, 256, (40, 224, 224, 3), np.uint8)
        for split in ("", "train", "val"):
            vio.write_video(str(d / split / f"c{i}.avi"), fr)
        losses[f"c{i}"] = r.rand(10).tolist()
        rows.append(f"c{i}.avi {i % 3}")
    for split in ("test", "train", "val"):
        (d / f"{split}.csv").write_text("\n".join(rows) + "\n")
    (d / "loss.json").write_text(json.dumps(losses))
    hf_cfg = TimesformerConfig(image_size=224, patch_size=16, num_frames=4, hidden_size=48,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=192, num_labels=3)
    torch.manual_seed(0)
    model = TimesformerForVideoClassification(hf_cfg)
    with torch.no_grad():  # HF's zero-initialized leaves (biases, embeddings) made non-zero
        for t in model.parameters():
            if not t.any():
                t.normal_(std=0.02)
    model.save_pretrained(str(d / "hf"))
    return d


@pytest.mark.parametrize("method", ["adaptive", "uniform"])
def test_timesformer_evaluation_cli_matches_jax(k400, tmp_path, method, capsys):
    import timesformer_evaluation as jcli

    def argv(log, *extra):
        return [*extra, "--model_path", str(k400 / "hf"), "--loss_file", str(k400 / "loss.json"),
                "--data_path", str(k400), "--dataset", "MSVD", "--num_frames", "4",
                "--num_labels", "3", "--selection_method", method, "--log_path",
                str(tmp_path / log), "--cfg", CFG, "--limit", "3"] + (
            ["--sharpen", "--probe_indices"] if method == "adaptive" else []) + [
            "--opts", "TEST.NUM_ENSEMBLE_VIEWS", "1"]

    want = jcli.evaluation(jcli.get_args_parser().parse_args(argv("jax.log")))
    jline = _lines(capsys.readouterr().out, "final top-1 accuracy")
    got = timesformer_evaluation.main(argv("port.log", "--device", "cpu"))
    out = capsys.readouterr().out
    assert got == want
    assert _lines(out, "final top-1 accuracy") == jline and "(3)" not in jline
    assert "Classifier route: plain, pixels in torch.float32" in out
    tail = [(tmp_path / f).read_text().splitlines()[-1].split(" ", 2)[-1]
            for f in ("port.log", "jax.log")]
    assert tail[0] == tail[1] == jline[0]


def test_timesformer_finetuning_cli_matches_jax(k400, tmp_path, monkeypatch, capsys):
    """Both finetuning CLIs build ViT-B's geometry whatever the checkpoint
    (neither reads the HF config.json): the test gives both packages'
    ``TimeSformerConfig`` the tiny checkpoint's widths."""
    import functools

    import timesformer_finetuning as jcli

    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

    tiny = dict(embed_dim=48, depth=2, num_heads=4)
    for mod in (jtsf, tsf):
        monkeypatch.setattr(mod, "TimeSformerConfig",
                            functools.partial(mod.TimeSformerConfig, **tiny))

    def argv(out):
        return ["--model_path", str(k400 / "hf"), "--train_loss_file", str(k400 / "loss.json"),
                "--val_loss_file", str(k400 / "loss.json"), "--data_path", str(k400),
                "--output_dir", str(tmp_path / out), "--num_train_epochs", "1",
                "--per_device_train_batch_size", "2", "--warmup_steps", "1",
                "--num_frames", "4", "--num_labels", "3", "--num_workers", "1",
                "--precision", "float32", "--max_steps_per_epoch", "2", "--cfg", CFG]

    jcli.finetuning(jcli.get_args_parser().parse_args(argv("jax")))
    timesformer_finetuning.main(argv("port") + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(_lines(out, "Loaded dataset of length: 4")) == 4
    hp, hj = (json.loads((tmp_path / n / "training_log_history.json").read_text())
              for n in ("port", "jax"))
    assert [sorted(e) for e in hp] == [sorted(e) for e in hj] and len(hj) == 2
    for e, je in zip(hp, hj):
        for key in ("eval_loss", "train_loss", "total_flos"):
            if key in je:
                assert abs(e[key] - je[key]) <= 1e-5 * abs(je[key]), (key, e, je)
    zp, zj = (np.load(tmp_path / n / "finetuned_params.npz") for n in ("port", "jax"))
    assert sorted(zp.files) == sorted(zj.files)
    noise_step = 2 * 5e-5 * 2  # the two steps' learning rates (0 and 5e-5), doubled
    for k in zj.files:
        a, b = zp[k].astype(np.float64), zj[k].astype(np.float64)
        assert a.shape == b.shape, k
        if k.endswith("qkv/bias"):  # the key third: float noise under Adam
            D = a.shape[1] // 3
            assert np.abs(a[:, D:2 * D] - b[:, D:2 * D]).max() <= noise_step, k
            a, b = np.delete(a, np.s_[D:2 * D], 1), np.delete(b, np.s_[D:2 * D], 1)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k
    assert (tmp_path / "port" / "finetuning_loss.png").exists()


def test_online_knn_eval_matches_jax(ucf, one_card, capsys):
    """The hook's features and vote on the same teacher (vit_tiny from the
    fixture's checkpoint): the port's ``online_knn_eval`` on the plain f32
    route prints JAX's line."""
    import argparse

    import train_ssl as jcli

    from dino_video_summarization_transformer_tpu.config import load_config as jload
    from dino_video_summarization_transformer_tpu_torch.config import load_config
    from dino_video_summarization_transformer_tpu_torch.models import convert
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

    args = argparse.Namespace(cfg_file=CFG, opts=OPTS, knn_data_path=str(ucf),
                              knn_dataset="ucf101", eval_batch_size_per_gpu=2,
                              num_workers=1, nb_knn=3, temperature=0.07)
    cfg = load_config(args)
    mcfg = tsf.config_from_cfg(cfg, no_head=True, arch="vit_tiny")
    sd = convert.convert_svt_checkpoint(str(ucf / "ckpt.pth"), mcfg)
    got = train_ssl.online_knn_eval(args, cfg, tsf.build_timesformer(mcfg, sd, device="cpu"),
                                    0, "plain", "cpu")
    line = _lines(capsys.readouterr().out, "online kNN")
    jcfg = jload(args)
    jm = jtsf.config_from_cfg(jcfg, no_head=True, arch="vit_tiny")
    want = jcli.online_knn_eval(args, jcfg, jm, convert.jax_params_from_state_dict(sd, mcfg), 0)
    assert _lines(capsys.readouterr().out, "online kNN") == line and line
    assert got == want


def test_train_cli_online_knn_hook(ucf, tmp_path, capsys):
    out_dir = tmp_path / "svt"
    train_ssl.main([
        "--arch", "vit_tiny", "--cfg", CFG, "--data_path", str(ucf),
        "--output_dir", str(out_dir), "--batch_size_per_gpu", "2", "--epochs", "1",
        "--warmup_epochs", "0", "--local_crops_number", "2", "--out_dim", "256",
        "--num_workers", "1", "--use_fp16", "false", "--max_steps_per_epoch", "1",
        "--saveckp_freq", "0", "--device", "cpu", "--knn_eval_freq", "1",
        "--knn_data_path", str(ucf), "--nb_knn", "3", "--eval_batch_size_per_gpu", "2",
        "--opts", *OPTS])
    assert len(_lines(capsys.readouterr().out, "[epoch 0] online kNN: top1")) == 1
    log = json.loads((out_dir / "log.txt").read_text().splitlines()[-1])
    assert {"knn_top1", "knn_top5", "epoch", "train_loss"} <= set(log)
    with pytest.raises(NotImplementedError, match="two-token"):
        train_ssl.main(["--two_token", "true", "--knn_eval_freq", "1", "--device", "cpu",
                        "--cfg", CFG, "--data_path", str(ucf), "--output_dir",
                        str(tmp_path / "tt"), "--opts", *OPTS])
