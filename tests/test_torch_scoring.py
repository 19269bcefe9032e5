"""The port's scoring engine against the JAX package's, on the CPU.

(a) f32 FrameScorer vs the committed golden scores (long_T40, short_T12),
    atol = rtol = 1e-5 as tests/test_golden_scores.py holds JAX to.
(b) bf16 kernel route (the kernels' plain twins on CPU tensors) vs JAX's
    FrameScorer(use_pallas=True) (Pallas interpret mode), both measured
    against the f32 scores of the same inputs. Bounds: per frame,
    |port - jax| <= 0.25 * mean f32 loss — the teacher softmax at
    temperature 0.02 multiplies feature rounding by 50, so each bf16 tier's
    worst frame sits up to ~13% of the mean loss from f32 here, and two
    tiers that round at different points (and differ in softmax clamp and
    GELU form) can sit on opposite sides; and mean|port - f32| <= 1.5 *
    mean|jax - f32|. (At the feature level the port is closer to f32 than
    the Pallas path: tests/test_torch_fused_block.py.)
(c) run_scoring + export_loss write the JSON the JAX run_scoring writes
    (f32, atol = rtol = 1e-5), dummy item and merge into an existing file
    included.
(d) the port CLI in-process on a two-video CSV (skipped unless the native
    decode shim loads).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import conftest

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch import dino_similarity as cli
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_params, make_video)

sys.path.insert(0, os.path.join(conftest.REPO_ROOT, "tools"))
from gen_golden_scores import GOLDEN_PATH  # noqa: E402

KW = dict(patch_size=16, num_heads=2, num_classes=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normalized(vid):
    return (vid.astype(np.float32) / 255.0 - 0.45) / 0.225


def _sd(cfg, seed=0):
    return convert.state_dict_from_jax_params(make_numpy_params(cfg, seed), cfg)


@pytest.mark.parametrize("name,T", [("long_T40", 40), ("short_T12", 12)])
def test_f32_scorer_matches_golden(name, T):
    """The config of tools/gen_golden_scores.py."""
    cfg = tsf.TimeSformerConfig(img_size=224, embed_dim=64, depth=2,
                                num_frames=4, **KW)
    scorer = scoring.FrameScorer(_sd(cfg), cfg, local_size=3, global_size=30,
                                 chunk=8, device="cpu")
    assert not scorer.model_cfg.use_kernels  # "auto": f32 keeps the plain path
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[name]
    loc, glob, eff = window_indices(T, 3, 30)
    got = scorer.score_video(_normalized(make_video(seed=3, T=T, size=224)),
                             loc, glob, eff)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_kernel_route_matches_jax_pallas():
    kw = dict(img_size=32, embed_dim=128, depth=2, num_frames=4, **KW)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    params = jsyn.make_numpy_params(jcfg, seed=1)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)
    T = 12
    frames = _normalized(make_video(seed=4, T=T, size=32))
    loc, glob, eff = window_indices(T, 3, 8)
    geo = dict(local_size=3, global_size=8, chunk=4)

    jax_bf16 = jscoring.FrameScorer(params, jcfg, use_pallas=True,
                                    compute_dtype=jnp.bfloat16, precision=None,
                                    **geo).score_video(frames, loc, glob, eff)
    port = scoring.FrameScorer(sd, cfg, use_kernels=True,
                               compute_dtype=torch.bfloat16, precision=None,
                               device="cpu", **geo)
    assert port.model_cfg.use_kernels
    before = dict(fb.launches)
    port_bf16 = port.score_video(frames, loc, glob, eff)
    assert fb.launches == before  # CPU tensors: twins, no kernel launches
    f32 = scoring.FrameScorer(sd, cfg, device="cpu", **geo).score_video(
        frames, loc, glob, eff)

    assert np.all(np.isfinite(port_bf16)) and port_bf16.shape == (T,)
    assert np.max(np.abs(port_bf16 - jax_bf16)) <= 0.25 * np.mean(f32)
    e_port = np.mean(np.abs(port_bf16 - f32))
    e_jax = np.mean(np.abs(jax_bf16 - f32))
    assert e_port <= 1.5 * e_jax, (e_port, e_jax)


def _items(T_list, size, with_dummy):
    items = []
    for i, T in enumerate(T_list):
        loc, glob, eff = window_indices(T, 3, 30)
        items.append({"path": f"/v/vid{i}.mp4", "dummy": False,
                      "frames": _normalized(make_video(seed=20 + i, T=T, size=size)),
                      "local_idx": loc, "global_idx": glob, "eff_global": eff,
                      "num_frames": T, "local_size": 3})
    if with_dummy:
        items.insert(1, {"path": "/v/broken.avi", "dummy": True, "frames": None,
                         "eff_global": 1, "num_frames": 30, "local_size": 3})
    return items


def test_run_scoring_json_matches_jax(tmp_path):
    kw = dict(img_size=32, embed_dim=64, depth=2, num_frames=4, **KW)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    params = jsyn.make_numpy_params(jcfg, seed=2)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)
    # 40 frames: full windows; 12 and 10: short videos, teacher window
    # clamped to T (two more window geometries, scored as separate groups)
    items = _items([40, 12, 10], 32, with_dummy=True)
    geo = dict(local_size=3, global_size=30, chunk=8)
    paths = {}
    for tag in ("jax", "port"):
        paths[tag] = str(tmp_path / tag / "loss.json")
        os.makedirs(os.path.dirname(paths[tag]))
        with open(paths[tag], "w") as f:  # merge into an existing file
            json.dump({"vid0": [0.0], "kept": [1.5]}, f)
    jscoring.run_scoring(items, jscoring.make_scorers(params, jcfg, **geo),
                         paths["jax"], num_workers=1, log_every=0)
    scoring.run_scoring(items, scoring.make_scorers(sd, cfg, device="cpu", **geo),
                        paths["port"], num_workers=2, log_every=0,
                        group_videos=2)
    want, got = (json.load(open(paths[t])) for t in ("jax", "port"))
    assert set(got) == set(want) == {"vid0", "vid1", "vid2", "broken", "kept"}
    assert got["kept"] == [1.5] and len(got["broken"]) == 30
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("wire_format", ["rgb8", "yuv420", "yuv420q"])
def test_cli_in_process(tmp_path, wire_format):
    """Normalized floats (rgb8), packed I420 and yuv420q from decode to the
    scorer."""
    from dino_video_summarization_transformer_tpu.data import video as jvio
    from dino_video_summarization_transformer_tpu.models import convert as jconvert
    from dino_video_summarization_transformer_tpu_torch.data import video as vio

    if not vio.native_available():
        pytest.skip("native decode shim not built")
    rng = np.random.RandomState(0)
    fr = rng.randint(0, 256, (24, 256, 320, 3), dtype=np.uint8)
    jvio.write_video(str(tmp_path / "vidA.avi"), fr[:16], fps=30)  # 4 presampled
    jvio.write_video(str(tmp_path / "vidB.avi"), fr, fps=30)       # 6 presampled
    (tmp_path / "test.csv").write_text("vidA.avi 0\nvidB.avi 0\n")
    jcfg = jtsf.vit_tiny_config(num_frames=8, num_classes=0)
    ckpt = str(tmp_path / "ckpt.pth")
    jconvert.save_reference_checkpoint(
        ckpt, jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=0)), jcfg)
    out = str(tmp_path / "loss.json")
    cli.main([
        "--cfg", os.path.join(conftest.REPO_ROOT,
                              "configs/kinetics/timesformer_divst_8x32_224.yaml"),
        "--pretrained_weights", ckpt, "--checkpoint_key", "teacher",
        "--arch", "vit_tiny", "--batch_size_per_gpu", "4",
        "--global_clip_size", "4", "--file_path", out, "--num_workers", "2",
        "--device", "cpu", "--wire_format", wire_format,
        "--opts", "DATA.PATH_TO_DATA_DIR", str(tmp_path),
        "DATA.PATH_PREFIX", str(tmp_path), "TEST.NUM_ENSEMBLE_VIEWS", "1"])
    with open(out) as f:
        data = json.load(f)
    assert set(data) == {"vidA", "vidB"}
    assert len(data["vidA"]) == 4 and len(data["vidB"]) == 6
    assert all(np.isfinite(v) for v in data["vidA"] + data["vidB"])


def test_cli_refuses_unported_flags(monkeypatch):
    """No flag of the CLI is refused as unported any more: the seven
    approximation flags of the JAX CLI pass ``check_unported`` and reach
    ``make_scorers`` with their parsed values (its NOTE line printed at
    f32), as ``--wire_format`` and the int8 tiers' flags do."""
    from dino_video_summarization_transformer_tpu_torch.data import datasets
    from dino_video_summarization_transformer_tpu_torch.engine import scoring as port_scoring

    parse = cli.get_args_parser().parse_args
    away = {"global_subsample": "2", "teacher_stride": "4",
            "teacher_interp": "catmullrom", "teacher_adaptive": "0.5",
            "teacher_refine": "0.5", "score_stride": "2", "score_refine": "0.5"}
    assert not hasattr(cli, "UNPORTED_FLAGS")
    for flag, value in away.items():
        cli.check_unported(parse([f"--{flag}", value]))
    for wire_format in ("rgb8", "yuv420", "yuv420q"):
        cli.check_unported(parse(["--wire_format", wire_format]))
    for flag in ("student_quant", "teacher_quant"):
        cli.check_unported(parse([f"--{flag}", "int8"]))
    cli.check_unported(parse([]))
    seen = {}
    monkeypatch.setattr(port_scoring, "make_scorers",
                        lambda sd, mcfg, **kw: seen.update(kw) or ["scorer"])
    monkeypatch.setattr(port_scoring, "run_scoring", lambda ds, sc, *a, **k: seen.update(
        ran=sc))
    monkeypatch.setattr(datasets, "DinoLossDataset", lambda **kw: None)
    argv = sum(([f"--{k}", v] for k, v in away.items()), [])
    cli.main(argv + ["--arch", "vit_tiny", "--device", "cpu", "--cfg", os.path.join(
        conftest.REPO_ROOT, "configs/kinetics/timesformer_divst_8x32_224.yaml")])
    parsed = parse(argv)
    assert seen["ran"] == ["scorer"]
    for flag in away:
        assert seen[flag] == getattr(parsed, flag), flag
