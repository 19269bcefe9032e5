"""Banded one-pass scoring (``band_mode``) in the port's engine against the
JAX package's, on the CPU.

Models: depth 2, 32 x 32 frames, numpy-seeded weights crossed with
``convert.state_dict_from_jax_params``; D = 64 with 2 heads for the f32
comparisons (as tests/test_torch_scoring.py), D = 256 with 4 heads (head
dim 64, the kernels' geometry) for the bf16 kernel route.

(a) f32 scorer, band_mode "both" and "teacher", one segment and several
    (``band_chunk`` 64, ``band_halo`` 16), against JAX's FrameScorer on the
    same weights: atol = rtol = 1e-5 (both f32, TF32 off / "highest"), and
    the same ``stats``.
(b) the "teacher" hybrid at T == global size equals the exact path:
    every global window is the whole clip, so the banded teacher rows are
    the windowed ones (rtol 5e-3, atol 1e-5: tests/test_banded_scorer.py's
    bound; the teacher softmax at temperature 0.02 multiplies the feature
    rounding of two summation orders by 50).
(c) bf16 kernel route (the kernels' plain twins on CPU tensors) against
    JAX bf16, with the Pallas kernels (interpret mode) and on its XLA route,
    all held against the f32 scores. The banded tier is noisier in bf16
    than the windowed one (each frame's loss rests on one banded CLS row
    per pass), and on this random-weight model the two JAX bf16 tiers
    themselves sit 2-11 % of the mean loss from f32 on average and up to
    57 % at a frame, in an order that changes from clip to clip. So the
    windowed path's per-frame bound against JAX (0.25 x mean f32 loss,
    tests/test_torch_scoring.py) is replaced by:
    per frame |port - f32| <= 0.5 x mean f32 loss (the port's largest
    reading on three clips was 0.25); mean|port - f32| <= 1.5 x the larger
    mean error of the two JAX bf16 tiers; and mean|port - f32| <= 1.5 x
    mean|port plain bf16 - f32| + 1e-3 (chip_smoke.py's bound).
(d) run_scoring writes the JSON the JAX run writes (keys, lengths, f32
    values at 1e-5, a dummy item's constant losses); the CLI takes
    ``--band``, ``--teacher_precision float32``, ``--wire_format`` and the
    strided flags; the scorer refuses ``band_mode`` with a strided knob.
"""

import json
import os

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
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video

KW = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2,
          num_frames=8, num_classes=0)
KERNEL_KW = dict(KW, embed_dim=256, num_heads=4)
GEO = dict(local_size=3, global_size=30, chunk=8)
STAT_KEYS = ("teacher_rows", "student_rows", "band_teacher_frames",
             "band_student_frames", "band_flops")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, zero_te=False, kw=KW):
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    if zero_te:
        params = dict(params, time_embed=np.zeros_like(params["time_embed"]))
    return params, jcfg, convert.state_dict_from_jax_params(params, cfg), cfg


def _clip(T, seed):
    vid = make_video(seed=seed, T=T, size=32)
    return ((vid.astype(np.float32) / 255.0 - 0.45) / 0.225,
            *window_indices(T, 3, 30))


@pytest.mark.parametrize("mode,T,seg", [("both", 40, {}), ("teacher", 40, {}),
                                        ("both", 90, dict(band_chunk=64,
                                                          band_halo=16))])
def test_f32_banded_scorer_matches_jax(mode, T, seg):
    params, jcfg, sd, cfg = _weights(seed=1)
    frames, loc, glob, eff = _clip(T, seed=T)
    js = jscoring.FrameScorer(params, jcfg, band_mode=mode, **GEO, **seg)
    want = js.score_video(frames, loc, glob, eff)
    ps = scoring.FrameScorer(sd, cfg, band_mode=mode, device="cpu", **GEO, **seg)
    got = ps.score_video(frames, loc, glob, eff)
    assert got.shape == (T,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for k in STAT_KEYS:
        assert ps.stats[k] == pytest.approx(js.stats[k]), k
    if seg:
        assert len(ps._band_segments(T)) > 1
        assert ps.stats["band_teacher_frames"] == 64 * len(ps._band_segments(T))


def test_short_last_segment_is_finite():
    """T = 100 at band_chunk 64, halo 16: the last segment holds 20 frames
    in a 64-frame bucket, fewer than the teacher window. Its losses are
    finite (the JAX package's XLA route gives NaN there: ROADMAP section 3)
    and the segments before it match the unsegmented run where their rows
    see no seam (depth 2: the reach of a frame is 2 * (eff // 2) + eff // 2
    frames, within the halo only for the student pass)."""
    _, _, sd, cfg = _weights(seed=1)
    frames, loc, glob, eff = _clip(100, seed=100)
    sc = scoring.FrameScorer(sd, cfg, band_mode="both", band_chunk=64,
                             band_halo=16, device="cpu", **GEO)
    assert sc._band_segments(100)[-1] == (80, 100, 96, 100)
    got = sc.score_video(frames, loc, glob, eff)
    assert got.shape == (100,) and np.all(np.isfinite(got))


def test_teacher_hybrid_equals_exact_when_clip_equals_window():
    _, _, sd, cfg = _weights(seed=2, zero_te=True)
    frames, loc, glob, eff = _clip(30, seed=3)
    exact = scoring.FrameScorer(sd, cfg, device="cpu", **GEO).score_video(
        frames, loc, glob, eff)
    hybrid = scoring.FrameScorer(sd, cfg, band_mode="teacher", device="cpu",
                                 **GEO).score_video(frames, loc, glob, eff)
    np.testing.assert_allclose(hybrid, exact, rtol=5e-3, atol=1e-5)


def test_bf16_kernel_route_matches_jax_pallas():
    params, jcfg, sd, cfg = _weights(seed=4, kw=KERNEL_KW)
    T = 40
    frames, loc, glob, eff = _clip(T, seed=5)

    def jax_bf16(use_pallas):
        return jscoring.FrameScorer(
            params, jcfg, band_mode="both", use_pallas=use_pallas,
            compute_dtype=jnp.bfloat16, precision=None, **GEO).score_video(
                frames, loc, glob, eff)

    def port(**kw):
        return scoring.FrameScorer(sd, cfg, band_mode="both", device="cpu",
                                   **GEO, **kw)

    kern = port(use_kernels=True, compute_dtype=torch.bfloat16, precision=None)
    assert kern.model_cfg.use_kernels
    before = (dict(bb.launches), dict(fb.launches))
    got = kern.score_video(frames, loc, glob, eff)
    assert (dict(bb.launches), dict(fb.launches)) == before  # twins on CPU
    plain = port(use_kernels=False, compute_dtype=torch.bfloat16,
                 precision=None).score_video(frames, loc, glob, eff)
    f32 = port().score_video(frames, loc, glob, eff)
    assert np.all(np.isfinite(got)) and got.shape == (T,)

    def err(a):
        return np.abs(a - f32)

    e_jax = max(err(jax_bf16(True)).mean(), err(jax_bf16(False)).mean())
    assert err(got).max() <= 0.5 * f32.mean(), err(got).max() / f32.mean()
    assert err(got).mean() <= 1.5 * e_jax, (err(got).mean(), e_jax)
    assert err(got).mean() <= 1.5 * err(plain).mean() + 1e-3


def test_band_config_is_validated():
    _, _, sd, cfg = _weights(seed=0)
    with pytest.raises(ValueError, match="band_mode"):
        scoring.FrameScorer(sd, cfg, band_mode="student", device="cpu", **GEO)
    with pytest.raises(ValueError, match="band_halo"):
        scoring.FrameScorer(sd, cfg, band_mode="both", band_halo=4,
                            device="cpu", **GEO)
    with pytest.raises(ValueError, match="band_chunk"):
        scoring.FrameScorer(sd, cfg, band_mode="both", band_chunk=16,
                            device="cpu", **GEO)
    with pytest.raises(ValueError, match="twice"):  # segments would not advance
        scoring.FrameScorer(sd, cfg, band_mode="both", band_chunk=60,
                            device="cpu", **GEO)
    sc = scoring.FrameScorer(sd, cfg, band_mode="both", device="cpu", **GEO)
    assert [sc._band_bucket(n) for n in (40, 64, 65, 300, 512)] == [
        64, 64, 128, 384, 512]
    assert sc._band_segments(600) == [(0, 480, 0, 448), (416, 600, 448, 600)]


def test_run_scoring_band_json_matches_jax(tmp_path):
    params, jcfg, sd, cfg = _weights(seed=6)
    items = []
    # lengths at which the JAX XLA route is finite (ROADMAP section 3)
    for i, T in enumerate([40, 50]):
        frames, loc, glob, eff = _clip(T, seed=20 + i)
        items.append({"path": f"/v/vid{i}.mp4", "dummy": False,
                      "frames": frames, "local_idx": loc, "global_idx": glob,
                      "eff_global": eff, "num_frames": T, "local_size": 3})
    items.insert(1, {"path": "/v/broken.avi", "dummy": True, "frames": None,
                     "eff_global": 1, "num_frames": 30, "local_size": 3})
    paths = {t: str(tmp_path / f"{t}.json") for t in ("jax", "port")}
    jscoring.run_scoring(
        items, jscoring.make_scorers(params, jcfg, band_mode="both", **GEO),
        paths["jax"], num_workers=1, log_every=0)
    scoring.run_scoring(
        items, scoring.make_scorers(sd, cfg, band_mode="both", device="cpu",
                                    **GEO),
        paths["port"], num_workers=2, log_every=0, group_videos=2)
    want, got = (json.load(open(paths[t])) for t in ("jax", "port"))
    assert set(got) == set(want) == {"vid0", "broken", "vid1"}
    assert {k: len(v) for k, v in got.items()} == {"vid0": 40, "broken": 30,
                                                   "vid1": 50}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("band", ["both", "teacher"])
def test_cli_band_in_process(tmp_path, band):
    from dino_video_summarization_transformer_tpu.data import video as jvio
    from dino_video_summarization_transformer_tpu.models import convert as jconvert
    from dino_video_summarization_transformer_tpu_torch.data import video as vio

    if not vio.native_available():
        pytest.skip("native decode shim not built")
    fr = np.random.RandomState(0).randint(0, 256, (24, 256, 320, 3), dtype=np.uint8)
    jvio.write_video(str(tmp_path / "vidA.avi"), fr, fps=30)  # 6 presampled
    (tmp_path / "test.csv").write_text("vidA.avi 0\n")
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
        "--global_clip_size", "4", "--band", band, "--file_path", out,
        "--num_workers", "1", "--device", "cpu",
        "--opts", "DATA.PATH_TO_DATA_DIR", str(tmp_path),
        "DATA.PATH_PREFIX", str(tmp_path), "TEST.NUM_ENSEMBLE_VIEWS", "1"])
    with open(out) as f:
        data = json.load(f)
    assert set(data) == {"vidA"} and len(data["vidA"]) == 6
    assert all(np.isfinite(v) for v in data["vidA"])


def test_cli_band_flag_is_ported_and_mixed_teacher_is_not():
    """(The name predates the mixed teacher's, the wire's, the int8 tiers'
    and the strided knobs' ports.) ``--band``, ``--teacher_precision
    float32``, ``--wire_format``, the int8 flags and the strided flags
    (``--teacher_stride 4``, ``--score_stride 2``) pass the CLI's check,
    alone and together; the scorer refuses ``band_mode`` with a strided
    knob with JAX's ValueError, before it loads any weights."""
    parse = cli.get_args_parser().parse_args
    for argv in (["--band", "both"], ["--teacher_precision", "float32"],
                 ["--band", "both", "--teacher_precision", "float32"],
                 ["--wire_format", "yuv420", "--band", "both"],
                 ["--teacher_quant", "int8"],
                 ["--student_quant", "int8", "--teacher_precision", "float32"],
                 ["--teacher_stride", "4"], ["--score_stride", "2"],
                 ["--teacher_stride", "4", "--band", "both"]):
        cli.check_unported(parse(argv))
    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                                num_heads=2, num_classes=0)
    for knob in ("teacher_stride", "score_stride"):
        with pytest.raises(ValueError, match=f"band_mode does not compose with .*{knob}"):
            scoring.FrameScorer({}, cfg, device="cpu", band_mode="both", **{knob: 2})
