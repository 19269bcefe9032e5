"""The frame wire (uint8 RGB, packed I420 and yuv420q) on the CPU, the
port against the JAX package.

(a) ``data/yuv.py``'s numpy helpers against JAX's, byte for byte, at
    (H, W) in {(224, 224), (226, 224), (18, 24)} (H = 2 mod 4 included:
    the U plane ends mid-row) and the q variants at multiples of 8.
(b) ``unpack_normalize`` / ``_q`` (torch) against JAX's jnp versions: f32
    max abs <= 2e-6 (the two round the same f32 steps; XLA may fold a
    division by a constant into a multiply), bf16 within one bf16 ulp of
    the value.
(c) ``wire.gather_normalize_plain`` against the body of JAX's
    ``_gather_views`` / ``_gather_frames`` (``jnp.take``, then the unpack),
    windowed and flat indices, the three layouts, at (b)'s bounds; the
    wrapper on CPU tensors runs it and counts no launch; bad inputs raise.
(d) ``read_video_yuv420`` and ``DinoLossDataset`` (``wire_format``
    yuv420 / yuv420q, ``device_preprocess``) against JAX's on mpeg4
    fixtures written by JAX's ``write_video``: byte-equal.
(e) The f32 ``FrameScorer`` against JAX's on uint8 RGB, yuv420 and yuv420q
    frames, windowed and ``band_mode="both"``: per frame 1e-5 relative
    (atol = rtol = 1e-5, as tests/test_torch_scoring.py holds the float
    path); the windowed mixed teacher on yuv420 against JAX's mixed scorer
    at its float bounds (tests/test_torch_mixed_teacher.py).
(f) The uint8 fault: the port's scores on uint8 RGB frames equal its scores
    on the same frames normalized on the host, to 1e-5 (the JAX package's
    tests/test_scoring_e2e.py contract), windowed and banded. Before the
    wire's port the port fed the bytes to the model unnormalized (3.59e-2).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.config.defaults import get_cfg as jget_cfg
from dino_video_summarization_transformer_tpu.data import datasets as jdatasets
from dino_video_summarization_transformer_tpu.data import video as jvio
from dino_video_summarization_transformer_tpu.data import yuv as jyuv
from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.config.defaults import get_cfg
from dino_video_summarization_transformer_tpu_torch.data import datasets, video as vio, yuv
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import wire
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_params, make_video)

MEAN, STD = [0.45] * 3, [0.225] * 3
LAYOUTS = ("rgb8", "yuv420", "yuv420q")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgb(T, H, W, seed):
    return np.random.RandomState(seed).randint(0, 256, (T, H, W, 3), dtype=np.uint8)


def _on_wire(u8, layout):
    return u8 if layout == "rgb8" else yuv.pack_rgb(u8) if layout == "yuv420" \
        else yuv.pack_rgb_q(u8)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing of bf16 values around it)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _hold(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        assert np.max(np.abs(got - want)) <= 2e-6
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


# (a) the numpy helpers ------------------------------------------------------

@pytest.mark.parametrize("H,W", [(224, 224), (226, 224), (18, 24)])
def test_numpy_helpers_match_jax(H, W):
    u8 = _rgb(3, H, W, H)
    p, jp = yuv.pack_rgb(u8), jyuv.pack_rgb(u8)
    np.testing.assert_array_equal(p, jp)
    assert yuv.packed_height(H) == jyuv.packed_height(H) == p.shape[1]
    assert yuv.frame_height(p.shape[1]) == H
    for a, b in zip(yuv._planes(p), jyuv._planes(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(yuv.unpack_to_rgb(p), jyuv.unpack_to_rgb(jp))
    np.testing.assert_array_equal(yuv.crop(p, 3, 5, H - 6, W - 8),
                                  jyuv.crop(jp, 3, 5, H - 6, W - 8))


@pytest.mark.parametrize("H,W", [(224, 224), (24, 32), (16, 48)])
def test_numpy_q_helpers_match_jax(H, W):
    u8 = _rgb(3, H, W, H + 1)
    q, jq = yuv.pack_rgb_q(u8), jyuv.pack_rgb_q(u8)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(yuv.quarter_chroma(yuv.pack_rgb(u8)), jq)
    assert yuv.packed_q_height(H, W) == jyuv.packed_q_height(H, W) == q.shape[1]
    assert yuv.frame_height_q(q.shape[1], W) == jyuv.frame_height_q(q.shape[1], W) == H
    np.testing.assert_array_equal(yuv.unpack_q_to_rgb(q), jyuv.unpack_q_to_rgb(jq))
    np.testing.assert_array_equal(yuv.crop_q(q, 9, 8, H - 8, W - 16),
                                  jyuv.crop_q(jq, 9, 8, H - 8, W - 16))


# (b) the torch unpack -------------------------------------------------------

@pytest.mark.parametrize("layout,H,W", [("yuv420", 224, 224), ("yuv420", 226, 224),
                                        ("yuv420", 18, 24), ("yuv420q", 224, 224),
                                        ("yuv420q", 24, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unpack_normalize_matches_jax(layout, H, W, dtype):
    packed = _on_wire(_rgb(2, H, W, 7), layout)
    td, jd = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16,
                                                                   jnp.bfloat16)
    fn, jfn = ((yuv.unpack_normalize, jyuv.unpack_normalize) if layout == "yuv420"
               else (yuv.unpack_normalize_q, jyuv.unpack_normalize_q))
    got = fn(torch.from_numpy(packed), MEAN, STD, td).float().numpy()
    want = np.asarray(jfn(jnp.asarray(packed), MEAN, STD, jd).astype(jnp.float32))
    assert got.shape == (2, H, W, 3)
    _hold(got, want, dtype)


# (c) the gather -------------------------------------------------------------

def _jax_gather(frames, idx, layout, dtype):
    """The body of JAX's ``_gather_views`` / ``_gather_frames``."""
    v = jnp.take(jnp.asarray(frames), jnp.asarray(idx).reshape(-1), axis=0)
    if layout == "rgb8":
        v = (v.astype(jnp.float32) / 255.0 - jnp.asarray(MEAN, jnp.float32)) / \
            jnp.asarray(STD, jnp.float32)
        return np.asarray(v.astype(dtype).astype(jnp.float32))
    unpack = jyuv.unpack_normalize if layout == "yuv420" else jyuv.unpack_normalize_q
    return np.asarray(unpack(v, MEAN, STD, dtype).astype(jnp.float32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_normalize_plain_matches_jax(layout, dtype):
    frames = _on_wire(_rgb(20, 32, 32, 11), layout)
    loc, glob, _ = window_indices(20, 3, 8)
    flat = np.minimum(np.arange(32), 19)  # a banded segment's padding repeats
    td, jd = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16,
                                                                   jnp.bfloat16)
    buf = torch.from_numpy(frames)
    before = dict(wire.launches)
    for idx in (glob[:4], loc, flat):
        got = wire.gather_normalize_plain(buf, idx, td, layout)
        assert got.dtype == td and got.shape == (idx.size, 32, 32, 3)
        _hold(got.float().numpy(), _jax_gather(frames, idx, layout, jd), dtype)
        # the wrapper on a CPU buffer is the twin, and launches nothing
        assert torch.equal(wire.gather_normalize(buf, torch.from_numpy(idx), td, layout),
                           got)
    assert wire.launches == before


def test_gather_normalize_refuses_bad_inputs():
    buf = torch.from_numpy(yuv.pack_rgb(_rgb(4, 32, 32, 1)))
    with pytest.raises(TypeError, match="uint8"):
        wire.gather_normalize(buf.float(), [0], torch.float32, "yuv420")
    for bad in ([4], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            wire.gather_normalize(buf, bad, torch.float32, "yuv420")
    with pytest.raises(ValueError, match="layout"):
        wire.gather_normalize(buf, [0], torch.float32, "nv12")
    with pytest.raises(ValueError, match="no packed yuv420q"):
        wire.gather_normalize(buf, [0], torch.float32, "yuv420q")
    with pytest.raises(TypeError, match="dtype"):
        wire.gather_normalize(buf, [0], torch.float16, "yuv420")


def test_kernel_constants_match_twin():
    """csrc/wire.cu's literals are the twin's constants (data/yuv.py's colour
    matrix, wire.MEAN / STD): the kernel equals the twin only if they are."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(wire.__file__), "csrc", "wire.cu")).read()
    lit = {k: float(v) for k, v in
           re.findall(r"constexpr float (k\w+) = \(float\)([0-9.]+);", src)}
    assert lit == {"kYGain": yuv._Y_GAIN, "kRV": yuv._R_V, "kGU": yuv._G_U,
                   "kGV": yuv._G_V, "kBU": yuv._B_U, "kMean": wire.MEAN[0],
                   "kStd": wire.STD[0]}
    assert set(wire.MEAN) == {lit["kMean"]} and set(wire.STD) == {lit["kStd"]}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gather_bytes_reads_each_frame_once(layout):
    """The bytes bound reads each distinct gathered frame once: the
    teacher's overlapping windows of one chunk (8 x 30 indices over frames
    [0, 30)) read 30 frames, not 240."""
    buf = torch.from_numpy(_on_wire(_rgb(64, 16, 16, 2), layout))
    fb = buf[0].numel()
    _, glob, _ = window_indices(64, 3, 30)
    idx = glob[:8]
    assert np.unique(idx).size == 30 and idx.size == 240
    for dt, es in ((torch.float32, 4), (torch.bfloat16, 2)):
        assert wire.gather_bytes(buf, idx, dt, layout) == 30 * fb + 240 * 16 * 16 * 3 * es
    assert wire.gather_bytes(buf, np.arange(5), torch.float32, layout) == \
        5 * fb + 5 * 16 * 16 * 3 * 4


# (d) decode and the dataset --------------------------------------------------

def _smooth(T, H, W, seed):
    f = np.random.RandomState(seed).rand(T, H, W, 3).astype(np.float32)
    for _ in range(3):
        f = 0.25 * (np.roll(f, 1, 1) + np.roll(f, -1, 1) + np.roll(f, 1, 2)
                    + np.roll(f, -1, 2))
    return (255 * (f - f.min()) / (f.max() - f.min())).astype(np.uint8)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    if not vio.native_available():
        pytest.skip("native decode shim not built")
    d = tmp_path_factory.mktemp("wire_videos")
    jvio.write_video(str(d / "a.avi"), _smooth(12, 240, 320, 1), fps=30.0)
    jvio.write_video(str(d / "odd.avi"), _smooth(10, 226, 240, 2), fps=30.0)
    return d


@pytest.mark.parametrize("name", ["a.avi", "odd.avi"])
@pytest.mark.parametrize("stride", [1, 2])
def test_read_video_yuv420_matches_jax(videos, name, stride):
    got, fps = vio.read_video_yuv420(str(videos / name), stride=stride)
    want, jfps = jvio.read_video_yuv420(str(videos / name), stride=stride)
    assert fps == jfps and got.dtype == np.uint8
    H = 240 if name == "a.avi" else 226
    assert got.shape[1:] == (yuv.packed_height(H), want.shape[2])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(wire_format="yuv420"), dict(wire_format="yuv420q"),
                                dict(device_preprocess=True)])
def test_dataset_matches_jax(videos, kw):
    (videos / "test.csv").write_text("a.avi 0\nodd.avi 0\n")
    cfgs = []
    for make in (get_cfg, jget_cfg):
        c = make()
        c.DATA.PATH_TO_DATA_DIR = c.DATA.PATH_PREFIX = str(videos)
        c.TEST.NUM_ENSEMBLE_VIEWS = 1
        cfgs.append(c)
    ds = datasets.DinoLossDataset(cfgs[0], "test", 3, 30, 1, **kw)
    jds = jdatasets.DinoLossDataset(cfgs[1], "test", 3, 30, 1, **kw)
    for i in range(2):
        got, want = ds[i], jds[i]
        assert not got["dummy"] and not want["dummy"]
        assert got["frames"].dtype == np.uint8
        np.testing.assert_array_equal(got["frames"], want["frames"])
        for k in ("local_idx", "global_idx"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["eff_global"] == want["eff_global"]


# (e) the scorer --------------------------------------------------------------

KW = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2,
          num_frames=8, num_classes=0)
GEO = dict(local_size=3, global_size=8, chunk=4)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jtsf.TimeSformerConfig(**KW), tsf.TimeSformerConfig(**KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=5))
    return params, jcfg, convert.state_dict_from_jax_params(params, cfg), cfg


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("band", [None, "both"])
def test_f32_scorer_on_the_wire_matches_jax(weights, layout, band):
    params, jcfg, sd, cfg = weights
    T = 32  # JAX's XLA banded route is NaN at 3-28 of bucket 64 (ROADMAP §3)
    frames = _on_wire(make_video(seed=6, T=T, size=32), layout)
    loc, glob, eff = window_indices(T, 3, 8)
    wf = "yuv420q" if layout == "yuv420q" else "yuv420"
    want = jscoring.FrameScorer(params, jcfg, band_mode=band, wire_format=wf,
                                **GEO).score_video(frames, loc, glob, eff)
    got = scoring.FrameScorer(sd, cfg, band_mode=band, wire_format=wf, device="cpu",
                              **GEO).score_video(frames, loc, glob, eff)
    assert got.shape == (T,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


MIXED_KW = dict(KW, embed_dim=128, num_frames=4)  # the kernels' widths


@pytest.fixture(scope="module")
def mixed_weights():
    jcfg, cfg = jtsf.TimeSformerConfig(**MIXED_KW), tsf.TimeSformerConfig(**MIXED_KW)
    params = jsyn.make_numpy_params(jcfg, seed=0)
    return params, jcfg, convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), cfg


def _mixed(sd, cfg):
    return scoring.FrameScorer(sd, cfg, use_kernels=True, compute_dtype=torch.bfloat16,
                               teacher_dtype=torch.float32, precision=None, device="cpu",
                               **GEO)


def test_mixed_teacher_on_yuv420_matches_jax(mixed_weights):
    """The windowed mixed teacher (bf16 students, f32 teacher; the kernel
    route, twins on CPU tensors) on packed I420 against JAX's mixed
    FrameScorer(wire_format="yuv420", use_pallas=True), both held against
    the f32 scores on the same bytes: per frame |port - JAX| <= 0.25 x mean
    f32 loss, mean|port - f32| <= 1.5 x mean|JAX - f32| + 1e-3."""
    params, jcfg, sd, cfg = mixed_weights
    T = 16
    packed = yuv.pack_rgb(make_video(seed=2, T=T, size=32))
    idx = window_indices(T, 3, 8)
    f32 = scoring.FrameScorer(sd, cfg, device="cpu", **GEO).score_video(packed, *idx)
    jax_mixed = jscoring.FrameScorer(
        params, jcfg, use_pallas=True, compute_dtype=jnp.bfloat16,
        teacher_dtype=jnp.float32, precision=None, wire_format="yuv420",
        **GEO).score_video(packed, *idx)
    sc = _mixed(sd, cfg)
    mixed = sc.score_video(packed, *idx)
    assert sc.t_model.pos_embed.dtype == torch.float32
    assert np.all(np.isfinite(mixed)) and mixed.shape == (T,)
    e_port, e_jax = np.mean(np.abs(mixed - f32)), np.mean(np.abs(jax_mixed - f32))
    print(f"mean f32 loss {np.mean(f32):.4f}; mean |. - f32|: port {e_port:.3e}, "
          f"JAX {e_jax:.3e}; max |port - JAX| {np.max(np.abs(mixed - jax_mixed)):.3e}")
    assert np.max(np.abs(mixed - jax_mixed)) <= 0.25 * np.mean(f32)
    assert e_port <= 1.5 * e_jax + 1e-3, (e_port, e_jax)


def test_mixed_teacher_reads_f32_views_from_the_bytes(mixed_weights, monkeypatch):
    """The mixed teacher's views come from the uint8 buffer in f32, the
    students' in bf16: each forward's gather in its own dtype."""
    seen = []
    real = wire.gather_normalize

    def spy(frames, idx, dtype, layout, *a):
        seen.append((frames.dtype, dtype, layout))
        return real(frames, idx, dtype, layout, *a)

    monkeypatch.setattr(wire, "gather_normalize", spy)
    T = 8
    _mixed(*mixed_weights[2:]).score_video(yuv.pack_rgb(make_video(seed=3, T=T, size=32)),
                                           *window_indices(T, 3, 8))
    assert seen == [(torch.uint8, torch.bfloat16, "yuv420"),
                    (torch.uint8, torch.float32, "yuv420")] * 2


def test_wire_format_is_validated_and_groups_keep_one_layout(weights):
    _, _, sd, cfg = weights
    with pytest.raises(ValueError, match="wire_format"):
        scoring.FrameScorer(sd, cfg, wire_format="rgb8", device="cpu", **GEO)
    sc = scoring.FrameScorer(sd, cfg, device="cpu", **GEO)
    u8 = make_video(seed=4, T=8, size=32)
    item = {"local_idx": np.zeros((8, 3), np.int64), "eff_global": 8,
            "global_idx": np.zeros((8, 8), np.int64), "dummy": False}
    for other in (yuv.pack_rgb(u8), (u8 / 255.0 - 0.45).astype(np.float32) / 0.225):
        with pytest.raises(ValueError, match="mixes frame layouts"):
            sc.score_group_async([dict(item, frames=u8), dict(item, frames=other)])
    with pytest.raises(ValueError, match="uint8 frames of shape"):
        sc.score_video(u8[..., 0:2], *window_indices(8, 3, 8))


# (f) the uint8 fault ---------------------------------------------------------

@pytest.mark.parametrize("band", [None, "both"])
def test_uint8_wire_matches_host_normalization(band):
    """JAX's test_scoring_e2e.py case: D = 32, depth 1, chunk 4, twelve
    random 224-px uint8 frames; the uint8 scores equal the host-normalized
    f32 scores to 1e-5."""
    cfg = tsf.TimeSformerConfig(img_size=224, patch_size=16, embed_dim=32, depth=1,
                                num_heads=2, num_frames=8, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    u8 = np.random.RandomState(3).randint(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    f32 = ((u8 / 255.0 - 0.45) / 0.225).astype(np.float32)
    loc, glob, eff = window_indices(12, 3, 30)
    sc = scoring.FrameScorer(sd, cfg, chunk=4, band_mode=band, device="cpu")
    a, b = sc.score_video(u8, loc, glob, eff), sc.score_video(f32, loc, glob, eff)
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_uint8_buffer_ships_as_bytes(weights, layout):
    _, _, sd, cfg = weights
    sc = scoring.FrameScorer(sd, cfg, device="cpu", **GEO)
    frames = _on_wire(make_video(seed=8, T=8, size=32), layout)
    buf = sc._upload(frames)
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == frames.shape
