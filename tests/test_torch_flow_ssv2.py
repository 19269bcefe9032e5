"""The port's image ops and image-file data against the JAX package's:
``ops/image.py`` (``sobel``, ``sobel_np``, ``rand_conv``,
``load_flow_folder``), ``ClipDataset(get_flow=True)`` (both
``DATA.NO_FLOW_AUG`` branches, the retry of a video without flow frames)
and the Something-Something v2 frame lists (``load_image_lists``,
``retry_load_images``, ``Ssv2Dataset``).

Tolerances: the numpy Sobel and every dataset item bit for bit (the same
numpy code and ``RandomState`` draws); the torch Sobel equals the numpy
one bit for bit on the CPU and JAX's convolution to 1e-6 of max;
``rand_conv`` 1e-5 of max (a convolution's summation order). Skipped
where the native decoder is not built (the clip datasets only)."""

import json

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.config import defaults as jdefaults
from dino_video_summarization_transformer_tpu.data import datasets as jds
from dino_video_summarization_transformer_tpu.ops import image as jimage
from dino_video_summarization_transformer_tpu_torch.config import defaults
from dino_video_summarization_transformer_tpu_torch.data import datasets as pds
from dino_video_summarization_transformer_tpu_torch.data import video as vio
from dino_video_summarization_transformer_tpu_torch.ops import image


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def test_sobel_matches_jax():
    x = np.random.RandomState(0).rand(3, 2, 17, 23).astype(np.float32)
    want_np = jds._sobel_np(x)
    got_np = image.sobel_np(x)
    assert got_np.dtype == np.float32 and np.array_equal(got_np, want_np)
    got = image.sobel(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want_np)
    assert _rel(got.numpy(), jimage.sobel(jnp.asarray(x))) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 3, 12, 10), (2, 3, 4, 12, 10)])
def test_rand_conv_matches_jax(shape):
    """The port given the weight JAX draws from its key (HWIO)."""
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    key = jax.random.key(2)
    w = (1.0 / (np.sqrt(3) * 3)) * jax.random.normal(key, (3, 3, 3, 3), jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = jimage.rand_conv(key, jnp.asarray(x))
    got = image.rand_conv(torch.from_numpy(x), weight=torch.from_numpy(np.asarray(w)))
    assert got.shape == want.shape and _rel(got.numpy(), want) <= 1e-5
    drawn = image.rand_conv(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape and not torch.equal(drawn, torch.from_numpy(x))


def _write_jpegs(d, r, n, hw=(64, 80), gray=False):
    from PIL import Image

    d.mkdir(parents=True)
    for i in range(n):
        a = r.randint(0, 256, hw if gray else hw + (3,), dtype=np.uint8)
        Image.fromarray(a).save(str(d / f"{i:03d}.jpg"))


def test_load_flow_folder_matches_jax(tmp_path):
    r = np.random.RandomState(3)
    _write_jpegs(tmp_path / "rgb", r, 4)
    _write_jpegs(tmp_path / "gray", r, 3, gray=True)
    for name in ("rgb", "gray"):
        got = image.load_flow_folder(str(tmp_path / name))
        want = jimage.load_flow_folder(str(tmp_path / name))
        assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape == (3, 1, 64, 80)
    assert image.load_flow_folder(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the flow companion of ClipDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flow_corpus(tmp_path_factory):
    """JAX's ``tests/test_distill.py`` corpus (videos under train_d256, flow
    JPEGs under train_flow) plus a third video without a flow folder."""
    if not vio.native_available():
        pytest.skip("native decoder not built")
    d = tmp_path_factory.mktemp("flow_clips")
    r = np.random.RandomState(0)
    (d / "train_d256").mkdir()
    for name in ("a", "b", "c"):
        vio.write_video(str(d / "train_d256" / f"{name}.avi"),
                        r.randint(0, 256, (40, 128, 160, 3), np.uint8), fps=30)
        if name != "c":
            _write_jpegs(d / "train_flow" / name, r, 10)
    (d / "train.csv").write_text(
        "train_d256/a.avi 0\ntrain_d256/b.avi 1\ntrain_d256/c.avi 2\n")
    return d


def _cfgs(d, **opts):
    out = []
    for mod in (defaults, jdefaults):
        cfg = mod.get_cfg()
        cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = str(d)
        cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE, cfg.DATA.CROP_SIZE = 4, 2, 64
        for k, v in opts.items():
            node, leaf = k.split("__")
            setattr(getattr(cfg, node), leaf, v)
        out.append(cfg)
    return out


@pytest.mark.parametrize("no_flow_aug", [True, False])
def test_clip_dataset_flow_matches_jax(flow_corpus, no_flow_aug):
    """Every item of both packages' datasets, bit for bit: the multi-crop
    clips and the flow frames (resized per frame, or the DINO multi-crop
    over the flow video); video c has no flow frames and is swapped."""
    pcfg, jcfg = _cfgs(flow_corpus, DATA__NO_FLOW_AUG=no_flow_aug)
    port = pds.ClipDataset(pcfg, "train", temporal_aug=True, get_flow=True, seed=0)
    jax_ds = jds.ClipDataset(jcfg, "train", temporal_aug=True, get_flow=True, seed=0)
    for i in (0, 2, 1):
        (pc, pl, pi, pm), (jc, jl, ji, jm) = port[i], jax_ds[i]
        assert (pl, pi) == (jl, ji) and len(pc) == len(jc) == 10
        for a, b in zip(pc, jc):
            np.testing.assert_array_equal(a, b)
        assert len(pm["flow"]) == len(jm["flow"]) == 10  # frames, or crops
        for a, b in zip(pm["flow"], jm["flow"]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert pi != 2  # c has no flow: swapped for another video
    assert pm["flow"][0].shape == ((3, 64, 64) if no_flow_aug else (3, 10, 224, 224))
    with pytest.raises(ValueError, match="train only"):
        pds.ClipDataset(pcfg, "val", get_flow=True)


# ---------------------------------------------------------------------------
# Something-Something v2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssv2(tmp_path_factory):
    """Labels and splits in SSv2's JSON layout, frame lists in its CSV
    layout (a video without frame rows among them), JPEG frames."""
    from PIL import Image

    d = tmp_path_factory.mktemp("ssv2")
    r = np.random.RandomState(4)
    templates = ["Pushing [something] from left to right", "Holding [something]"]
    (d / "something-something-v2-labels.json").write_text(json.dumps(
        {t.replace("[", "").replace("]", ""): str(i) for i, t in enumerate(templates)}))
    for split, csv, vids in (("train", "train.csv", ["10", "11", "12"]),
                             ("validation", "val.csv", ["20", "21"])):
        (d / f"something-something-v2-{split}.json").write_text(json.dumps(
            [{"id": v, "template": templates[i % 2]} for i, v in enumerate(vids + ["99"])]))
        rows = ["original_vido_id video_id frame_id path labels"]
        for vi, v in enumerate(vids):
            (d / v).mkdir()
            for f in range(7 + 3 * vi):
                Image.fromarray(r.randint(0, 256, (48, 64, 3), np.uint8)).save(
                    str(d / v / f"{f:05d}.jpg"))
                rows.append(f'{v} {vi} {f} {v}/{f:05d}.jpg "{vi},{f % 3}"')
        (d / csv).write_text("\n".join(rows) + "\n\n")
    return d


def test_load_image_lists_matches_jax(ssv2):
    for prefix in ("", str(ssv2)):
        for return_list in (False, True):
            got = pds.load_image_lists(str(ssv2 / "train.csv"), prefix, return_list)
            want = jds.load_image_lists(str(ssv2 / "train.csv"), prefix, return_list)
            assert got == want
    paths, labels = pds.load_image_lists(str(ssv2 / "train.csv"), str(ssv2))
    assert len(paths["12"]) == 13 and labels["11"][2] == [1, 2]
    frames = pds.retry_load_images(paths["10"][:3])
    want = jds.retry_load_images(paths["10"][:3])
    assert frames.dtype == np.uint8 and frames.shape == (3, 48, 64, 3)
    np.testing.assert_array_equal(frames, want)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_ssv2_dataset_matches_jax(ssv2, mode):
    pcfg, jcfg = _cfgs(ssv2, DATA__TRAIN_JITTER_SCALES=[40, 56],
                       DATA__TRAIN_CROP_SIZE=32, DATA__TEST_CROP_SIZE=40,
                       TEST__NUM_ENSEMBLE_VIEWS=1, TEST__NUM_SPATIAL_CROPS=3)
    port = pds.build_dataset("ssv2", pcfg, mode, seed=5)
    want = jds.build_dataset("ssv2", jcfg, mode, seed=5)
    assert isinstance(port, pds.Ssv2Dataset)
    assert len(port) == len(want) == {"train": 3, "val": 2, "test": 6}[mode]
    assert port.labels == want.labels
    for i in range(len(port)):
        (pf, pl, pi, pm), (jf, jl, ji, jm) = port[i], want[i]
        assert (pl, pi, pm) == (jl, ji, jm)
        assert pf.dtype == np.float32 and pf.shape == jf.shape
        np.testing.assert_array_equal(pf, jf)
    assert pf.shape == (3, 4) + ((40, 40) if mode == "test" else (32, 32))
