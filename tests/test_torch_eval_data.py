"""The evaluation consumers' data surface against the JAX package's, on
videos written by the port's ``write_video`` and decoded by the repo's
native shim in both packages: ``video_info`` and the selective decodes,
the ``spatial_sampling`` family, ``ClipDataset``'s val, test and
plain-train modes, ``FrameSelectionDataset`` in each return type and
``build_dataset``. Everything is compared bit for bit: both packages draw
the same numbers from the same ``RandomState`` in the same order. Skipped
where the native decoder is not built."""

import json

import numpy as np
import pytest

import conftest  # noqa: F401

from dino_video_summarization_transformer_tpu.config import defaults as jdefaults
from dino_video_summarization_transformer_tpu.data import datasets as jds
from dino_video_summarization_transformer_tpu.data import transform as jtr
from dino_video_summarization_transformer_tpu.data import video as jvio
from dino_video_summarization_transformer_tpu_torch.config import defaults
from dino_video_summarization_transformer_tpu_torch.data import datasets as pds
from dino_video_summarization_transformer_tpu_torch.data import transform as ptr
from dino_video_summarization_transformer_tpu_torch.data import video as vio

LENGTHS = (40, 23, 9)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not vio.native_available():
        pytest.skip("native decoder not built")
    root = tmp_path_factory.mktemp("eval_corpus")
    r = np.random.RandomState(0)
    losses = {}
    for i, n in enumerate(LENGTHS):
        h, w = (72, 96) if i != 1 else (96, 72)
        vio.write_video(str(root / f"v{i}.avi"), r.randint(0, 256, (n, h, w, 3), np.uint8))
        losses[f"v{i}"] = r.rand(-(-n // 2)).tolist()
    rows = "v0.avi 0\nmissing.avi 1\nv1.avi 1\nv2.avi 2\n"
    for name in ("train.csv", "val.csv", "test.csv", "ucf101_val_split_1_videos.txt"):
        (root / name).write_text(rows)
    (root / "sel.csv").write_text("v0.avi 0\nv1.avi 1\nv2.avi 2\n")
    (root / "loss.json").write_text(json.dumps(losses))
    return root


def _cfgs(root, **opts):
    out = []
    for mod in (defaults, jdefaults):
        cfg = mod.get_cfg()
        cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = str(root)
        cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 4, 4
        cfg.DATA.TRAIN_JITTER_SCALES = [64, 80]
        cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE = 56, 64
        cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 2, 3
        for k, v in opts.items():
            node, leaf = k.split("__")
            setattr(getattr(cfg, node), leaf, v)
        out.append(cfg)
    return out


def test_video_reads_equal_jax(corpus):
    path = str(corpus / "v0.avi")
    assert vio.video_info(path) == jvio.video_info(path)
    idx = [0, 5, 5, 17, 39]
    np.testing.assert_array_equal(vio.read_video_indices(path, idx),
                                  jvio.read_video_indices(path, idx))
    (a, fa), (b, fb_) = vio.read_video_range(path, 3, 20, 3), jvio.read_video_range(path, 3, 20, 3)
    np.testing.assert_array_equal(a, b)
    assert fa == fb_ and a.shape[0] == 6
    with pytest.raises(vio.DecodeError):
        vio.video_info(str(corpus / "missing.avi"))


@pytest.mark.parametrize("spatial_idx", [-1, 0, 1, 2])
def test_spatial_sampling_equals_jax(spatial_idx):
    frames = np.random.RandomState(1).rand(3, 3, 48, 70).astype(np.float32)
    scale = (40, 60) if spatial_idx == -1 else (44, 44)
    crop = 36 if spatial_idx == -1 else 44
    outs = []
    for mod in (ptr, jtr):
        rng = np.random.RandomState(5)
        outs.append([mod.spatial_sampling(frames, rng, spatial_idx, *scale, crop)
                     for _ in range(4)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    rng_p, rng_j = np.random.RandomState(2), np.random.RandomState(2)
    np.testing.assert_array_equal(
        ptr.random_short_side_scale_jitter(frames, 30, 90, rng_p, True),
        jtr.random_short_side_scale_jitter(frames, 30, 90, rng_j, True))
    hwc = np.moveaxis(frames, 1, -1)  # channels-last, as the reference calls it
    np.testing.assert_array_equal(ptr.revert_tensor_normalize(hwc, [0.4] * 3, [0.2] * 3),
                                  jtr.revert_tensor_normalize(hwc, [0.4] * 3, [0.2] * 3))


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_clip_dataset_plain_modes_equal_jax(corpus, mode):
    """The plain clip (selective decode, normalize, spatial sampling) in
    every mode; the CSV's missing video is retried with the same draw.
    Test mode: NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS items a video."""
    pcfg, jcfg = _cfgs(corpus)
    port = pds.ClipDataset(pcfg, mode, seed=7)
    jax_ds = jds.ClipDataset(jcfg, mode, seed=7)
    assert len(port) == len(jax_ds) == (24 if mode == "test" else 4)
    assert port.labels == jax_ds.labels
    for i in range(len(port)):
        (pc, pl, pi, _), (jc, jl, ji, _) = port[i], jax_ds[i]
        assert (pl, pi) == (jl, ji)
        assert pc.dtype == np.float32 and pc.shape == (3, 4) + (
            (64, 64) if mode == "test" else (56, 56))
        np.testing.assert_array_equal(pc, jc)


def test_clip_dataset_refuses_what_is_not_ported(corpus):
    pcfg, _ = _cfgs(corpus)
    with pytest.raises(NotImplementedError, match="item 7"):
        pds.ClipDataset(pcfg, "train", get_flow=True)
    with pytest.raises(ValueError):
        pds.ClipDataset(pcfg, "eval")


@pytest.mark.parametrize("return_type,method,aug,probe,sharpen", [
    ("Indices", "adaptive", False, False, False),
    ("Indices", "adaptive", False, True, True),
    ("Indices", "uniform", False, True, False),
    ("Dict", "adaptive", True, False, False),
    ("Dict", "uniform", False, False, False),
    ("Tensor", "adaptive", False, False, True),
])
def test_frame_selection_dataset_equals_jax(corpus, return_type, method, aug, probe,
                                            sharpen):
    """Each return type; ``Dict`` on 72 x 96 frames takes the reference's
    zero-pad quirk (not 224 x 224)."""
    cfgs = _cfgs(corpus)
    for cfg in cfgs:
        cfg.LOSS_FILE = str(corpus / "loss.json")
    kw = dict(pre_sampling_rate=2, selection_method=method, num_frames=8,
              augmentations=aug, return_type=return_type, mode="sel", sharpen=sharpen,
              probe_only=probe)
    port, jax_ds = pds.FrameSelectionDataset(cfgs[0], **kw), jds.FrameSelectionDataset(cfgs[1], **kw)
    assert len(port) == len(jax_ds) == 6  # NUM_ENSEMBLE_VIEWS copies of each row
    for i in range(0, 6, 2):
        a, b = port[i], jax_ds[i]
        if return_type == "Dict":
            assert a["label"] == b["label"]
            np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
            assert a["pixel_values"].shape == (8, 3, 224, 224)
            continue
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_frame_selection_kinetics_subdir(corpus, tmp_path):
    """``cfg.DATASET == "Kinetics"`` reads the videos under ``<mode>/``."""
    (tmp_path / "test").mkdir()
    for i in range(3):
        (tmp_path / "test" / f"v{i}.avi").write_bytes((corpus / f"v{i}.avi").read_bytes())
    (tmp_path / "test.csv").write_text((corpus / "sel.csv").read_text())
    out = []
    for cfg, mod in zip(_cfgs(tmp_path), (pds, jds)):
        cfg.DATASET = "Kinetics"
        cfg.LOSS_FILE = str(corpus / "loss.json")
        ds = mod.FrameSelectionDataset(cfg, 2, "adaptive", 8, return_type="Indices")
        out.append([ds[i] for i in range(3)])
    assert out[0] == out[1]


def test_build_dataset_matches_jax(corpus):
    pcfg, jcfg = _cfgs(corpus)
    p = pds.build_dataset("ucf101", pcfg, "val", seed=3)
    j = jds.build_dataset("ucf101", jcfg, "val", seed=3)
    assert p._path_to_videos == j._path_to_videos and p.labels == j.labels
    np.testing.assert_array_equal(p[0][0], j[0][0])
    assert isinstance(pds.build_dataset("Kinetics400", pcfg, "test"), pds.ClipDataset)
    with pytest.raises(NotImplementedError, match="item 6"):
        pds.build_dataset("ssv2", pcfg, "train")
    with pytest.raises(ValueError):
        pds.build_dataset("nope", pcfg, "train")

    @pds.register_dataset("MyData")
    class Mine:
        def __init__(self, cfg, split, **kw):
            self.split = split

    assert pds.build_dataset("mydata", pcfg, "val").split == "val"
