"""The port's copies of the JAX package's jax-free host modules (windows,
selection, the scoring dataset, the loader, the config tree) and its
scoring loss, against the JAX package's, on the same inputs.

Host modules are copies: their outputs must be equal, index for index.
The loss is f32 arithmetic in two frameworks: atol = rtol = 1e-6.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import conftest

import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.config import parser as jparser
from dino_video_summarization_transformer_tpu.data import datasets as jds
from dino_video_summarization_transformer_tpu.data import loader as jloader
from dino_video_summarization_transformer_tpu.data import selection as jsel
from dino_video_summarization_transformer_tpu.data import video as jvio
from dino_video_summarization_transformer_tpu.data import windows as jwin
from dino_video_summarization_transformer_tpu.train import dino as jdino
from dino_video_summarization_transformer_tpu_torch.config import parser
from dino_video_summarization_transformer_tpu_torch.data import (
    datasets, loader, selection, video as vio, windows)
from dino_video_summarization_transformer_tpu_torch.train import dino

CFG_YAML = os.path.join(conftest.REPO_ROOT,
                        "configs/kinetics/timesformer_divst_8x32_224.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("T", [1, 2, 3, 7, 12, 29, 30, 31, 64])
def test_window_indices_match_jax(T):
    try:
        want = jwin.window_indices(T, 3, 30)
    except jwin.WindowMismatch:
        with pytest.raises(windows.WindowMismatch):
            windows.window_indices(T, 3, 30)
        return
    got = windows.window_indices(T, 3, 30)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("sharpen", [False, True])
def test_selection_matches_jax(sharpen):
    r = np.random.RandomState(int(sharpen))
    for n in (8, 16):
        losses = r.rand(40) ** 4  # skewed: forces duplicate resolution
        args = (losses, n, 4, 40, 160)
        assert (selection.adaptive_indices(*args, sharpen=sharpen)
                == jsel.adaptive_indices(*args, sharpen=sharpen))
        assert selection.uniform_indices(n, 40) == jsel.uniform_indices(n, 40)
        idx = list(range(n - 3))
        assert (selection.pad_indices(idx, n, 5)
                == jsel.pad_indices(idx, n, 5))


def test_scoring_dino_loss_matches_jax():
    r = np.random.RandomState(0)
    s = r.randn(8, 768).astype(np.float32)
    t = r.randn(8, 768).astype(np.float32)
    c = r.randn(768).astype(np.float32) * 0.1
    for center in (None, c):
        got = dino.scoring_dino_loss(
            torch.from_numpy(s), torch.from_numpy(t),
            None if center is None else torch.from_numpy(center))
        want = jdino.scoring_dino_loss(
            jnp.asarray(s), jnp.asarray(t),
            None if center is None else jnp.asarray(center))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def _args(*opts):
    return argparse.Namespace(cfg_file=CFG_YAML, opts=list(opts))


def _plain(cfg):
    return json.loads(json.dumps(cfg, default=str))


def test_load_config_matches_jax(tmp_path):
    args = _args("DATA.PATH_TO_DATA_DIR", str(tmp_path),
                 "TEST.NUM_ENSEMBLE_VIEWS", "1", "DATA.NUM_FRAMES", "16")
    got = _plain(parser.load_config(args))
    assert got == _plain(jparser.load_config(args))
    assert got["DATA"]["NUM_FRAMES"] == 16


def test_loader_matches_jax():
    assert np.array_equal(loader.shard_indices(11, 2, 3),
                          jloader.shard_indices(11, 2, 3))
    assert np.array_equal(loader.shard_indices(11, 1, 3, shuffle=True, seed=4),
                          jloader.shard_indices(11, 1, 3, shuffle=True, seed=4))
    data = [i * i for i in range(20)]
    for workers in (1, 3):
        assert list(loader.PrefetchLoader(data, indices=range(3, 17),
                                          num_workers=workers)) == data[3:17]


def _fake_read_video(path):
    """Decoded-video stand-in keyed by file name: a normal clip, a short
    clip with ragged windows (odd T < 30) and an undersized frame."""
    name = os.path.basename(path)
    T, h, w = {"clip": (40, 240, 320), "odd": (7, 256, 256),
               "tiny": (12, 100, 100)}[name.split(".")[0]]
    r = np.random.RandomState(len(name) + T)
    return r.randint(0, 256, (T, h, w, 3), dtype=np.uint8), 30.0


def _fake_decoder(decode_error):
    def read_video(path, stride=1, **kw):
        if os.path.basename(path).startswith("bad"):
            raise decode_error("corrupt")
        return _fake_read_video(path)
    return read_video


def test_dino_loss_dataset_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "test.csv").write_text(
        "clip.mp4 0\nodd.mp4 1\ntiny.mp4 2\nbad.mp4 3\n")
    args = _args("DATA.PATH_TO_DATA_DIR", str(tmp_path),
                 "DATA.PATH_PREFIX", str(tmp_path), "TEST.NUM_ENSEMBLE_VIEWS", "1")
    items = {}
    for tag, mod, vmod, cfgmod in [("jax", jds, jvio, jparser),
                                   ("port", datasets, vio, parser)]:
        monkeypatch.setattr(vmod, "read_video",
                            _fake_decoder(vmod.DecodeError))
        ds = mod.DinoLossDataset(cfgmod.load_config(args), "test", 3, 30, 4)
        items[tag] = [ds[i] for i in range(len(ds))]
    assert len(items["port"]) == len(items["jax"]) == 4
    for got, want in zip(items["port"], items["jax"]):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
    assert [it["dummy"] for it in items["port"]] == [False, True, True, True]
