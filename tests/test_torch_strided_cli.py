"""The port CLI's strided scoring against the JAX package's run_scoring,
on the CPU: ``--teacher_stride 8 --teacher_interp catmullrom
--teacher_refine 0.035`` at f32 on a two-video CSV writes the loss JSON
JAX's ``run_scoring`` writes for the same configuration (atol = rtol =
1e-5, as tests/test_torch_scoring.py::test_run_scoring_json_matches_jax
holds the exact windows). Skipped where the native decode shim is not
built."""

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

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_strided_json_matches_jax_run_scoring(tmp_path):
    """The port CLI with --teacher_stride 8 --teacher_interp catmullrom
    --teacher_refine 0.035 at f32 on a two-video CSV (vit_tiny on the
    dataset's 224-px crops, 8-frame teacher windows to keep it small),
    against JAX's run_scoring over JAX's dataset with the same checkpoint
    and knobs."""
    from dino_video_summarization_transformer_tpu.config import load_config as jload
    from dino_video_summarization_transformer_tpu.data import video as jvio
    from dino_video_summarization_transformer_tpu.data.datasets import (
        DinoLossDataset as JDataset)
    from dino_video_summarization_transformer_tpu.models import convert as jconvert
    from dino_video_summarization_transformer_tpu_torch import dino_similarity as cli
    from dino_video_summarization_transformer_tpu_torch.data import video as vio

    if not vio.native_available():
        pytest.skip("native decode shim not built")
    rng = np.random.RandomState(0)
    fr = rng.randint(0, 256, (17, 232, 240, 3), dtype=np.uint8)
    jvio.write_video(str(tmp_path / "vidA.avi"), fr[:10], fps=30)
    jvio.write_video(str(tmp_path / "vidB.avi"), fr, fps=30)
    (tmp_path / "test.csv").write_text("vidA.avi 0\nvidB.avi 0\n")
    jcfg = jtsf.vit_tiny_config(num_frames=8, num_classes=0)
    ckpt = str(tmp_path / "ckpt.pth")
    jconvert.save_reference_checkpoint(
        ckpt, jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=0)), jcfg)
    out, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    argv = ["--cfg", os.path.join(conftest.REPO_ROOT,
                                  "configs/kinetics/timesformer_divst_8x32_224.yaml"),
            "--pretrained_weights", ckpt, "--checkpoint_key", "teacher",
            "--arch", "vit_tiny", "--batch_size_per_gpu", "8", "--global_clip_size", "8",
            "--sampling_rate", "1", "--num_workers", "1", "--file_path", out,
            "--teacher_stride", "8", "--teacher_interp", "catmullrom",
            "--teacher_refine", "0.035", "--device", "cpu",
            "--opts", "DATA.PATH_TO_DATA_DIR", str(tmp_path), "DATA.PATH_PREFIX",
            str(tmp_path), "TEST.NUM_ENSEMBLE_VIEWS", "1"]
    cli.main(argv)

    parsed = cli.get_args_parser().parse_args(argv)
    cfg_node = jload(parsed)
    jm = jtsf.config_from_cfg(cfg_node, no_head=True, arch="vit_tiny")
    params = jconvert.convert_svt_checkpoint(ckpt, jm, checkpoint_key="teacher")
    ds = JDataset(cfg=cfg_node, mode="test", local_clip_size=3, global_clip_size=8,
                  sampling_rate=1)
    jscoring.run_scoring(ds, jscoring.make_scorers(
        params, jm, local_size=3, global_size=8, chunk=8, compute_dtype=jnp.float32,
        precision="highest", teacher_stride=8, teacher_interp="catmullrom",
        teacher_refine=0.035), jout, num_workers=1, log_every=0)
    got, want = json.load(open(out)), json.load(open(jout))
    assert set(got) == set(want) == {"vidA", "vidB"}
    assert [len(got[k]) for k in ("vidA", "vidB")] == [10, 17]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
