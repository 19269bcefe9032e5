"""Checkpoint conversion and the K400 preprocessing against the JAX
package's:

* ``convert_hf_timesformer`` on a tiny HuggingFace TimeSformer saved here by
  ``transformers`` as ``model.safetensors`` and as ``pytorch_model.bin``,
  its ``time_embed`` resized 8 -> 16 frames: the port's state dict, mapped
  to JAX's pytree by ``jax_params_from_state_dict``, equals JAX's
  ``convert_hf_timesformer`` bit for bit; the port's logits at 8 frames
  match the HF model's (atol 3e-5, rtol 1e-4, JAX's own test's bound);
* the numpy safetensors reader bit for bit against ``safetensors.numpy``
  (F32, F16; ``__metadata__`` skipped) and, for BF16, which
  ``safetensors.numpy`` cannot load, against ``safetensors.torch``;
* the inverse pytree map: a round trip of both maps is the identity, and it
  equals JAX's ``timesformer_to_pytree``;
* ``hf_video_preprocess`` and ``pil_bilinear_resize`` bit for bit against
  JAX's (PIL's antialiased bilinear) on 240x320, 320x240, 360x480 and the
  upscaling 180x200 frames."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax

from dino_video_summarization_transformer_tpu.engine import classification as jcls
from dino_video_summarization_transformer_tpu.models import convert as jconvert
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.engine import classification as pcls
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

GEO = dict(img_size=32, patch_size=16, embed_dim=48, depth=2, num_heads=4, num_classes=5)


def _equal_trees(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import TimesformerConfig, TimesformerForVideoClassification

    hf_cfg = TimesformerConfig(
        image_size=32, patch_size=16, num_frames=8, hidden_size=48,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=192,
        num_labels=5, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0)
    torch.manual_seed(0)
    model = TimesformerForVideoClassification(hf_cfg).eval()
    with torch.no_grad():  # the zero-initialized embeddings made non-trivial
        emb = model.timesformer.embeddings
        for t in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
            t.normal_(std=0.02)
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(str(root / "st"), safe_serialization=True)
    model.save_pretrained(str(root / "bin"), safe_serialization=False)
    return model, root


@pytest.mark.parametrize("fmt,frames", [("st", 16), ("bin", 16), ("st", 8)])
def test_convert_hf_timesformer_matches_jax(hf_dirs, fmt, frames):
    _, root = hf_dirs
    path = str(root / fmt)
    assert (root / fmt / ("model.safetensors" if fmt == "st" else "pytorch_model.bin")).exists()
    sd = convert.convert_hf_timesformer(path, tsf.TimeSformerConfig(num_frames=frames, **GEO))
    assert sd["time_embed"].shape == (1, frames, 48)
    jcfg = jtsf.TimeSformerConfig(num_frames=frames, **GEO)
    _equal_trees(convert.jax_params_from_state_dict(sd, jcfg),
                 jconvert.convert_hf_timesformer(path, jcfg))


def test_hf_checkpoint_logits_match_hf(hf_dirs):
    model, root = hf_dirs
    cfg = tsf.TimeSformerConfig(num_frames=8, **GEO)
    port = tsf.build_timesformer(cfg, convert.convert_hf_timesformer(str(root / "st"), cfg),
                                 device="cpu")
    x = np.random.RandomState(0).randn(2, 8, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).logits.numpy()
    got = pcls.make_classifier_fn(port)(x).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_safetensors_reader_bit_equal(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load, save_file as torch_save

    r = np.random.RandomState(0)
    arrays = {"w32": r.randn(3, 5).astype(np.float32), "w16": r.randn(7).astype(np.float16),
              "i64": r.randint(-9, 9, (2, 2)).astype(np.int64)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got, want = convert.load_safetensors(str(tmp_path / "a.safetensors")), load_file(
        str(tmp_path / "a.safetensors"))
    assert set(got) == set(want) == set(arrays)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    bf = {"b": torch.randn(4, 6, dtype=torch.bfloat16), "s": torch.randn(3).bfloat16()}
    torch_save(bf, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    got, want = convert.load_safetensors(str(tmp_path / "b.safetensors")), torch_load(
        str(tmp_path / "b.safetensors"))
    for k in bf:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k].float().numpy())


def test_inverse_pytree_round_trips():
    cfg = tsf.TimeSformerConfig(num_frames=4, **GEO)
    jcfg = jtsf.TimeSformerConfig(num_frames=4, **GEO)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=1))
    sd = convert.state_dict_from_jax_params(params, cfg)
    back = convert.jax_params_from_state_dict(sd, cfg)
    _equal_trees(back, params)
    _equal_trees(back, jconvert.timesformer_to_pytree(sd, jcfg))
    again = convert.state_dict_from_jax_params(back, cfg)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k])
    import timesformer_finetuning as jcli  # the JAX CLI's npz key walk

    assert ([p for p, _ in convert.flatten_params(back)]
            == [p for p, _ in jcli._flatten(back)])


@pytest.mark.parametrize("hw", [(240, 320), (320, 240), (360, 480), (180, 200)])
def test_hf_preprocess_bit_equal_to_jax(hw):
    from PIL import Image

    frames = np.random.RandomState(hw[0]).randint(0, 256, (3, *hw, 3), dtype=np.uint8)
    got, want = pcls.hf_video_preprocess(frames), jcls.hf_video_preprocess(frames)
    assert got.shape == want.shape == (3, 3, 224, 224)
    np.testing.assert_array_equal(got, want)
    for size in ((224, 224), (int(hw[1] * 224 / hw[0]), 224), (97, 301)):
        np.testing.assert_array_equal(
            pcls.pil_bilinear_resize(frames[0], size),
            np.asarray(Image.fromarray(frames[0]).resize(size, Image.BILINEAR)))
