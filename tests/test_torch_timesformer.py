"""The port's plain f32 TimeSformer and checkpoint code against the JAX
package, on the CPU, on the same weights and inputs (numpy arrays cross
between the frameworks).

Tolerance for the f32 forwards: atol = rtol = 1e-5 (JAX runs under
``jax.default_matmul_precision("highest")``; both sides are true f32 and
differ only in summation order, ~1e-6 on unit-scale features)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import convert as jconvert
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.utils import synthetic

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, img=32, num_frames=4, init="numpy"):
    kw = dict(img_size=img, patch_size=16, embed_dim=64, depth=2, num_heads=2,
              num_frames=num_frames, num_classes=0)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    if init == "numpy":
        params = jsyn.make_numpy_params(jcfg, seed=seed)
    else:
        params = jtsf.init_timesformer(jax.random.key(seed), jcfg)
    sd = convert.state_dict_from_jax_params(_np_tree(params), cfg)
    model = tsf.build_timesformer(cfg, sd, device="cpu")
    return params, jcfg, model


def _jax_features(params, x, jcfg, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jtsf.forward_features(
            params, jnp.asarray(x), jcfg, compute_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("T", [3, 8, 30])
def test_forward_features_f32_matches_jax(T):
    """Divided space-time forward at the scoring windows (3, 30) and the
    model's native 8, with the time embedding resized from 4 frames."""
    params, jcfg, model = _pair(seed=T)
    x = np.random.RandomState(T).randn(2, 3, T, 32, 32).astype(np.float32)
    want = _jax_features(params, x, jcfg)
    with torch.inference_mode():
        got = model.forward_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_forward_features_all_tokens_and_pos_resize():
    """get_all=True: every token in the reference order [CLS, (h w t)], on a
    64px input to a 32px model (the pos-embed nearest resize), with
    init_timesformer weights."""
    params, jcfg, model = _pair(seed=5, init="jax")
    x = np.random.RandomState(5).randn(1, 3, 5, 64, 64).astype(np.float32)
    want = _jax_features(params, x, jcfg, get_all=True)
    with torch.inference_mode():
        got = model.forward_features(torch.from_numpy(x), get_all=True).numpy()
    assert got.shape == want.shape == (1, 1 + 16 * 5, 64)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_make_numpy_params_bit_equal():
    cfg = jtsf.TimeSformerConfig(img_size=32, embed_dim=64, depth=2,
                                 num_heads=2, num_frames=4, num_classes=0)
    want = jax.tree.leaves(_np_tree(jsyn.make_numpy_params(cfg, seed=7)))
    got = jax.tree.leaves(synthetic.make_numpy_params(cfg, seed=7))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_make_video_bit_equal():
    np.testing.assert_array_equal(synthetic.make_video(3, 40, 32),
                                  jsyn.make_video(3, 40, 32))


def test_state_dict_matches_jax_export():
    cfg = jtsf.TimeSformerConfig(img_size=32, embed_dim=64, depth=2,
                                 num_heads=2, num_frames=4, num_classes=0)
    params = _np_tree(jtsf.init_timesformer(jax.random.key(1), cfg))
    want = jconvert.pytree_to_reference_state_dict(params, cfg)
    got = convert.state_dict_from_jax_params(params, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_svt_checkpoint_surgery_matches_jax(tmp_path):
    """A published-layout .pth ({teacher: {backbone.*}}) with spatial-only
    attention weights and 8 frames, loaded into a 16-frame model: the
    surgery (temporal bootstrap, time-embed resize) matches the JAX
    converter's."""
    cfg8 = jtsf.TimeSformerConfig(img_size=32, embed_dim=64, depth=2,
                                  num_heads=2, num_frames=8, num_classes=0)
    params = _np_tree(jsyn.make_numpy_params(cfg8, seed=2))
    sd = jconvert.pytree_to_reference_state_dict(params, cfg8)
    sd = {k: v for k, v in sd.items()
          if "temporal_attn" not in k and "temporal_norm1" not in k}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"teacher": {"backbone." + k: torch.from_numpy(v.copy())
                            for k, v in sd.items()}}, path)
    cfg16 = jtsf.TimeSformerConfig(img_size=32, embed_dim=64, depth=2,
                                   num_heads=2, num_frames=16, num_classes=0)
    want = jconvert.pytree_to_reference_state_dict(
        _np_tree(jconvert.convert_svt_checkpoint(path, cfg16)), cfg16)
    got = convert.convert_svt_checkpoint(path, cfg16)
    model = tsf.build_timesformer(tsf.TimeSformerConfig(
        img_size=32, embed_dim=64, depth=2, num_heads=2, num_frames=16,
        num_classes=0), got, device="cpu")
    assert model.time_embed.shape == (1, 16, 64)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k],
                                      err_msg=k)


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without a card, asking for the default
    device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tsf.TimeSformerConfig(img_size=32, embed_dim=64, depth=1,
                                num_heads=2, num_frames=4, num_classes=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsf.build_timesformer(cfg, {})
