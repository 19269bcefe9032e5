"""The port's banded one-pass forward (``models/banded.py``) against the JAX
package's, and against the port's own windowed forward.

Sizes: D = 256, 4 heads, depth 2, 32 x 32 frames (N = 4 patches), chunks
of 64 frames (t_real 64 or 50), windows eff in {3, 30}.

Tolerances:
* plain f32 route vs JAX's XLA banded forward under "highest":
  atol = rtol = 1e-5 on the final-LN CLS features (f32 in both, summation
  order differs);
* degenerate window (T == eff, zero time embedding): the banded pass equals
  the windowed forward for every frame, atol 3e-5, rtol 1e-4 (the JAX
  package's own bound in tests/test_banded.py: the two compute the same
  sums in another order);
* bf16 kernel route (the kernels' plain twins on CPU tensors) vs JAX's bf16
  forward with the Pallas kernels (interpret mode): atol = rtol = 5e-2, and
  mean|port - f32| <= 1.1 * mean|pallas - f32| + 1e-3 (the bounds of
  tests/test_torch_fused_block.py; the port follows the XLA-path
  numerics, the Pallas kernels clamp logits, sum denominators on the MXU
  and use tanh GELU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import banded as jbanded
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import banded
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb

KW = dict(img_size=32, patch_size=16, embed_dim=256, depth=2, num_heads=4,
          num_frames=8, num_classes=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed, zero_te=False, **port_kw):
    """numpy-seeded params as the JAX pytree and a port model built from the
    same numbers (f32 unless ``dtype`` is given)."""
    jcfg = jtsf.TimeSformerConfig(**KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    if zero_te:
        params = dict(params, time_embed=np.zeros_like(params["time_embed"]))
    dtype = port_kw.pop("dtype", torch.float32)
    cfg = tsf.TimeSformerConfig(**KW, **port_kw)
    model = tsf.build_timesformer(
        cfg, convert.state_dict_from_jax_params(params, cfg), device="cpu",
        dtype=dtype)
    return params, jcfg, model


def _frames(C, seed):
    return np.random.RandomState(seed).randn(C, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("C,t_real,eff", [(64, 64, 30), (64, 50, 30),
                                          (64, 50, 3), (40, 40, 3)])
def test_f32_banded_forward_matches_jax_xla(C, t_real, eff):
    params, jcfg, model = _models(seed=eff)
    fr = _frames(C, seed=C + t_real)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jbanded.banded_cls_features(
            jax.tree.map(jnp.asarray, params), jnp.asarray(fr), t_real, jcfg,
            eff=eff, block=32))
    with torch.inference_mode():
        got = banded.banded_cls_features(model, torch.from_numpy(fr), t_real,
                                         eff, block=32).numpy()
    assert got.shape == (C, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("eff,block", [(3, 4), (8, 4)])
def test_degenerate_window_equals_windowed_forward(eff, block):
    """T == eff: every frame's window is the whole clip, so with a constant
    time embedding the banded pass reproduces the windowed forward's CLS
    feature for every frame (the port's version of tests/test_banded.py)."""
    _, _, model = _models(seed=1, zero_te=True)
    fr = _frames(eff, seed=2)
    clip = torch.from_numpy(fr.transpose(3, 0, 1, 2)[None].copy())
    with torch.inference_mode():
        ref = model(clip).numpy()  # (1, D)
        got = banded.banded_cls_features(model, torch.from_numpy(fr), eff,
                                         eff, block=block).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(ref, got.shape),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("T,C_pad,block", [(10, 16, 4), (20, 64, 32)])
def test_padding_rows_never_leak(T, C_pad, block):
    """Valid rows of a padded chunk equal the unpadded pass. (20, 64) is a
    short clip in the smallest scoring bucket: there the JAX package's XLA
    slab misses the end-clamped windows of the padded query block, and its
    NaN rows leak into every valid row (ROADMAP section 3)."""
    _, _, model = _models(seed=3)
    eff = 3
    fr = _frames(T, seed=4)
    padded = np.concatenate([fr, np.repeat(fr[-1:], C_pad - T, axis=0)])
    with torch.inference_mode():
        a = banded.banded_cls_features(model, torch.from_numpy(fr), T, eff,
                                       block=2)
        b = banded.banded_cls_features(model, torch.from_numpy(padded), T,
                                       eff, block=block)
    assert torch.isfinite(b).all()
    torch.testing.assert_close(a, b[:T], atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("t_real,eff", [(64, 30), (50, 3)])
def test_bf16_kernel_route_matches_pallas_forward(t_real, eff):
    C = 64
    params, jcfg, model = _models(seed=5 + eff, dtype=torch.bfloat16,
                                  use_kernels=True)
    fr = _frames(C, seed=eff)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jbanded.banded_cls_features(
            jax.tree.map(jnp.asarray, params), jnp.asarray(fr), t_real, jcfg,
            eff=eff))
    pallas = np.asarray(jbanded.banded_cls_features(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(fr, jnp.bfloat16), t_real,
        dataclasses.replace(jcfg, use_fused=True), eff=eff,
        compute_dtype=jnp.bfloat16))
    before = (dict(bb.launches), dict(fb.launches))
    with torch.inference_mode():
        got = banded.banded_cls_features(model, torch.from_numpy(fr), t_real,
                                         eff).numpy()
    assert (dict(bb.launches), dict(fb.launches)) == before  # twins on CPU
    got, pallas, oracle = got[:t_real], pallas[:t_real], oracle[:t_real]
    np.testing.assert_allclose(got, pallas, atol=5e-2, rtol=5e-2)
    e_port = np.abs(got - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)
