"""The TP-fused forward (``parallel.tp_fused.tp_fused_forward_features``:
the head-sharded per-phase ops, the partial tier of rows 1 and 4 with
their backwards 7p and 8p, row 3 at ``residual=False``) and its
checkpoint, in a spawned world of 2 ranks (gloo over a ``FileStore``).

* Forward and gradients at tp = 2 against JAX's ``tp_fused_forward_features``
  on ``build_mesh(data=1, model=2)`` of its virtual CPU mesh (Pallas in
  interpret mode), f32 compute as JAX's ``tests/test_tp_fused.py`` runs
  it, on JAX's setup there (D 256, 4 heads, depth 2, img 32, T 4, B 4):
  features within 8e-3 of their max, each gradient (gathered into the
  single-card layout, qkv unpermuted) within 2e-2 of its max: the bounds
  of that test (measured 3.2e-3 and 1.0e-2: the Pallas kernels' +/-80
  clamp, tanh GELU and ones-column denominators against the twins'
  max-subtracting softmax and erf GELU).
* Two TP-fused train steps whose checkpoint rank 0 writes: it holds the
  single-card layout, reloads into a one-card ``TrainState`` equal to the
  world's gathered state, and sits within 2 x 2.1 x lr of the one-card
  f32 step's parameters (Adam's sign-like first steps; the port's
  single-card test bound per step), with the same step count, a center
  within 8e-3 of its max (the features' bound: it is a mean of the
  teacher's outputs; measured 2.4e-3) and each step's loss within 2e-3
  relative (JAX's TP-fused step bound).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.parallel import build_mesh, tp_sharding_tree
from dino_video_summarization_transformer_tpu.parallel.tp_fused import (
    permute_qkv_tree, tp_fused_forward_features, unpermute_qkv_tree)
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.parallel import launch, worlds
from dino_video_summarization_transformer_tpu_torch.parallel.state import flat_state
from dino_video_summarization_transformer_tpu_torch.train import ssl
from dino_video_summarization_transformer_tpu_torch.utils.checkpoint import (
    restore_checkpoint)
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

FWD_KW = dict(embed_dim=256, depth=2, num_heads=4, img_size=32, num_frames=4, num_classes=0)
STEP_KW = dict(FWD_KW, depth=1, num_frames=2)
OUT, B, N_LOCAL, LR = 128, 4, 2, 1e-3
HYPER = [(LR, 1e-4, 0.99, 0.04, False), (LR, 1e-4, 0.99, 0.04, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backbone(kw, seed):
    return jax.tree.map(np.asarray, jsyn.make_numpy_params(jtsf.TimeSformerConfig(**kw),
                                                           seed=seed))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 2: the forward and its gradients, then two TP-fused
    train steps and their checkpoint; the one-card f32 step beside it."""
    params = _backbone(FWD_KW, 0)
    x = np.random.RandomState(1).randn(4, 3, 4, 32, 32).astype(np.float32)
    step_bb = _backbone(STEP_KW, 2)
    r = np.random.RandomState(3)
    step_spec = dict(
        cfg=STEP_KW, out_dim=OUT, n_local=N_LOCAL, hyper=HYPER,
        backbone=convert.state_dict_from_jax_params(step_bb, tsf.TimeSformerConfig(**STEP_KW)),
        head=convert.head_state_dict_from_jax(make_numpy_head_params(256, OUT, seed=4)),
        crops=[(r.randn(2 * B, 3, 2, 32, 32).astype(np.float32),
                r.randn(N_LOCAL * B, 3, 2, 32, 32).astype(np.float32)) for _ in HYPER])
    ckpt = str(tmp_path_factory.mktemp("tp_fused") / "checkpoint")
    fwd, steps = launch.run_world(worlds.run_calls, 2, [
        (worlds.tp_features_and_grads, dict(
            cfg=FWD_KW, x=x, compute_dtype="float32",
            backbone=convert.state_dict_from_jax_params(params, tsf.TimeSformerConfig(**FWD_KW)))),
        (worlds.sharded_steps, dict(step_spec, mode="tp_fused", mesh=(1, 2), grads=False,
                                    checkpoint=ckpt))])[0]
    one = worlds.sharded_steps(0, 1, dict(step_spec, mode="one", grads=False))
    return {"params": params, "x": x, "fwd": fwd, "steps": steps, "one": one, "ckpt": ckpt}


def test_tp_fused_forward_and_grads_match_jax(runs):
    cfg = jtsf.TimeSformerConfig(**FWD_KW)
    mesh = build_mesh(data=1, model=2, devices=jax.devices()[:2])
    pp = permute_qkv_tree(jax.tree.map(jnp.asarray, runs["params"]), 4, 2)
    pp = jax.device_put(pp, tp_sharding_tree(pp, mesh))

    def f(p):
        return tp_fused_forward_features(p, jnp.asarray(runs["x"]), cfg, mesh,
                                         compute_dtype=jnp.float32)

    want = np.asarray(f(pp))
    jg = unpermute_qkv_tree(jax.grad(lambda p: jnp.sum(f(p) ** 2))(pp), 4, 2)
    jg = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jg),
                                            tsf.TimeSformerConfig(**FWD_KW))
    got = runs["fwd"]["features"]
    assert got.shape == want.shape == (4, 256)
    assert np.abs(got - want).max() <= 8e-3 * np.abs(want).max()
    grads = runs["fwd"]["grads"]
    assert set(grads) == set(jg)
    for n, v in jg.items():
        assert np.abs(grads[n] - v).max() <= 2e-2 * (np.abs(v).max() + 1e-6), n


def test_tp_fused_checkpoint_is_the_single_card_state(runs):
    cfg = tsf.TimeSformerConfig(**STEP_KW)
    template, _, _ = ssl.init_train_state(cfg, out_dim=OUT, device="cpu", seed=9)
    restored, run_vars = restore_checkpoint(runs["ckpt"], template)
    assert int(run_vars["epoch"]) == 1 and restored.step == len(HYPER)
    flat = {k: v.float().numpy() for k, v in flat_state(restored).items()}
    gathered, one = runs["steps"]["state"], runs["one"]["state"]
    assert set(flat) == set(gathered) == set(one)
    for k, v in gathered.items():  # the checkpoint is the gathered state, unpermuted
        assert np.array_equal(flat[k], v), k
        assert flat[k].shape == one[k].shape, k
    tol = 2 * 2.1 * LR
    for k, v in one.items():
        if k.startswith(("student.", "teacher.")):
            assert np.abs(flat[k] - v).max() <= tol, k
    # the center: a mean of the teacher's outputs, held as the features are
    assert np.abs(flat["center"] - one["center"]).max() <= 8e-3 * np.abs(one["center"]).max()
    # the losses of the two steps, as JAX's TP-fused step against its plain one
    for got, want in zip(runs["steps"]["loss"], runs["one"]["loss"]):
        assert abs(got - want) <= 2e-3 * abs(want)
