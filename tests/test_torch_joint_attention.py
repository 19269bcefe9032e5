"""The space-only and joint space-time TimeSformers of the port against the
JAX package's (``joint_block``, the ``attention_type`` branches of
``forward_features``), on the same numpy weights, and the gates that keep
them on the plain route.

Tolerances: forwards and the f32 train step's loss and gradients at
max|diff| <= 1e-5 x max|JAX| (JAX at ``precision="highest"``); the
converter both ways exact; the windowed scorer's f32 losses 1e-5 of JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import conftest

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.config import load_config as jload_config
from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import heads as jheads
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.train import dino as jdino
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.config import load_config
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.train import ssl
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

TYPES = ["space_only", "joint_space_time"]
OUT = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _kw(at, **kw):
    return dict(dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                     num_frames=4, num_classes=0, attention_type=at), **kw)


def _jax_params(jcfg, seed=0):
    """``make_numpy_params`` without the leaves the config does not build
    (JAX ``init_timesformer``: no temporal half; space-only: no
    ``time_embed``)."""
    p = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    for k in ("temporal_norm1", "temporal_attn", "temporal_fc"):
        p["blocks"].pop(k)
    if jcfg.attention_type == "space_only":
        p.pop("time_embed")
    if jcfg.num_classes:
        r = np.random.RandomState(seed + 100)
        p["head"] = {"kernel": (0.02 * r.randn(jcfg.embed_dim, jcfg.num_classes)
                                ).astype(np.float32),
                     "bias": (0.01 * r.randn(jcfg.num_classes)).astype(np.float32)}
    return p


def _pair(at, seed=0, **kw):
    jcfg = jtsf.TimeSformerConfig(**_kw(at, **kw))
    jp = _jax_params(jcfg, seed)
    cfg = tsf.TimeSformerConfig(**_kw(at, **kw))
    model = tsf.TimeSformer(cfg)
    model.load_reference_state_dict(convert.state_dict_from_jax_params(jp, cfg))
    return jcfg, jp, cfg, model


@pytest.mark.parametrize("at", TYPES)
@pytest.mark.parametrize("T,px", [(4, 32), (3, 48)])
def test_forward_matches_jax(at, T, px):
    """CLS features, ``get_all`` (space-only's per-frame mean included)
    and the head, at the config's geometry and at another frame count and
    size (time-embed and pos-embed resizes)."""
    jcfg, jp, cfg, model = _pair(at, num_classes=3)
    x = np.random.RandomState(1).randn(2, 3, T, px, px).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        for get_all in (False, True):
            want = jtsf.forward_features(jp, jnp.asarray(x), jcfg, get_all=get_all)
            got = model.forward_features(torch.from_numpy(x), get_all=get_all)
            assert got.shape == want.shape and _rel(got.numpy(), want) <= 1e-5, get_all
        want = jtsf.forward(jp, jnp.asarray(x), jcfg, use_head=True)
        assert _rel(model(torch.from_numpy(x), use_head=True).numpy(), want) <= 1e-5
    n = 1 + (px // 16) ** 2 * (T if at == "joint_space_time" else 1)
    assert got.shape == (2, n, 128)


@pytest.mark.parametrize("at", TYPES)
def test_layout_and_converter_both_ways(at):
    """The blocks hold no temporal half; space-only no ``time_embed``; the
    converter carries the layout both ways leaf for leaf."""
    jcfg, jp, cfg, model = _pair(at)
    sd = model.state_dict()
    assert not any("temporal" in k for k in sd)
    assert ("time_embed" in sd) == (at == "joint_space_time")
    back = convert.jax_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, b)
    init = tsf.init_timesformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(init.state_dict()) == set(sd)
    with pytest.raises(ValueError, match="attention_type"):
        tsf.TimeSformer(dataclasses.replace(cfg, attention_type="divided"))


@pytest.mark.parametrize("at", TYPES)
def test_f32_step_matches_jax(at):
    """The DINO loss and every gradient at f32 (one train step's first
    half), then a whole step runs with its teacher EMA."""
    jcfg, jp, cfg, model = _pair(at, seed=2, num_frames=2)
    head = make_numpy_head_params(128, OUT, seed=3)
    r = np.random.RandomState(4)
    g = r.randn(2, 3, 2, 32, 32).astype(np.float32)
    l = r.randn(2, 3, 2, 48, 48).astype(np.float32)

    def loss_fn(student, g, l):
        fwd = lambda p, x: jtsf.forward(p, x, jcfg)  # noqa: E731
        s = jheads.dino_head_forward(student["head"], jnp.concatenate(
            [fwd(student["backbone"], g), fwd(student["backbone"], l)]))
        t = jax.lax.stop_gradient(jheads.dino_head_forward(
            student["head"], fwd(student["backbone"], g)))
        return jdino.dino_loss(s, t, jnp.zeros((1, OUT)), 0.04, n_crops=4)[0]

    js = jax.tree.map(jnp.asarray, {"backbone": jp, "head": head})
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(js, g, l)
    state, core, mask = ssl.init_train_state(
        cfg, out_dim=OUT, device="cpu",
        pretrained_backbone=convert.state_dict_from_jax_params(jp, cfg),
        head_state_dict=convert.head_state_dict_from_jax(head))
    step = ssl.make_train_step(cfg, core, mask, n_local_crops=2,
                               compute_dtype=torch.float32)
    assert step.route == "plain"
    batch = (torch.from_numpy(g), torch.from_numpy(l))
    ploss, _, pgrads = step.loss_and_grads(state, *batch, 0.04)
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    want = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, grads["backbone"]), cfg).items()}
    want.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
        jax.tree.map(np.asarray, grads["head"])).items()})
    assert set(want) == set(pgrads)
    for n, w in want.items():
        assert _rel(pgrads[n].numpy(), w) <= 1e-5, n
    state, m = step(state, *batch, 1e-4, 0.04, 0.996, 0.04, False)
    assert np.isfinite(float(m["loss"])) and state.step == 1


@pytest.mark.parametrize("at", TYPES)
def test_bf16_train_and_remat_run_plain(at):
    """bf16 compute on the plain route against f32 (a forward and the
    loss), remat bit for bit; every kernel gate sends the model plain."""
    jcfg, jp, cfg, model = _pair(at, seed=5, num_frames=2)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 2, 32, 32).astype(np.float32))
    f32 = model.forward_train(x)
    bf = model.forward_train(x, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert _rel(bf.float().detach().numpy(), f32.detach().numpy()) < 0.05
    assert torch.equal(model.forward_train(x, remat=True), f32)
    assert tsf.train_route(cfg, torch.bfloat16) == "plain"
    assert not tsf.eval_kernels(cfg, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="gate"):
        tsf.train_route(cfg, torch.bfloat16, "kernels")
    with pytest.raises(ValueError, match="plain route only"):
        model.forward_train(x, torch.bfloat16, route="kernels")
    # use_kernels is ignored, as JAX's glue-free gate ignores use_fused
    k = tsf.TimeSformer(dataclasses.replace(cfg, use_kernels=True))
    k.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(k.forward_features(x), model.forward_features(x))


def test_repo_configs_build_both_models():
    """The repo's space-only and joint YAMLs through ``config_from_cfg`` in
    both packages: the same configs, and a model of each builds."""
    for name, at in (("timesformer_spaceonly_8x32_224.yaml", "space_only"),
                     ("timesformer_jointst_8x32_224.yaml", "joint_space_time")):
        class A:
            cfg_file = os.path.join(conftest.REPO_ROOT, "configs/kinetics", name)
            opts = None
        pc = tsf.config_from_cfg(load_config(A()), no_head=True, arch="vit_tiny")
        jc = jtsf.config_from_cfg(jload_config(A()), no_head=True, arch="vit_tiny")
        assert pc.attention_type == jc.attention_type == at
        assert dataclasses.asdict(pc).items() >= {
            k: v for k, v in dataclasses.asdict(jc).items()
            if k in dataclasses.asdict(pc)}.items()
        assert not hasattr(tsf.TimeSformer(pc).blocks[0], "temporal_attn")


@pytest.mark.parametrize("at", TYPES)
def test_scorer_runs_plain_like_jax(at):
    """JAX's ``FrameScorer`` scores a space-only / joint model on its XLA
    path (the glue-free gate refuses it, even with ``use_pallas=True``); the
    port's scorer runs the plain route with no kernel (``use_kernels=True``
    is overridden) and matches JAX's f32 losses; ``band_mode`` is refused,
    where JAX's banded forward raises KeyError."""
    from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
    from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb

    jcfg, jp, cfg, model = _pair(at, num_frames=8)
    sd = convert.state_dict_from_jax_params(jp, cfg)
    T = 10
    frames = np.random.RandomState(7).randn(T, 32, 32, 3).astype(np.float32)
    loc, glob, eff = window_indices(T, 3, 6)
    geo = dict(local_size=3, global_size=6, chunk=4)
    want = jscoring.FrameScorer(jax.tree.map(jnp.asarray, jp), jcfg, use_pallas=True,
                                **geo).score_video(frames, loc, glob, eff)
    ps = scoring.FrameScorer(sd, cfg, use_kernels=True, device="cpu", **geo)
    assert not ps.model_cfg.use_kernels
    before = dict(fb.launches)
    got = ps.score_video(frames, loc, glob, eff)
    assert fb.launches == before
    assert got.shape == (T,) and _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="band_mode"):
        scoring.FrameScorer(sd, cfg, band_mode="both", device="cpu", **geo)
