"""The port's DINO trainer variants against the JAX package's, on the same
numpy-seeded weights (crossed by the port's ``convert``) and crops: the
two-token step (aux-token backbone, dual head, ``dino_loss_two_token``),
the rand-fr step (``make_rand_fr_train_step``), rematerialized students
(``make_train_step(remat=True)``), the data variants of ``ClipDataset``
and ``VideoDataAugmentationDINO``, and the CLI's flags for them.

Tolerances, those of ``tests/test_torch_train_step.py``:
* losses and centers of ``dino_loss_two_token``: max|diff| <= 1e-6 x
  max|JAX|;
* the aux-token forward at f32: max|diff| <= 1e-5 x max|JAX|;
* each f32 step (``precision="highest"`` in JAX): loss <= 1e-5 relative;
  each gradient max|diff| <= 1e-4 x its max; student parameters within
  2.1e-4 after one step (Adam's first step is sign-like on gradients near
  zero); teacher and center <= 1e-6;
* the bf16 kernel-route rand-fr step (twins on the CPU) against JAX's
  ``use_fused=True`` step (Pallas in interpret mode): per leaf max|diff| /
  max|JAX| < 0.15, and the port's mean distance to the f32 gradients <=
  1.5 x JAX's + 1e-6;
* remat against non-remat in the port: bit for bit, on the plain and the
  kernel route;
* the data variants: bit for bit (the same ``RandomState`` draws).

The two-token tests run JAX's self-consistent crops (``tests/
test_sharding.py``): 64 px teacher and 224-px-role views, 48 px for the
96-px-role crops, where the reference's integer-truncated pos-embed resize
keeps the grid's height (W > 2).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.data import datasets as jds
from dino_video_summarization_transformer_tpu.data import transform as jtr
from dino_video_summarization_transformer_tpu.models import heads as jheads
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.train import dino as jdino
from dino_video_summarization_transformer_tpu.train import optim as joptim
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.config import defaults
from dino_video_summarization_transformer_tpu_torch.data import datasets as pds
from dino_video_summarization_transformer_tpu_torch.data import transform as ptr
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.train import dino, ssl
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          num_frames=2, num_classes=0)
KW2 = dict(KW, img_size=64)  # the two-token tests' model
OUT = 64
HP = (1e-4, 0.04, 0.996, 0.04, False)  # lr, wd, teacher momentum, temp, freeze


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _jax_student(kw, seed, two_token=False):
    jcfg = jtsf.TimeSformerConfig(**kw)
    backbone = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    head = make_numpy_head_params(kw["embed_dim"], OUT, seed=seed + 1)
    if two_token:
        r = np.random.RandomState(seed + 2)
        D = kw["embed_dim"]
        backbone["aux_cls_token"] = (0.02 * r.randn(1, 1, D)).astype(np.float32)
        backbone["pos_embed"] = (0.02 * r.randn(1, jcfg.num_patches + 2, D)).astype(
            np.float32)
        aux = make_numpy_head_params(D, OUT, seed=seed + 3)
        head = {"mlp": head["mlp"], "aux_mlp": aux["mlp"],
                "last_layer": head["last_layer"], "aux_last_layer": aux["last_layer"]}
    return jcfg, {"backbone": backbone, "head": head}


def to_port(tree, cfg):
    """JAX student-shaped pytree (params or grads) -> port names."""
    sd = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, tree["backbone"]), cfg).items()}
    sd.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
        jax.tree.map(np.asarray, tree["head"])).items()})
    return sd


def _port_state(js, cfg, two_token=False):
    return ssl.init_train_state(
        cfg, out_dim=OUT, pretrained_backbone=convert.state_dict_from_jax_params(
            js["backbone"], cfg),
        head_state_dict=convert.head_state_dict_from_jax(js["head"]),
        device="cpu", two_token=two_token)


def _jax_step_run(jstep, js, center, *batch):
    """One JAX step from ``js``: (loss, state after)."""
    core, mask = joptim.build_optimizer("adamw", js)
    st = jssl.TrainState(js, jax.tree.map(jnp.copy, js), center, core.init(js),
                         jnp.zeros((), jnp.int32))
    st, metrics = jstep(core, mask)(st, *batch, *HP)
    return float(metrics["loss"]), st


def _jit_grads(loss_fn):
    """JAX's loss and gradients by the student's leaves, jitted (op by op,
    the rand-fr loss takes several times its compile)."""
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _check_f32_step(ref, cfg, state, step, batch):
    """The port's step against the JAX reference at
    ``test_f32_step_matches_jax``'s bounds."""
    loss, _, grads = step.loss_and_grads(state, *batch, HP[3])
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for n, want in ref["grads"].items():
        assert _rel(grads[n].numpy(), want) <= 1e-4, n
    state, metrics = step(state, *batch, *HP)
    assert abs(float(metrics["loss"]) - ref["step_loss"]) <= 1e-5 * abs(ref["step_loss"])
    js = ref["state"]
    assert _rel(state.center.numpy(), js.center) <= 1e-6
    st, tt = to_port(js.student, cfg), to_port(js.teacher, cfg)
    assert set(st) == set(dict(state.student.named_parameters()))
    for n, p in state.student.named_parameters():
        assert np.abs(p.detach().numpy() - st[n]).max() <= 2.1e-4, n
    for n, p in state.teacher.named_parameters():
        assert np.abs(p.numpy() - tt[n]).max() <= 1e-6, n
    return grads


# ---------------------------------------------------------------------------
# two-token: loss, backbone, step
# ---------------------------------------------------------------------------

def test_dino_loss_two_token_and_center_match_jax():
    r = np.random.RandomState(0)
    s = [r.randn(4 * 3, OUT).astype(np.float32) for _ in range(2)]
    t = [r.randn(2 * 3, OUT).astype(np.float32) for _ in range(2)]
    c = (0.1 * r.randn(2, OUT)).astype(np.float32)
    jl, jc = jdino.dino_loss_two_token(tuple(map(jnp.asarray, s)),
                                       tuple(map(jnp.asarray, t)), jnp.asarray(c), 0.04)
    pl, pc = dino.dino_loss_two_token(tuple(map(torch.from_numpy, s)),
                                      tuple(map(torch.from_numpy, t)),
                                      torch.from_numpy(c), 0.04)
    assert abs(float(pl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert pc.shape == (2, OUT) and _rel(pc.numpy(), jc) <= 1e-6


@pytest.mark.parametrize("px", [64, 48])
def test_aux_token_forward_matches_jax(px):
    """f32 features in the three output forms, at the model's grid (64 px)
    and through the two-token pos-embed resize (48 px)."""
    jcfg, js = _jax_student(KW2, 3, two_token=True)
    cfg = tsf.TimeSformerConfig(**KW2)
    model = tsf.AuxTokenTimeSformer(cfg)
    model.load_reference_state_dict(convert.state_dict_from_jax_params(js["backbone"], cfg))
    x = np.random.RandomState(4).randn(2, 3, 2, px, px).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        for kw in [dict(training=True), dict(training=False), dict(get_all=True)]:
            want = jtsf.aux_token_forward_features(js["backbone"], jnp.asarray(x), jcfg, **kw)
            got = model.forward_features(torch.from_numpy(x), **kw)
            if kw.get("training"):  # the (cls, aux) pair
                got, want = torch.stack(got), jnp.stack(want)
            assert got.shape == want.shape
            assert _rel(got.numpy(), want) <= 1e-5, kw


def test_aux_token_model_refuses_the_kernel_route():
    """JAX runs no Pallas kernel in the two-token block: the port's kernel
    route raises, naming why, for the model and for the step."""
    cfg = tsf.TimeSformerConfig(**KW2)
    model = tsf.init_aux_token_timesformer(cfg, torch.Generator().manual_seed(0),
                                           device="cpu")
    assert model.pos_embed.shape == (1, cfg.num_patches + 2, cfg.embed_dim)
    assert model.aux_cls_token.shape == (1, 1, cfg.embed_dim)
    x = torch.zeros(1, 3, 2, 64, 64)
    with pytest.raises(ValueError, match="plain route only"):
        model.forward_train(x, torch.bfloat16, route="kernels")
    with pytest.raises(ValueError, match="plain route only"):
        tsf.AuxTokenTimeSformer(dataclasses.replace(cfg, use_kernels=True))
    state, core, mask = ssl.init_train_state(cfg, out_dim=OUT, device="cpu",
                                             two_token=True)
    assert state.center.shape == (2, OUT)
    with pytest.raises(ValueError, match="plain route only"):
        ssl.make_train_step(cfg, core, mask, two_token=True,
                            compute_dtype=torch.bfloat16, route="kernels")
    auto = ssl.make_train_step(cfg, core, mask, two_token=True,
                               compute_dtype=torch.bfloat16)
    assert auto.route == "plain"


def _two_token_crops():
    r = np.random.RandomState(5)
    return (r.randn(4, 3, 2, 64, 64).astype(np.float32),
            (r.randn(4, 3, 2, 48, 48).astype(np.float32),
             r.randn(4, 3, 2, 64, 64).astype(np.float32)))


def test_two_token_step_matches_jax():
    jcfg, js = _jax_student(KW2, 6, two_token=True)
    g, (s96, s224) = _two_token_crops()

    def loss_fn(student, teacher, center):
        fwd = lambda p, x: jtsf.aux_token_forward_features(p, x, jcfg)  # noqa: E731
        s_a, s_b = fwd(student["backbone"], s96), fwd(student["backbone"], s224)
        s_out = jheads.multi_dino_head_forward(
            student["head"], (jnp.concatenate([s_a[0], s_b[0]]),
                              jnp.concatenate([s_a[1], s_b[1]])))
        t_out = jax.lax.stop_gradient(jheads.multi_dino_head_forward(
            teacher["head"], fwd(teacher["backbone"], g)))
        return jdino.dino_loss_two_token(s_out, t_out, center, HP[3])

    js_j = jax.tree.map(jnp.asarray, js)
    center = jnp.zeros((2, OUT))
    cfg = tsf.TimeSformerConfig(**KW2)
    with jax.default_matmul_precision("highest"):
        (loss, _), grads = _jit_grads(loss_fn)(js_j, js_j, center)
        step_loss, st = _jax_step_run(
            lambda core, mask: jssl.make_train_step(jcfg, core, mask, two_token=True,
                                                    donate=False),
            js_j, center, jnp.asarray(g), (jnp.asarray(s96), jnp.asarray(s224)))
    ref = {"loss": float(loss), "grads": to_port(grads, cfg), "step_loss": step_loss,
           "state": st}
    state, core, mask = _port_state(js, cfg, two_token=True)
    step = ssl.make_train_step(cfg, core, mask, two_token=True)
    assert isinstance(step, ssl.TwoTokenTrainStep) and step.route == "plain"
    _check_f32_step(ref, cfg, state, step,
                    (torch.from_numpy(g), (torch.from_numpy(s96), torch.from_numpy(s224))))


# ---------------------------------------------------------------------------
# rand-fr: the f32 step and the bf16 kernel route
# ---------------------------------------------------------------------------

def _rand_fr_crops(B=2):
    r = np.random.RandomState(9)
    return tuple(r.randn(n * B, 3, t, 32, 32).astype(np.float32)
                 for n, t in ((1, 4), (1, 8), (2, 2), (2, 4), (2, 8), (2, 16)))


def _jax_rand_fr_grads(jcfg, js, crops, compute_dtype):
    def loss_fn(student, teacher, center):
        fwd = lambda p, x: jtsf.forward(p, x, jcfg, compute_dtype=compute_dtype)  # noqa: E731
        s_out = jheads.dino_head_forward(
            student["head"], jnp.concatenate([fwd(student["backbone"], c) for c in crops]))
        t_out = jax.lax.stop_gradient(jheads.dino_head_forward(
            teacher["head"], jnp.concatenate([fwd(teacher["backbone"], c)
                                              for c in crops[:2]])))
        return jdino.dino_loss(s_out.astype(jnp.float32), t_out.astype(jnp.float32),
                               center, HP[3], n_crops=10)

    crops = tuple(jnp.asarray(c, compute_dtype) for c in crops)
    (loss, _), grads = _jit_grads(loss_fn)(js, js, jnp.zeros((1, OUT)))
    return float(loss), grads


@pytest.fixture(scope="module")
def rand_fr_reference():
    """JAX's f32 rand-fr gradients and one f32 step on shared weights."""
    jcfg, js = _jax_student(KW, 7)
    crops = _rand_fr_crops()
    js_j = jax.tree.map(jnp.asarray, js)
    cfg = tsf.TimeSformerConfig(**KW)
    with jax.default_matmul_precision("highest"):
        loss, grads = _jax_rand_fr_grads(jcfg, js_j, crops, jnp.float32)
        step_loss, st = _jax_step_run(
            lambda core, mask: jssl.make_rand_fr_train_step(jcfg, core, mask,
                                                            donate=False),
            js_j, jnp.zeros((1, OUT)), tuple(map(jnp.asarray, crops)))
    return {"jcfg": jcfg, "js": js, "crops": crops, "loss": loss,
            "grads": to_port(grads, cfg), "step_loss": step_loss, "state": st}


def test_rand_fr_step_matches_jax(rand_fr_reference):
    ref = rand_fr_reference
    cfg = tsf.TimeSformerConfig(**KW)
    state, core, mask = _port_state(ref["js"], cfg)
    step = ssl.make_rand_fr_train_step(cfg, core, mask)
    assert step.route == "plain" and step.n_crops == 10
    _check_f32_step(ref, cfg, state, step, (tuple(map(torch.from_numpy, ref["crops"])),))


def test_rand_fr_bf16_kernel_route_matches_jax_fused(rand_fr_reference):
    """Every group's T (2, 4, 8, 16) on the kernel route (the twins here)."""
    ref = rand_fr_reference
    cfg = tsf.TimeSformerConfig(**KW)
    jcfg = dataclasses.replace(ref["jcfg"], use_fused=True)
    _, jgrads = _jax_rand_fr_grads(jcfg, jax.tree.map(jnp.asarray, ref["js"]),
                                   ref["crops"], jnp.bfloat16)
    jgrads = to_port(jgrads, cfg)
    state, core, mask = _port_state(ref["js"], cfg)
    step = ssl.make_rand_fr_train_step(cfg, core, mask, compute_dtype=torch.bfloat16)
    assert step.route == "kernels"
    _, _, grads = step.loss_and_grads(state, tuple(map(torch.from_numpy, ref["crops"])),
                                      HP[3])
    e_port = e_jax = 0.0
    for n, want in jgrads.items():
        got, f32 = grads[n].numpy(), ref["grads"][n]
        assert _rel(got, want) < 0.15, (n, _rel(got, want))
        scale = np.abs(f32).mean() + 1e-12
        e_port += np.abs(got - f32).mean() / scale
        e_jax += np.abs(want - f32).mean() / scale
    e_port, e_jax = e_port / len(jgrads), e_jax / len(jgrads)
    assert e_port <= 1.5 * e_jax + 1e-6, (e_port, e_jax)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _crops(seed):
    r = np.random.RandomState(seed)
    return (r.randn(2, 3, 2, 32, 32).astype(np.float32),
            r.randn(2, 3, 2, 32, 32).astype(np.float32))


def test_remat_step_matches_jax():
    jcfg, js = _jax_student(KW, 11)
    g, l = _crops(12)
    js_j = jax.tree.map(jnp.asarray, js)
    cfg = tsf.TimeSformerConfig(**KW)

    def loss_fn(student, teacher, center):
        fwd = lambda p, x: jtsf.forward(p, x, jcfg)  # noqa: E731
        s = jnp.concatenate([jax.checkpoint(fwd)(student["backbone"], c) for c in (g, l)])
        s_out = jheads.dino_head_forward(student["head"], s)
        t_out = jax.lax.stop_gradient(jheads.dino_head_forward(
            teacher["head"], fwd(teacher["backbone"], g)))
        return jdino.dino_loss(s_out, t_out, center, HP[3], n_crops=4)

    center = jnp.zeros((1, OUT))
    with jax.default_matmul_precision("highest"):
        (loss, _), grads = _jit_grads(loss_fn)(js_j, js_j, center)
        step_loss, st = _jax_step_run(
            lambda core, mask: jssl.make_train_step(jcfg, core, mask, n_local_crops=2,
                                                    remat=True, donate=False),
            js_j, center, jnp.asarray(g), jnp.asarray(l))
    ref = {"loss": float(loss), "grads": to_port(grads, cfg), "step_loss": step_loss,
           "state": st}
    state, core, mask = _port_state(js, cfg)
    step = ssl.make_train_step(cfg, core, mask, n_local_crops=2, remat=True)
    assert step.remat
    _check_f32_step(ref, cfg, state, step, (torch.from_numpy(g), torch.from_numpy(l)))


STUDENT_OPS = ("temporal_phase_tm", "spatial_phase", "mlp_phase")


@pytest.mark.parametrize("dtype,route", [(torch.float32, "plain"),
                                         (torch.bfloat16, "plain"),
                                         (torch.bfloat16, "kernels"),
                                         (torch.float32, "kernels")])
def test_remat_equals_non_remat_bit_for_bit(monkeypatch, dtype, route):
    """Loss, gradients and the step's new state equal, bit for bit; on the
    kernel route the per-phase forwards run twice per block in each student
    pass (counted through shims: the twins on the CPU move no launch
    counter) and once in the teacher's."""
    cfg = tsf.TimeSformerConfig(**KW)
    g, l = (torch.from_numpy(a) for a in _crops(13))
    calls = {}

    def shim(op):
        sound = getattr(fb, op)

        def call(*a, **k):
            calls[op] = calls.get(op, 0) + 1
            return sound(*a, **k)
        return call

    for op in STUDENT_OPS:
        monkeypatch.setattr(fb, op, shim(op))
    out = {}
    for remat in (False, True):
        state, core, mask = ssl.init_train_state(cfg, out_dim=OUT, seed=3, device="cpu")
        step = ssl.make_train_step(cfg, core, mask, n_local_crops=2, compute_dtype=dtype,
                                   route=route, remat=remat)
        calls.clear()
        loss, center, grads = step.loss_and_grads(state, g, l, HP[3])
        out[remat] = (loss, center, grads, dict(calls))
        state, _ = step(state, g, l, *HP)
        out[remat] += (state.student.state_dict(),)
    (l0, c0, g0, n0, s0), (l1, c1, g1, n1, s1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(c0, c1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    depth = cfg.depth
    if route == "plain":
        assert n0 == n1 == {}
    else:  # 2 student + 1 teacher passes, the students' rerun block by block
        assert n0 == {"temporal_phase_tm": 3 * depth, "spatial_phase": 3 * depth,
                      "mlp_phase": 6 * depth}
        assert n1 == {"temporal_phase_tm": 5 * depth, "spatial_phase": 5 * depth,
                      "mlp_phase": 10 * depth}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_augmentation_variants_match_jax():
    r = np.random.RandomState(14)
    clips = [r.randint(0, 256, (2, 3, 60, 80)).astype(np.float32) for _ in range(5)]
    for kw, shapes in [(dict(two_token=True), [224, 224, 96, 96, 224, 224]),
                       (dict(no_aug=True), [224] * 5)]:
        got = ptr.VideoDataAugmentationDINO(rng=np.random.RandomState(3))(clips, **kw)
        want = jtr.VideoDataAugmentationDINO(rng=np.random.RandomState(3))(clips, **kw)
        assert [c.shape[-1] for c in got] == shapes
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    frame = r.randint(0, 256, (256, 320, 3)).astype(np.uint8)
    tiles = ptr.spatial_tile_local_crops(frame)
    want = jtr.spatial_tile_local_crops(frame)
    assert len(tiles) == 8 and all(t.shape == (1, 96, 96, 3) for t in tiles)
    for a, b in zip(tiles, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,frames", [
    ("temporal_aug", [2] * 10),
    ("rand_fr", [4, 8, 2, 2, 4, 4, 8, 8, 16, 16]),
    ("tiled_local", [2, 2] + [1] * 8),
    ("two_token", [2] * 6)])
def test_clip_dataset_matches_jax(tmp_path, monkeypatch, variant, frames):
    """The same seed gives JAX's crops bit for bit (decoding stubbed with a
    synthetic clip in both packages; the second item is a retry after a
    video with no frames). ``temporal_aug`` alone pins the plain clip's start draw
    that every multi-crop item spends before its clips."""
    (tmp_path / "train.csv").write_text("a.avi 0\nb.avi 1\nc.avi 2\n")
    video = np.random.RandomState(15).randint(0, 256, (48, 256, 320, 3), dtype=np.uint8)

    def read(path, *a, **k):  # b.avi: no frames, which both packages retry
        return (video[:0] if path.endswith("b.avi") else video), 30.0

    cfg = defaults.get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = str(tmp_path)
    cfg.DATA.NUM_FRAMES = 2
    kw = {"temporal_aug": variant != "two_token", "two_token": variant == "two_token",
          "rand_fr": variant == "rand_fr", "tiled_local": variant == "tiled_local"}
    items = {}
    for name, mod in (("jax", jds), ("port", pds)):
        monkeypatch.setattr(mod.vio, "read_video", read)
        ds = mod.ClipDataset(cfg, "train", seed=4, **kw)
        items[name] = [ds[0], ds[1]]
    for (pc, pl, pi, _), (jc, jl, ji, _) in zip(items["port"], items["jax"]):
        assert (pl, pi) == (jl, ji) and len(pc) == len(jc) == len(frames)
        assert [c.shape[1] for c in pc] == frames
        for a, b in zip(pc, jc):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from dino_video_summarization_transformer_tpu.data import video as jvio
    from dino_video_summarization_transformer_tpu_torch.data import video as vio

    if not vio.native_available():
        pytest.skip("native decoder not built")
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for name in ("a", "b"):
        fr = rng.randint(0, 256, (40, 256, 320, 3), dtype=np.uint8)
        jvio.write_video(str(root / f"{name}.avi"), fr, fps=30)
    (root / "train.csv").write_text("a.avi 0\nb.avi 1\n")
    return root


def _argv(corpus, out_dir, flags=(), opts=()):
    return ["--arch", "vit_tiny",
            "--cfg", os.path.join(conftest.REPO_ROOT,
                                  "configs/kinetics/timesformer_divst_8x32_224.yaml"),
            "--data_path", str(corpus), "--output_dir", str(out_dir),
            "--batch_size_per_gpu", "2", "--epochs", "1", "--warmup_epochs", "0",
            "--local_crops_number", "2", "--out_dim", "1024", "--num_workers", "2",
            "--use_fp16", "false", "--max_steps_per_epoch", "1",
            "--saveckp_freq", "0", "--device", "cpu", *flags,
            "--opts", "DATA.NUM_FRAMES", "2", "DATA.SAMPLING_RATE", "4", *opts]


@pytest.mark.parametrize("flags,opts", [
    (["--two_token", "true"], []),
    ([], ["MODEL.TWO_TOKEN", "True"]),
    ([], ["DATA.RAND_FR", "True"]),
    (["--use_remat", "true"], []),
    (["--profile_dir", "PROF", "--profile_start_step", "0", "--profile_steps", "1"], [])],
    ids=["two_token", "cfg_two_token", "rand_fr", "use_remat", "profile_dir"])
def test_train_ssl_cli_variant_one_step(corpus, tmp_path, monkeypatch, capsys, flags, opts):
    """One step of each variant on the two-video corpus writes a finite
    loss; ``--profile_dir`` leaves a Chrome trace that parses. The model is
    vit_tiny cut to depth 2 (the rand-fr step's 16-frame locals and 8-frame
    globals make the full depth slow on a CPU)."""
    from dino_video_summarization_transformer_tpu_torch import train_ssl

    monkeypatch.setitem(tsf._ARCH_DIMS, "vit_tiny", (192, 2, 3))
    flags = [str(tmp_path / "prof") if f == "PROF" else f for f in flags]
    out_dir = tmp_path / "out"
    train_ssl.main(_argv(corpus, out_dir, flags, opts))
    rec = json.loads((out_dir / "log.txt").read_text().splitlines()[-1])
    assert np.isfinite(rec["train_loss"]) and rec["epoch"] == 0
    assert "achieved_tflops" not in rec
    out = capsys.readouterr().out
    assert "Block route: plain" in out
    if "--profile_dir" in flags:
        assert f"profiler trace written to {tmp_path / 'prof'}" in out
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        assert trace["traceEvents"]


@pytest.mark.parametrize("flags,opts", [
    (["--pretrained_motion", "m.pth"], []), (["--pretrained_cnn", "c.pth"], []),
    (["--cnn_distill_weight", "0.5"], []),
    # the online kNN hook is ported; with the two-token variant it is refused
    (["--knn_eval_freq", "1", "--two_token", "true"], []),
    (["--model_parallel", "2"], []), (["--tp_fused", "true"], []),
    (["--zero1", "true"], []), (["--pipeline", "2"], []), (["--seq_parallel", "2"], []),
    (["--num_shards", "2"], []), ([], ["MODEL.TWO_STREAM", "True"]),
    ([], ["MODEL.CNN_DISTILL", "True"])])
def test_train_ssl_cli_refuses_unported_variants(tmp_path, flags, opts):
    from dino_video_summarization_transformer_tpu_torch import train_ssl

    with pytest.raises(NotImplementedError):
        train_ssl.main(_argv(tmp_path, tmp_path / "out", flags, opts))
