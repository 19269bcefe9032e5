"""The port's trainer variants on the other backbones against the JAX
package's, on the same numpy weights (crossed by the port's ``convert``)
and inputs: the 2D ViT motion net (``models/vit2d.py``), the S3D teacher
(``models/s3d.py``), the two-stream step (``make_two_stream_train_step``)
and the CNN-distillation step (``make_train_step(cnn_params=...)``).

Tolerances:
* vit2d forwards at f32: max|diff| <= 1e-5 x max|JAX|; the bicubic
  pos-embed resize 1e-5 of max; both converters exact;
* S3D: the eval forward at f32 1e-5 of max; the train-mode forward 1e-5
  of max in float64 on both sides, and ``batch_norm``'s output and new
  running statistics at f32 (1e-5, 1e-6). At f32 the train-mode forward
  cannot be held end to end: x - batch mean cancels where a channel's
  spread is small against its mean, and the two packages' mean summations
  round differently (3.1e-5 of max at Mixed_5b alone, 9e-4 end to end);
* the steps at f32 (JAX ``precision="highest"``): the losses 1e-5
  relative; each gradient leaf 1e-4 x its max; after one SGD step every
  leaf of the students and teachers 1e-5 x its max, the centers 1e-6;
* the two-stream step in bf16 on the plain route: PERF.md section 6's bf16
  rule, per leaf max|diff| / max|JAX| < 0.15 against JAX's bf16 gradients
  and the port's mean distance to the f32 gradients <= 1.5 x JAX's + 1e-6.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import heads as jheads
from dino_video_summarization_transformer_tpu.models import s3d as js3d
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.models import vit2d as jvit
from dino_video_summarization_transformer_tpu.train import dino as jdino
from dino_video_summarization_transformer_tpu.train import optim as joptim
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert, s3d, vit2d
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.train import ssl
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          num_frames=2, num_classes=0)
MKW = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=2)
OUT = 64
HP = (0.1, 0.04, 0.996, 0.04, False)  # lr, wd, teacher momentum, temp, freeze


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# vit2d
# ---------------------------------------------------------------------------

def _vit2d_pair(seed=0, **kw):
    jcfg = jvit.ViT2DConfig(**{**MKW, **kw})
    jp = _np(jvit.init_vit2d(jax.random.key(seed), jcfg))
    cfg = vit2d.ViT2DConfig(**{**MKW, **kw})
    model = vit2d.ViT2D(cfg)
    model.load_reference_state_dict(convert.state_dict_from_jax_params(jp, cfg))
    return jcfg, jp, cfg, model


@pytest.mark.parametrize("hw", [(32, 32), (48, 32), (48, 48)])
def test_vit2d_forward_matches_jax(hw):
    """At the model's grid, non-square, and off-grid (pos-embed
    interpolation), with the head."""
    jcfg, jp, cfg, model = _vit2d_pair(num_classes=5)
    x = np.random.RandomState(1).randn(2, 3, *hw).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        for use_head in (False, True):
            want = jvit.forward(jp, jnp.asarray(x), jcfg, use_head=use_head)
            got = model(torch.from_numpy(x), use_head=use_head)
            assert got.shape == want.shape
            assert _rel(got.numpy(), want) <= 1e-5, (hw, use_head)


def test_vit2d_drop_path_forward_matches_jax():
    """JAX's train=True forward with a key: the port given JAX's per-block
    masks (one per block, shared by both branches)."""
    jcfg, jp, cfg, model = _vit2d_pair(drop_path_rate=0.5)
    x = np.random.RandomState(2).randn(4, 3, 32, 32).astype(np.float32)
    key = jax.random.key(3)
    rates = np.linspace(0.0, 0.5, cfg.depth)
    masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(
        k, 1.0 - r, (4, 1, 1))).reshape(4).astype(np.float32))
        for k, r in zip(jax.random.split(key, cfg.depth), rates)]
    assert min(float(m.sum()) for m in masks[1:]) < 4  # a sample is dropped
    with jax.default_matmul_precision("highest"), torch.no_grad():
        want = jvit.forward(jp, jnp.asarray(x), jcfg, train=True, rng=key)
        got = model(torch.from_numpy(x), masks=masks)
        plain = model(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(plain.numpy(), want) > 1e-3
    drawn = vit2d.drop_path_masks(4, cfg, torch.Generator().manual_seed(0))
    assert [m.shape for m in drawn] == [(4,)] * cfg.depth and bool(drawn[0].all())


@pytest.mark.parametrize("out_hw,scale", [((6, 5), None), ((5, 7), (2.6 / 2, 3.4 / 2))])
def test_bicubic_resize_matches_jax(out_hw, scale):
    g = np.random.RandomState(4).randn(4, 3, 8).astype(np.float32)
    sh, sw = scale or (None, None)
    want = jvit._bicubic_resize_2d(jnp.asarray(g), *out_hw, scale_h=sh, scale_w=sw)
    got = vit2d.bicubic_resize_2d(torch.from_numpy(g), *out_hw, scale_h=sh, scale_w=sw)
    assert _rel(got.numpy(), want) <= 1e-5


def test_vit2d_converters(tmp_path):
    """The JAX pytree -> state dict map inverts JAX's ``vit2d_to_pytree``
    leaf for leaf, and a DINO checkpoint (``module.`` prefix) loads through
    ``convert_dino_vit2d_checkpoint`` as JAX's loads it."""
    jcfg, jp, cfg, model = _vit2d_pair()
    sd = convert.state_dict_from_jax_params(jp, cfg)
    back = _np(jvit.vit2d_to_pytree(sd, jcfg))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and np.array_equal(a, b), pa
    torch.save({"module." + k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "dino.pth")
    got = convert.convert_dino_vit2d_checkpoint(str(tmp_path / "dino.pth"), cfg)
    assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k]) for k in sd)
    from dino_video_summarization_transformer_tpu.models import convert as jconvert

    jtree = _np(jconvert.convert_dino_vit2d_checkpoint(str(tmp_path / "dino.pth"), jcfg))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jtree),
                                                     jax.tree.leaves(jp)))
    with pytest.raises(ValueError, match="blocks"):
        convert.convert_dino_vit2d_checkpoint(
            str(tmp_path / "dino.pth"), vit2d.ViT2DConfig(**{**MKW, "depth": 3}))


# ---------------------------------------------------------------------------
# S3D
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s3d_pair():
    """The port's seeded S3D and JAX's pytree of the same weights (JAX
    ``s3d_to_pytree`` of the port's state dict), BatchNorm statistics made
    non-trivial."""
    model = s3d.init_s3d(torch.Generator().manual_seed(0), device="cpu")
    r = np.random.RandomState(5)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.from_numpy((0.01 * r.randn(*b.shape)).astype(np.float32))
                    if name.endswith("mean") else
                    torch.from_numpy((0.5 + r.rand(*b.shape)).astype(np.float32) * 1e-4))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, js3d.s3d_to_pytree(sd), sd


def test_s3d_converters(s3d_pair, tmp_path):
    """The port's pytree -> state dict map inverts JAX's ``s3d_to_pytree``;
    a CoCLR checkpoint (``state_dict`` / ``encoder_q.0.``) loads through
    ``convert_coclr_s3d``."""
    model, jp, sd = s3d_pair
    back = convert.s3d_state_dict_from_jax(jp)
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)
    torch.save({"state_dict": {**{"encoder_q.0." + k: torch.from_numpy(v)
                                  for k, v in sd.items()},
                               "encoder_k.0.Conv_1a.conv1.weight": torch.zeros(1)}},
               tmp_path / "coclr.pth.tar")
    got = convert.convert_coclr_s3d(str(tmp_path / "coclr.pth.tar"))
    assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k]) for k in sd)
    gated = s3d.S3D(gating=True)
    assert "Mixed_5c.gating_b3.weight" in gated.state_dict()


def test_s3d_eval_forward_matches_jax(s3d_pair):
    model, jp, _ = s3d_pair
    x = np.random.RandomState(6).randn(2, 3, 8, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        want = jax.jit(lambda v: js3d.forward(jp, v))(jnp.asarray(x))
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 1024, 1, 1, 1)
    assert _rel(got.numpy(), want) <= 1e-5


def test_s3d_train_mode_matches_jax(s3d_pair):
    """The train-mode forward (batch statistics) in float64 on both sides,
    end to end, and ``batch_norm``'s updated running statistics at f32."""
    model, jp, _ = s3d_pair
    x = np.random.RandomState(7).randn(2, 3, 8, 32, 32)
    m64 = s3d.S3D().double()
    m64.load_reference_state_dict(model.state_dict())
    with jax.enable_x64(True), torch.no_grad():
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                            if a.dtype == np.float32 else a, jp)
        want = jax.jit(lambda v: js3d.forward(jp64, v, training=True,
                                              compute_dtype=jnp.float64))(
            jnp.asarray(x, jnp.float64))
        assert want.dtype == jnp.float64
        got = m64(torch.from_numpy(x), training=True)
    assert got.dtype == torch.float64 and _rel(got.numpy(), want) <= 1e-5
    x32 = x.astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        y = s3d.conv3d(torch.from_numpy(x32), model.Conv_1a.conv1.weight, (1, 2, 2), (0, 3, 3))
        jy = js3d.conv3d(jnp.asarray(x32).transpose(0, 2, 3, 4, 1), jp["Conv_1a"]["conv1"],
                         (1, 2, 2), (0, 3, 3))
        out, stats = s3d.batch_norm(model.Conv_1a.bn1, y, training=True)
        jout, jstats = js3d.batch_norm(jp["Conv_1a"]["bn1"], jy, training=True)
    assert _rel(out.numpy(), np.asarray(jout).transpose(0, 4, 1, 2, 3)) <= 1e-5
    for k in ("mean", "var"):
        assert _rel(stats[k].numpy(), jstats[k]) <= 1e-6, k
    assert s3d.batch_norm(model.Conv_1a.bn1, y)[1] is None


def test_s3d_bf16_compute_follows_promotion(s3d_pair):
    """With f32 weights, ``compute_dtype=bf16`` rounds the input and runs
    every layer in f32 (JAX's promotion; its own conv refuses the mix)."""
    model, jp, _ = s3d_pair
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 3, 8, 32, 32).astype(np.float32))
    with torch.no_grad():
        got = model(x, compute_dtype=torch.bfloat16)
        want = model(x.bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(TypeError, match="same dtypes"):
        js3d.forward(jp, jnp.asarray(x.numpy()), compute_dtype=jnp.bfloat16)


# ---------------------------------------------------------------------------
# the two-stream step
# ---------------------------------------------------------------------------

def _two_stream_weights(seed=0):
    jcfg = jtsf.TimeSformerConfig(**KW)
    mcfg = jvit.ViT2DConfig(**MKW)
    backbone = _np(jsyn.make_numpy_params(jcfg, seed=seed))
    h, a = (make_numpy_head_params(KW["embed_dim"], OUT, seed=seed + i) for i in (1, 2))
    head = {"mlp": h["mlp"], "aux_mlp": a["mlp"], "last_layer": h["last_layer"],
            "aux_last_layer": a["last_layer"]}
    motion = {"backbone": _np(jvit.init_vit2d(jax.random.key(seed + 3), mcfg)),
              "head": make_numpy_head_params(MKW["embed_dim"], OUT, seed=seed + 4)}
    return jcfg, mcfg, {"backbone": backbone, "head": head}, motion


def _two_stream_inputs(B=2):
    r = np.random.RandomState(9)
    return (r.randn(2 * B, 3, 2, 32, 32).astype(np.float32),
            r.randn(2 * B, 3, 2, 48, 48).astype(np.float32),
            r.randn(2 * B, 3, 32, 32).astype(np.float32))


def _port_two_stream(jcfg, mcfg, rgb, motion, optimizer="sgd"):
    cfg, pmcfg = tsf.TimeSformerConfig(**KW), vit2d.ViT2DConfig(**MKW)
    state, core, mask = ssl.init_two_stream_state(
        cfg, pmcfg, out_dim=OUT, optimizer=optimizer, device="cpu",
        pretrained_backbone=convert.state_dict_from_jax_params(rgb["backbone"], cfg),
        pretrained_motion=convert.state_dict_from_jax_params(motion["backbone"], pmcfg),
        head_state_dict=convert.head_state_dict_from_jax(rgb["head"]),
        motion_head_state_dict=convert.head_state_dict_from_jax(motion["head"]))
    return cfg, pmcfg, state, core, mask


def _to_port_names(tree, cfg, prefix):
    sd = {prefix + "backbone." + k: v for k, v in convert.state_dict_from_jax_params(
        _np(tree["backbone"]), cfg).items()}
    sd.update({prefix + "head." + k: v for k, v in convert.head_state_dict_from_jax(
        _np(tree["head"])).items()})
    return sd


def _jax_two_stream_loss(jcfg, mcfg, compute_dtype, n_crops):
    """JAX ``make_two_stream_train_step``'s loss, as a function of the
    combined students (the step keeps it internal)."""
    def loss_fn(combined, teacher, motion_teacher, g, l, flow, tt):
        student, motion = combined["rgb"], combined["motion"]
        fwd = lambda p, x: jtsf.forward(p, x, jcfg, compute_dtype=compute_dtype)  # noqa: E731
        mfwd = lambda p, x: jvit.forward(p, x, mcfg, compute_dtype=compute_dtype)  # noqa: E731
        feats = jnp.concatenate([fwd(student["backbone"], g), fwd(student["backbone"], l)])
        s_rgb, s_cross = jheads.multi_dino_head_forward(student["head"], (feats, feats))
        t_feats = fwd(teacher["backbone"], g)
        t_rgb = jax.lax.stop_gradient(
            jheads.multi_dino_head_forward(teacher["head"], (t_feats, t_feats))[0])
        s_flow = jheads.dino_head_forward(motion["head"], mfwd(motion["backbone"], flow))
        t_flow = jax.lax.stop_gradient(jheads.dino_head_forward(
            motion_teacher["head"], mfwd(motion_teacher["backbone"], flow)))
        z = jnp.zeros((1, OUT))
        f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
        return (jdino.dino_loss(f32(s_rgb), f32(t_rgb), z, tt, n_crops=n_crops)[0]
                + jdino.dino_loss(f32(s_flow), f32(t_flow), z, tt, n_crops=2)[0]
                + jdino.dino_loss(f32(s_cross), f32(t_flow), z, tt, n_crops=n_crops)[0])
    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.fixture(scope="module")
def two_stream_f32():
    """JAX's f32 two-stream step from the shared weights (SGD), and its
    gradients."""
    jcfg, mcfg, rgb, motion = _two_stream_weights()
    g, l, flow = _two_stream_inputs()
    combined = jax.tree.map(jnp.asarray, {"rgb": rgb, "motion": motion})
    core, mask = joptim.build_optimizer("sgd", combined)
    zeros = jnp.zeros((1, OUT))
    st = jssl.TwoStreamState(combined["rgb"], jax.tree.map(jnp.copy, combined["rgb"]),
                             combined["motion"], jax.tree.map(jnp.copy, combined["motion"]),
                             zeros, zeros, zeros, core.init(combined),
                             jnp.zeros((), jnp.int32))
    with jax.default_matmul_precision("highest"):
        _, grads = _jax_two_stream_loss(jcfg, mcfg, jnp.float32, 4)(
            combined, combined["rgb"], combined["motion"], g, l, flow, HP[3])
        step = jssl.make_two_stream_train_step(jcfg, mcfg, core, mask, n_local_crops=2,
                                               donate=False)
        new, metrics = step(st, jnp.asarray(g), jnp.asarray(l), jnp.asarray(flow), *HP)
    return dict(weights=(jcfg, mcfg, rgb, motion), inputs=(g, l, flow), grads=grads,
                state=new, metrics={k: float(v) for k, v in metrics.items()})


def test_two_stream_step_matches_jax(two_stream_f32):
    ref = two_stream_f32
    jcfg, mcfg, rgb, motion = ref["weights"]
    cfg, pmcfg, state, core, mask = _port_two_stream(jcfg, mcfg, rgb, motion)
    assert set(state.opt_state["trace"]) == set(state.params())
    step = ssl.make_two_stream_train_step(cfg, pmcfg, core, mask, n_local_crops=2)
    assert isinstance(step, ssl.TwoStreamTrainStep) and step.route == "plain"
    batch = tuple(map(torch.from_numpy, ref["inputs"]))
    loss, _, grads = step.loss_and_grads(state, *batch, HP[3])
    assert abs(float(loss) - ref["metrics"]["loss"]) <= 1e-5 * abs(ref["metrics"]["loss"])
    want = {**_to_port_names(ref["grads"]["rgb"], cfg, "rgb."),
            **_to_port_names(ref["grads"]["motion"], pmcfg, "motion.")}
    assert set(want) == set(grads)
    for n, w in want.items():
        assert _rel(grads[n].numpy(), w) <= 1e-4, n
    state, metrics = step(state, *batch, *HP)
    for k in ("loss", "loss_rgb", "loss_flow", "loss_cross"):
        assert abs(float(metrics[k]) - ref["metrics"][k]) <= 1e-5 * abs(ref["metrics"][k]), k
    js = ref["state"]
    for name, (mod, jtree, c) in {
            "student": (state.student, js.student, cfg),
            "teacher": (state.teacher, js.teacher, cfg),
            "motion_student": (state.motion_student, js.motion_student, pmcfg),
            "motion_teacher": (state.motion_teacher, js.motion_teacher, pmcfg)}.items():
        want = _to_port_names(jtree, c, "")
        assert set(want) == set(dict(mod.named_parameters())), name
        for n, p in mod.named_parameters():
            assert _rel(p.detach().numpy(), want[n]) <= 1e-5, (name, n)
    for k in ("center_rgb", "center_flow", "center_cross"):
        assert _rel(getattr(state, k).numpy(), getattr(js, k)) <= 1e-6, k


def test_two_stream_bf16_plain_route_matches_jax_bf16(two_stream_f32):
    """bf16 compute on the plain route against JAX's bf16 XLA step's
    gradients, by PERF.md section 6's bf16 rule."""
    ref = two_stream_f32
    jcfg, mcfg, rgb, motion = ref["weights"]
    g, l, flow = ref["inputs"]
    combined = jax.tree.map(jnp.asarray, {"rgb": rgb, "motion": motion})
    _, jg = _jax_two_stream_loss(jcfg, mcfg, jnp.bfloat16, 4)(
        combined, combined["rgb"], combined["motion"], g, l, flow, HP[3])
    cfg, pmcfg, state, core, mask = _port_two_stream(jcfg, mcfg, rgb, motion)
    step = ssl.make_two_stream_train_step(cfg, pmcfg, core, mask, n_local_crops=2,
                                          compute_dtype=torch.bfloat16, route="plain")
    _, _, grads = step.loss_and_grads(state, *map(torch.from_numpy, (g, l, flow)), HP[3])
    want = {**_to_port_names(jg["rgb"], cfg, "rgb."),
            **_to_port_names(jg["motion"], pmcfg, "motion.")}
    f32 = {**_to_port_names(ref["grads"]["rgb"], cfg, "rgb."),
           **_to_port_names(ref["grads"]["motion"], pmcfg, "motion.")}
    d_port, d_jax = [], []
    for n, w in want.items():
        if np.abs(f32[n]).max() == 0:
            continue  # zero in exact arithmetic (block 1's time-embed path)
        assert _rel(grads[n].numpy(), w) < 0.15, n
        d_port.append(_rel(grads[n].numpy(), f32[n]))
        d_jax.append(_rel(w, f32[n]))
    assert np.mean(d_port) <= 1.5 * np.mean(d_jax) + 1e-6


def test_two_stream_kernel_route_runs_the_twins():
    """bf16 ``route="kernels"`` on CPU tensors runs the per-phase kernels'
    twins for the RGB backbones: losses within the plain bf16 route's
    reach of f32."""
    jcfg, mcfg, rgb, motion = _two_stream_weights(seed=1)
    batch = tuple(map(torch.from_numpy, _two_stream_inputs()))
    losses = {}
    for name, dt, route in (("f32", torch.float32, "plain"),
                            ("plain", torch.bfloat16, "plain"),
                            ("kernels", torch.bfloat16, "kernels")):
        cfg, pmcfg, state, core, mask = _port_two_stream(jcfg, mcfg, rgb, motion)
        step = ssl.make_two_stream_train_step(cfg, pmcfg, core, mask, n_local_crops=2,
                                              compute_dtype=dt, route=route)
        assert step.route == route
        losses[name] = float(step.loss_and_grads(state, *batch, HP[3])[0])
    gap_plain = abs(losses["plain"] - losses["f32"])
    assert abs(losses["kernels"] - losses["f32"]) <= 1.5 * gap_plain + 1e-3 * losses["f32"]


# ---------------------------------------------------------------------------
# the CNN-distillation step
# ---------------------------------------------------------------------------

def test_cnn_distill_step_matches_jax(s3d_pair):
    """``make_train_step(cnn_params=S3D, cnn_distill_weight=0.5)`` at f32
    against JAX's, ViT on 8-frame 32-px globals (the S3D's smallest
    clip), SGD."""
    model, jp, _ = s3d_pair
    kw = dict(KW, num_frames=8)
    jcfg = jtsf.TimeSformerConfig(**kw)
    cfg = tsf.TimeSformerConfig(**kw)
    backbone = _np(jsyn.make_numpy_params(jcfg, seed=11))
    head = make_numpy_head_params(kw["embed_dim"], OUT, seed=12)
    r = np.random.RandomState(13)
    proj = {"kernel": (0.02 * r.randn(kw["embed_dim"], 1024)).astype(np.float32),
            "bias": (0.01 * r.randn(1024)).astype(np.float32)}
    js = jax.tree.map(jnp.asarray, {"backbone": backbone, "head": head, "cnn_proj": proj})
    g = r.randn(4, 3, 8, 32, 32).astype(np.float32)
    l = r.randn(4, 3, 8, 48, 48).astype(np.float32)
    core, mask = joptim.build_optimizer("sgd", js)
    st = jssl.TrainState(js, jax.tree.map(jnp.copy, js), jnp.zeros((1, OUT)),
                         core.init(js), jnp.zeros((), jnp.int32))
    with jax.default_matmul_precision("highest"):
        step = jssl.make_train_step(jcfg, core, mask, n_local_crops=2, cnn_params=jp,
                                    cnn_distill_weight=0.5, donate=False)
        new, metrics = step(st, jnp.asarray(g), jnp.asarray(l), *HP)
    state, pcore, pmask = ssl.init_train_state(
        cfg, out_dim=OUT, optimizer="sgd", device="cpu", cnn_distill_dim=1024,
        pretrained_backbone=convert.state_dict_from_jax_params(backbone, cfg),
        head_state_dict=convert.head_state_dict_from_jax(head))
    with torch.no_grad():
        for m in (state.student, state.teacher):
            m["cnn_proj"].weight.copy_(torch.from_numpy(proj["kernel"].T))
            m["cnn_proj"].bias.copy_(torch.from_numpy(proj["bias"]))
    assert pmask["cnn_proj.weight"] and not pmask["cnn_proj.bias"]
    pstep = ssl.make_train_step(cfg, pcore, pmask, n_local_crops=2, cnn_params=model,
                                cnn_distill_weight=0.5)
    nodist = ssl.make_train_step(cfg, pcore, pmask, n_local_crops=2, cnn_params=model,
                                 cnn_distill_weight=0.0)
    batch = (torch.from_numpy(g), torch.from_numpy(l))
    base = float(nodist.loss_and_grads(state, *batch, HP[3])[0])
    state, pm = pstep(state, *batch, *HP)
    assert abs(float(pm["loss"]) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert float(pm["loss"]) - base > 1e-3  # the term is on
    for name, mod, tree in (("student", state.student, new.student),
                            ("teacher", state.teacher, new.teacher)):
        want = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
            _np(tree["backbone"]), cfg).items()}
        want.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
            _np(tree["head"])).items()})
        want["cnn_proj.weight"] = np.asarray(tree["cnn_proj"]["kernel"]).T
        want["cnn_proj.bias"] = np.asarray(tree["cnn_proj"]["bias"])
        assert set(want) == set(dict(mod.named_parameters()))
        for n, p in mod.named_parameters():
            assert _rel(p.detach().numpy(), want[n]) <= 1e-5, (name, n)
    assert _rel(state.center.numpy(), new.center) <= 1e-6
