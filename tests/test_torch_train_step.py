"""The port's DINO training pieces and train step against the JAX package's
(``train/dino.py``, ``train/optim.py``, ``train/schedules.py``,
``train/ssl.py``) on the same numpy-seeded weights, gradients and crops,
plus checkpoint save / restore / resume.

Tolerances:
* losses, center, EMA, schedules, clipping and the three optimizers
  (params and moments after two steps, the second with the last layer
  frozen): max|diff| <= 1e-6 x max|JAX| per leaf (f32 summation order);
* the f32 step (``precision="highest"`` in JAX, TF32 irrelevant on the
  CPU): loss <= 1e-5 relative; each gradient max|diff| <= 1e-4 x its max;
  center and teacher <= 1e-6; student parameters within 2.1 x lr, since
  Adam's first step is sign-like on gradients near zero;
* the bf16 kernel-route step (twins on the CPU) vs the JAX fused step
  (Pallas in interpret mode): per leaf max|diff| / max|JAX| < 0.15 (the
  bound of the JAX package's ``test_glue_free_forward_grad``), and the
  port's mean distance to the f32 gradients <= 1.5 x JAX's + 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import heads as jheads
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.train import dino as jdino
from dino_video_summarization_transformer_tpu.train import optim as joptim
from dino_video_summarization_transformer_tpu.train import schedules as jsched
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.train import dino, optim, schedules, ssl
from dino_video_summarization_transformer_tpu_torch.utils import checkpoint
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          num_frames=2, num_classes=0)
OUT = 64


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


def _jax_student(seed=0):
    jcfg = jtsf.TimeSformerConfig(**KW)
    backbone = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    head = make_numpy_head_params(KW["embed_dim"], OUT, seed=seed + 1)
    return jcfg, {"backbone": backbone, "head": head}


def to_port(tree, cfg):
    """JAX student-shaped pytree (params, grads or moments) -> port names."""
    sd = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, tree["backbone"]), cfg).items()}
    sd.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
        jax.tree.map(np.asarray, tree["head"])).items()})
    return sd


def _port_state(jstudent, cfg, optimizer="adamw"):
    sd = convert.state_dict_from_jax_params(jstudent["backbone"], cfg)
    hsd = convert.head_state_dict_from_jax(jstudent["head"])
    return ssl.init_train_state(cfg, out_dim=OUT, optimizer=optimizer,
                                pretrained_backbone=sd, head_state_dict=hsd,
                                device="cpu")


# ---------------------------------------------------------------------------
# losses, center, EMA, schedules
# ---------------------------------------------------------------------------

def test_dino_loss_and_center_match_jax():
    r = np.random.RandomState(0)
    s = r.randn(10 * 3, OUT).astype(np.float32)
    t = r.randn(2 * 3, OUT).astype(np.float32)
    c = 0.1 * r.randn(1, OUT).astype(np.float32)
    jl, jc = jdino.dino_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(c),
                             0.04, n_crops=10)
    pl, pc = dino.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                            torch.from_numpy(c), 0.04, n_crops=10)
    assert abs(float(pl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(pc.numpy(), jc) <= 1e-6
    uc = dino.update_center(torch.from_numpy(t), torch.from_numpy(c), 0.8)
    assert _rel(uc.numpy(), jdino.update_center(jnp.asarray(t), jnp.asarray(c), 0.8)) <= 1e-6


def test_ema_update_matches_jax():
    cfg = tsf.TimeSformerConfig(**KW)
    _, js = _jax_student(0)
    _, jt = _jax_student(5)
    want = to_port(jdino.ema_update(jt, js, 0.996), cfg)
    state, _, _ = _port_state(js, cfg)
    teacher, _, _ = _port_state(jt, cfg)
    dino.ema_update(teacher.student, state.student, 0.996)
    for n, p in teacher.student.named_parameters():
        assert _rel(p.detach().numpy(), want[n]) <= 1e-6, n


def test_schedules_match_jax():
    for args in [(5e-4, 1e-6, 10, 7, 2), (0.04, 0.4, 3, 5, 0), (0.996, 1.0, 4, 3, 0)]:
        np.testing.assert_array_equal(schedules.cosine_scheduler(*args),
                                      jsched.cosine_scheduler(*args))
    np.testing.assert_array_equal(dino.teacher_temp_schedule(0.04, 0.07, 30, 100),
                                  jdino.teacher_temp_schedule(0.04, 0.07, 30, 100))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_wd_mask_matches_jax_name_for_name():
    cfg = tsf.TimeSformerConfig(**KW)
    _, js = _jax_student()
    jmask = joptim.wd_mask(js)
    want = to_port(jax.tree.map(lambda m, p: np.full(np.shape(p), float(m)),
                                jmask, js), cfg)
    state, _, mask = _port_state(js, cfg)
    assert set(mask) == set(want) == set(dict(state.student.named_parameters()))
    for n, v in want.items():
        assert np.all(v == v.flat[0]), n
        assert mask[n] == bool(v.flat[0]), n
    assert sum(mask.values()) < len(mask)


def test_per_param_clip_matches_jax():
    cfg = tsf.TimeSformerConfig(**KW)
    _, js = _jax_student()
    r = np.random.RandomState(3)
    jg = jax.tree.map(lambda p: r.randn(*np.shape(p)).astype(np.float32), js)
    want = to_port(joptim.per_param_clip(3.0).update(jg, None)[0], cfg)
    got = optim.per_param_clip({n: torch.from_numpy(v) for n, v in to_port(jg, cfg).items()}, 3.0)
    for n in want:
        assert _rel(got[n].numpy(), want[n]) <= 1e-6, n


@pytest.mark.parametrize("name", ["adamw", "sgd", "lars"])
def test_optimizer_steps_match_jax(name):
    """Two steps of apply_updates_with_schedules, the second with the last
    layer frozen: parameters and moments equal JAX's, and the frozen last
    layer still moves through its non-zero moments (optax's behaviour).
    The clip is set where it scales by exactly 1: the clip's norms differ
    from JAX's in their last f32 bits (summation order), and Adam turns such
    a difference on a gradient element next to zero into an O(1) change of
    its step; ``test_per_param_clip_matches_jax`` holds the clip itself."""
    cfg = tsf.TimeSformerConfig(**KW)
    _, js = _jax_student()
    core, mask = joptim.build_optimizer(name, js, momentum=0.9)
    jstate = core.init(js)
    state, pcore, pmask = _port_state(js, cfg, optimizer=name)
    params = state.params()
    r = np.random.RandomState(4)
    jparams = jax.tree.map(jnp.asarray, js)
    before = {n: p.detach().clone() for n, p in params.items()}
    for it, freeze in enumerate([False, True]):
        jg = jax.tree.map(lambda p: (0.01 * r.randn(*np.shape(p))).astype(np.float32), js)
        jparams, jstate = joptim.apply_updates_with_schedules(
            jparams, jax.tree.map(jnp.asarray, jg), jstate, core, mask,
            1e-4, 0.04, clip=1e6, freeze_last_layer=jnp.asarray(freeze))
        if freeze:
            mid = {n: p.detach().clone() for n, p in params.items()}
        state.opt_state = optim.apply_updates_with_schedules(
            params, {n: torch.from_numpy(v) for n, v in to_port(jg, cfg).items()},
            state.opt_state, pcore, pmask, 1e-4, 0.04, clip=1e6,
            freeze_last_layer=freeze)
    want = to_port(jparams, cfg)
    for n, p in params.items():
        assert not np.array_equal(want[n], before[n].numpy()), n  # moved
        assert _rel(p.detach().numpy(), want[n]) <= 1e-6, n
    keys = {"adamw": ["mu", "nu"], "sgd": ["trace"], "lars": ["mu"]}[name]
    for key in keys:
        jm = to_port(getattr(jstate, key), cfg)
        for n, m in state.opt_state[key].items():
            assert _rel(m.numpy(), jm[n]) <= 1e-6, (key, n)
    ll = "head.last_layer.weight_v"
    assert not torch.equal(params[ll], mid[ll])  # frozen, still moving


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _crops(seed):
    r = np.random.RandomState(seed)
    return (r.randn(2, 3, 2, 32, 32).astype(np.float32),
            r.randn(2, 3, 2, 32, 32).astype(np.float32))


def _jax_loss_fn(jcfg, compute_dtype):
    def loss_fn(student, teacher, center, g, l, tt):
        fwd = lambda p, x: jtsf.forward(p, x, jcfg, compute_dtype=compute_dtype)  # noqa: E731
        s = jnp.concatenate([fwd(student["backbone"], g), fwd(student["backbone"], l)])
        s_out = jheads.dino_head_forward(student["head"], s)
        t_out = jax.lax.stop_gradient(jheads.dino_head_forward(
            teacher["head"], fwd(teacher["backbone"], g)))
        return jdino.dino_loss(s_out.astype(jnp.float32), t_out.astype(jnp.float32),
                               center, tt, n_crops=4)
    return loss_fn


def _jax_grads(jcfg, js, g, l, compute_dtype):
    center = jnp.zeros((1, OUT))
    (loss, _), grads = jax.value_and_grad(_jax_loss_fn(jcfg, compute_dtype),
                                          has_aux=True)(
        js, js, center, jnp.asarray(g, compute_dtype), jnp.asarray(l, compute_dtype), 0.04)
    return float(loss), grads


@pytest.fixture(scope="module")
def f32_reference():
    """JAX's f32 grads and one f32 step on the shared weights and crops."""
    jcfg, js = _jax_student(7)
    g, l = _crops(8)
    js = jax.tree.map(jnp.asarray, js)
    with jax.default_matmul_precision("highest"):
        loss, grads = _jax_grads(jcfg, js, g, l, jnp.float32)
        core, mask = joptim.build_optimizer("adamw", js)
        st = jssl.TrainState(js, jax.tree.map(jnp.copy, js), jnp.zeros((1, OUT)),
                             core.init(js), jnp.zeros((), jnp.int32))
        step = jssl.make_train_step(jcfg, core, mask, n_local_crops=2,
                                    clip_grad=3.0, donate=False)
        st, metrics = step(st, jnp.asarray(g), jnp.asarray(l), 1e-4, 0.04,
                           0.996, 0.04, False)
    cfg = tsf.TimeSformerConfig(**KW)
    return {"jcfg": jcfg, "js": jax.tree.map(np.asarray, js), "g": g, "l": l,
            "loss": loss, "grads": to_port(grads, cfg),
            "state": st, "step_loss": float(metrics["loss"])}


def test_f32_step_matches_jax(f32_reference):
    ref = f32_reference
    cfg = tsf.TimeSformerConfig(**KW)
    state, core, mask = _port_state(ref["js"], cfg)
    step = ssl.make_train_step(cfg, core, mask, n_local_crops=2, clip_grad=3.0)
    assert step.route == "plain"
    g, l = torch.from_numpy(ref["g"]), torch.from_numpy(ref["l"])
    loss, _, grads = step.loss_and_grads(state, g, l, 0.04)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for n, want in ref["grads"].items():
        assert _rel(grads[n].numpy(), want) <= 1e-4, n
    state, metrics = step(state, g, l, 1e-4, 0.04, 0.996, 0.04, False)
    assert abs(float(metrics["loss"]) - ref["step_loss"]) <= 1e-5 * abs(ref["step_loss"])
    js = ref["state"]
    assert _rel(state.center.numpy(), js.center) <= 1e-6
    st, tt = to_port(js.student, cfg), to_port(js.teacher, cfg)
    for n, p in state.student.named_parameters():
        assert np.abs(p.detach().numpy() - st[n]).max() <= 2.1e-4, n
    for n, p in state.teacher.named_parameters():
        assert np.abs(p.numpy() - tt[n]).max() <= 1e-6, n
    assert state.step == 1


def test_bf16_kernel_route_step_matches_jax_fused(f32_reference):
    ref = f32_reference
    cfg = tsf.TimeSformerConfig(**KW)
    jcfg = dataclasses.replace(ref["jcfg"], use_fused=True)
    _, jgrads = _jax_grads(jcfg, jax.tree.map(jnp.asarray, ref["js"]), ref["g"],
                           ref["l"], jnp.bfloat16)
    jgrads = to_port(jgrads, cfg)
    state, core, mask = _port_state(ref["js"], cfg)
    step = ssl.make_train_step(cfg, core, mask, n_local_crops=2,
                               compute_dtype=torch.bfloat16)
    assert step.route == "kernels"
    _, _, grads = step.loss_and_grads(state, torch.from_numpy(ref["g"]),
                                      torch.from_numpy(ref["l"]), 0.04)
    e_port = e_jax = 0.0
    for n, want in jgrads.items():
        got, f32 = grads[n].numpy(), ref["grads"][n]
        assert _rel(got, want) < 0.15, (n, _rel(got, want))
        scale = np.abs(f32).mean() + 1e-12
        e_port += np.abs(got - f32).mean() / scale
        e_jax += np.abs(want - f32).mean() / scale
    e_port, e_jax = e_port / len(jgrads), e_jax / len(jgrads)
    assert e_port <= 1.5 * e_jax + 1e-6, (e_port, e_jax)


def test_checkpoint_round_trip_and_resume(tmp_path):
    cfg = tsf.TimeSformerConfig(**KW)
    g, l = (torch.from_numpy(a) for a in _crops(9))

    def fresh(seed):
        state, core, mask = ssl.init_train_state(cfg, out_dim=OUT, seed=seed,
                                                 device="cpu")
        return state, ssl.make_train_step(cfg, core, mask, n_local_crops=2)

    state, step = fresh(0)
    state, _ = step(state, g, l, 1e-3, 0.04, 0.99, 0.04, True)
    path = str(tmp_path / "out" / "checkpoint")
    assert checkpoint.restore_checkpoint(path, state) == (None, {})
    checkpoint.save_checkpoint(path, state, {"epoch": 1})
    other, step2 = fresh(1)
    restored, run_vars = checkpoint.restore_checkpoint(path, other)
    assert run_vars == {"epoch": 1} and restored.step == 1
    for a, b in [(state.student, restored.student), (state.teacher, restored.teacher)]:
        for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert na == nb and torch.equal(pa, pb), na
    assert torch.equal(state.center, restored.center)
    # one more step from each: identical
    s1, m1 = step(state, g, l, 1e-3, 0.04, 0.99, 0.04, False)
    s2, m2 = step2(restored, g, l, 1e-3, 0.04, 0.99, 0.04, False)
    assert float(m1["loss"]) == float(m2["loss"])
    for (_, pa), (_, pb) in zip(s1.student.named_parameters(), s2.student.named_parameters()):
        assert torch.equal(pa, pb)


def test_unported_variants_raise():
    cfg = tsf.TimeSformerConfig(**KW)
    _, core, mask = ssl.init_train_state(cfg, out_dim=OUT, device="cpu")
    for kw in [dict(remat=True), dict(two_token=True),
               dict(backbone_forward=lambda p, x: x)]:
        with pytest.raises(NotImplementedError):
            ssl.make_train_step(cfg, core, mask, **kw)
    with pytest.raises(NotImplementedError):
        ssl.init_train_state(cfg, out_dim=OUT, device="cpu", two_token=True)


def test_train_route_gate():
    """JAX's glue-free gate: bf16, D % 128 == 0, head dim < 128; vit_tiny
    (D = 192) and every f32 model take the plain route."""
    assert tsf.train_route(tsf.vit_base_config(), torch.bfloat16) == "kernels"
    assert tsf.train_route(tsf.vit_small_config(), torch.bfloat16) == "kernels"
    assert tsf.train_route(tsf.vit_tiny_config(), torch.bfloat16) == "plain"
    assert tsf.train_route(tsf.vit_base_config(), torch.float32) == "plain"
    assert tsf.train_route(tsf.TimeSformerConfig(embed_dim=256, num_heads=2),
                           torch.bfloat16) == "plain"  # head dim 128


def test_train_ssl_cli_one_step_and_resume(tmp_path, capsys):
    """The port's CLI twin of ``tests/test_train_cli.py``, in process on the
    CPU with the JAX test's flags: one step on a two-video corpus writes a
    finite loss to log.txt and a checkpoint; a second run resumes from it
    and trains no further epoch."""
    import json
    import os

    from dino_video_summarization_transformer_tpu.data import video as jvio
    from dino_video_summarization_transformer_tpu_torch import train_ssl
    from dino_video_summarization_transformer_tpu_torch.data import video as vio

    if not vio.native_available():
        pytest.skip("native decoder not built")
    rng = np.random.RandomState(0)
    for name in ("a", "b"):
        fr = rng.randint(0, 256, (40, 256, 320, 3), dtype=np.uint8)
        jvio.write_video(str(tmp_path / f"{name}.avi"), fr, fps=30)
    (tmp_path / "train.csv").write_text("a.avi 0\nb.avi 1\n")
    out_dir = str(tmp_path / "out")
    argv = [
        "--arch", "vit_tiny",
        "--cfg", os.path.join(conftest.REPO_ROOT,
                              "configs/kinetics/timesformer_divst_8x32_224.yaml"),
        "--data_path", str(tmp_path), "--output_dir", out_dir,
        "--batch_size_per_gpu", "2", "--epochs", "1", "--warmup_epochs", "0",
        "--local_crops_number", "2", "--out_dim", "1024", "--num_workers", "2",
        "--use_fp16", "false", "--max_steps_per_epoch", "1",
        "--saveckp_freq", "0", "--device", "cpu",
        "--opts", "DATA.NUM_FRAMES", "2", "DATA.SAMPLING_RATE", "4",
    ]
    train_ssl.main(argv)
    rec = json.loads(open(os.path.join(out_dir, "log.txt")).read().splitlines()[-1])
    assert np.isfinite(rec["train_loss"]) and rec["epoch"] == 0
    assert os.path.exists(os.path.join(out_dir, "checkpoint"))
    capsys.readouterr()
    train_ssl.main(argv)
    out = capsys.readouterr().out
    assert "Resumed from" in out and "Block route: plain" in out
    assert len(open(os.path.join(out_dir, "log.txt")).read().splitlines()) == 1
    with pytest.raises(NotImplementedError):
        train_ssl.main(argv + ["MODEL.TWO_TOKEN", "True"])
    with pytest.raises(NotImplementedError):
        train_ssl.main(["--two_token", "true"] + argv)


def test_dino_augmentation_matches_jax():
    """The port's multi-crop augmentation is the JAX package's numpy code:
    the same RandomState draws give the same crops, bit for bit."""
    from dino_video_summarization_transformer_tpu.data import transform as jtr
    from dino_video_summarization_transformer_tpu_torch.data import transform as tr

    r = np.random.RandomState(12)
    clips = [r.randint(0, 256, (2, 3, 60, 80)).astype(np.float32)
             for _ in range(10)]
    got = tr.VideoDataAugmentationDINO(rng=np.random.RandomState(3))(
        clips, from_list=True)
    want = jtr.VideoDataAugmentationDINO(rng=np.random.RandomState(3))(
        clips, from_list=True)
    assert [c.shape for c in got] == [(2, 3, 224, 224)] * 2 + [(2, 3, 96, 96)] * 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    frames = r.randint(0, 256, (40, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tr.temporal_sampling(frames, 5, 39, 8),
                                  jtr.temporal_sampling(frames, 5, 39, 8))
