"""The banded mixed teacher (JAX's bench modes ``band-mt``: band_mode
"both", and ``band-t-mt``: "teacher", each with bf16 students and an f32
teacher) in the port's scorer against the JAX package's, on the CPU.

Model: depth 2, 32 x 32 frames, D = 256 with 4 heads (head dim 64, the
kernels' geometry), numpy-seeded weights crossed with
``convert.state_dict_from_jax_params``; one 90-frame clip scored in
segments (``band_chunk`` 64, ``band_halo`` 16: three segments, the last
padded into its bucket). The port runs its kernel route (the kernels' plain
twins on CPU tensors): the f32 teacher pass on the f32 tiers of the banded
spatial phase and the grid MLP, the bf16 students on the bf16 tiers. JAX
runs its XLA route (``use_pallas=False``), the plain reference.

Tolerances, as for the bf16 banded scorer (tests/test_torch_banded_scoring.py
(c)), each held against the f32 banded scorer's losses:
* per frame |port - f32| <= 0.5 x the mean f32 loss;
* mean |port - f32| <= 1.5 x JAX mixed's + 1e-3.
Every mode of JAX's ``bench.py`` (``MODES``, through its own
``mode_scorer_kwargs``, dtypes mapped to torch's and ``use_pallas`` to
``use_kernels``) builds the port's scorer and scores a 32-frame clip to
finite losses of the clip's length.
The teacher's precision: at ``teacher_temp`` 0.1, where this random-weight
teacher's softmax is not one-hot (at 0.02 it is, and a few argmax flips
decide any loss rule), the port's mixed scorer sits strictly closer to the
f32 losses than its bf16 banded scorer (the card's rule (b),
chip_smoke.py phase 6b).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import bench
from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import banded
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.utils.flops import banded_pass_flops
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video

f32, bf16 = torch.float32, torch.bfloat16
KW = dict(img_size=32, patch_size=16, embed_dim=256, depth=2, num_heads=4,
          num_frames=8, num_classes=0)
GEO = dict(local_size=3, global_size=30, chunk=8, band_chunk=64, band_halo=16)
T = 90
MIXED = dict(use_kernels=True, compute_dtype=bf16, teacher_dtype=f32, precision=None)
STAT_KEYS = ("teacher_rows", "student_rows", "band_teacher_frames",
             "band_student_frames", "band_flops")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = jtsf.TimeSformerConfig(**KW), tsf.TimeSformerConfig(**KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=4))
    vid = make_video(seed=7, T=T, size=32)
    frames = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    return {"jcfg": jcfg, "cfg": cfg, "params": params,
            "sd": convert.state_dict_from_jax_params(params, cfg),
            "frames": frames, "idx": window_indices(T, 3, 30), "cache": {}}


def _cached(case, key, fn):
    if key not in case["cache"]:
        case["cache"][key] = fn()
    return case["cache"][key]


def _port(case, mode, **kw):
    def run():
        sc = scoring.FrameScorer(case["sd"], case["cfg"], device="cpu", band_mode=mode,
                                 **GEO, **kw)
        return sc, sc.score_video(case["frames"], *case["idx"])
    return _cached(case, ("port", mode, str(sorted(kw.items(), key=str))), run)


def _jax(case, mode, **kw):
    def run():
        sc = jscoring.FrameScorer(case["params"], case["jcfg"], band_mode=mode, **GEO, **kw)
        return sc, sc.score_video(case["frames"], *case["idx"])
    return _cached(case, ("jax", mode, str(sorted(kw.items(), key=str))), run)


@pytest.mark.parametrize("mode", ["both", "teacher"])
def test_banded_mixed_scorer_matches_jax(case, mode):
    """``band-mt`` / ``band-t-mt``: the port's banded mixed scorer against
    JAX's (XLA route), both held against the f32 banded losses; JAX's row
    and frame counts; no launch on CPU tensors."""
    before = (dict(fb.launches), dict(bb.launches))
    sc, got = _port(case, mode, **MIXED)
    assert (dict(fb.launches), dict(bb.launches)) == before
    assert sc.model_cfg.use_kernels and sc.teacher_dtype == f32
    assert sc.t_model.pos_embed.dtype == f32 and sc.model.pos_embed.dtype == bf16
    assert len(sc._band_segments(T)) == 3
    js, want = _jax(case, mode, use_pallas=False, compute_dtype=jnp.bfloat16,
                    teacher_dtype=jnp.float32, precision=None)
    _, ref = _port(case, mode)  # the f32 banded scorer (TF32 off)
    assert got.shape == (T,) and np.all(np.isfinite(got)) and np.all(np.isfinite(want))
    e_port, e_jax = np.abs(got - ref), np.abs(want - ref)
    print(f"{mode}: mean f32 loss {ref.mean():.4f}; |. - f32| mean: port mixed "
          f"{e_port.mean():.3e}, JAX mixed {e_jax.mean():.3e}; port max {e_port.max():.3e}")
    assert e_port.max() <= 0.5 * ref.mean(), (e_port.max(), ref.mean())
    assert e_port.mean() <= 1.5 * e_jax.mean() + 1e-3, (e_port.mean(), e_jax.mean())
    for k in STAT_KEYS[:-1]:
        assert sc.stats[k] == js.stats[k], k
    # each pass of each segment counted once, at the kernel route's count
    # (S = eff keys a query; JAX counts its route's own slab here)
    effs = (30, 3) if mode == "both" else (30,)
    assert sc.stats["band_flops"] == pytest.approx(sum(
        banded_pass_flops(case["cfg"], sc._band_bucket(w1 - w0), eff, 32, fused=True)
        for w0, w1, _, _ in sc._band_segments(T) for eff in effs))


def test_banded_mixed_teacher_is_closer_to_f32_than_bf16(case):
    """At teacher_temp 0.1 (the teacher softmax not one-hot): the banded
    mixed scorer's mean |loss - f32 loss| strictly below the bf16 banded
    scorer's, on the same kernel route."""
    kw = dict(teacher_temp=0.1)
    _, mixed = _port(case, "both", **MIXED, **kw)
    _, bf = _port(case, "both", use_kernels=True, compute_dtype=bf16, precision=None, **kw)
    _, ref = _port(case, "both", **kw)
    e_mixed, e_bf16 = np.abs(mixed - ref).mean(), np.abs(bf - ref).mean()
    print(f"teacher_temp 0.1: mean |. - f32|: mixed {e_mixed:.3e}, bf16 {e_bf16:.3e}")
    assert e_mixed < e_bf16, (e_mixed, e_bf16)


@pytest.mark.parametrize("mode", ["both", "teacher"])
def test_banded_mixed_runs_each_pass_in_its_models_dtype(case, monkeypatch, mode):
    """Each segment's teacher pass takes f32 views (the clip's f32 frames
    bit for bit) on the f32 model, whose spatial phase and grid MLP run
    their f32 tiers; the student pass (``"both"``) takes bf16 views on the
    bf16 model and its bf16 tiers; the hybrid's exact students run the bf16
    windowed pair."""
    seen = []

    def spy(name, mod):
        real = getattr(mod, name)

        def fn(*a, **k):
            seen.append((name, a[0].dtype))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, fn)

    real_pass = banded.banded_cls_features
    want32 = torch.from_numpy(case["frames"][:40])

    def pass_spy(model, frames, *a, **k):
        seen.append(("pass", model.pos_embed.dtype, frames.dtype))
        # the clip's frames in the pass's dtype, bit for bit (one segment;
        # its padding rows repeat the last frame)
        idx = np.minimum(np.arange(frames.shape[0]), len(want32) - 1)
        assert torch.equal(frames, want32[idx].to(frames.dtype))
        return real_pass(model, frames, *a, **k)

    monkeypatch.setattr(banded, "banded_cls_features", pass_spy)
    spy("spatial_phase_pf", bb)
    spy("mlp_phase", fb)
    spy("temporal_phase_tm", fb)
    sc = scoring.FrameScorer(case["sd"], case["cfg"], device="cpu", band_mode=mode,
                             **GEO, **MIXED)
    sc.score_video(case["frames"][:40], *window_indices(40, 3, 30))
    passes = [s for s in seen if s[0] == "pass"]
    want = [("pass", f32, f32)] + ([("pass", bf16, bf16)] if mode == "both" else [])
    assert passes == want
    tiers = {s for s in seen if s[0] != "pass"}
    want = {("spatial_phase_pf", f32), ("mlp_phase", f32)}
    want |= ({("spatial_phase_pf", bf16), ("mlp_phase", bf16)} if mode == "both"
             else {("temporal_phase_tm", bf16)})
    assert tiers == want


@pytest.fixture(scope="module")
def modes_case():
    """D = 128 with 2 heads: the int8 and f32 kernel tiers' geometry (the
    banded kernels take it too)."""
    kw = dict(KW, embed_dim=128, num_heads=2)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=2))
    vid = make_video(seed=9, T=32, size=32)
    return {"jcfg": jcfg, "cfg": cfg, "params": params,
            "sd": convert.state_dict_from_jax_params(params, cfg),
            "frames": (vid.astype(np.float32) / 255.0 - 0.45) / 0.225,
            "idx": window_indices(32, 3, 30)}


@pytest.mark.parametrize("mode", list(bench.MODES))
def test_every_bench_mode_scores(modes_case, mode):
    """JAX's bench mode ``mode`` on the port: the scorer builds with the
    mode's kwargs, its models in the mode's dtypes and quantization, and
    scores the clip to finite losses (CPU tensors: the kernel route's
    twins where ``use_pallas`` asks for the kernels, the plain route on
    "auto"). Each mode's losses against JAX's are the other tests'
    (tests/test_torch_strided_scoring.py, the banded ones here)."""
    kw = bench.mode_scorer_kwargs(mode)
    dtypes = {jnp.float32: f32, jnp.bfloat16: bf16, None: None}
    port_kw = dict(kw, compute_dtype=dtypes[kw["compute_dtype"]],
                   teacher_dtype=dtypes[kw["teacher_dtype"]])
    port_kw["use_kernels"] = port_kw.pop("use_pallas")
    geo = dict(local_size=3, global_size=30, chunk=8)
    sc = scoring.FrameScorer(modes_case["sd"], modes_case["cfg"], device="cpu", **geo,
                             **port_kw)
    got = sc.score_video(modes_case["frames"], *modes_case["idx"])
    assert got.shape == (32,) and np.all(np.isfinite(got))
    assert sc.teacher_dtype == (f32 if kw["teacher_dtype"] is not None
                                else port_kw["compute_dtype"])
    assert sc.t_model.quantized == (kw["teacher_quant"] is not None)
    assert sc.model.quantized == (kw["student_quant"] is not None)
