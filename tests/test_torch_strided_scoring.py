"""The port's strided scorer against the JAX package's, on the CPU, at f32
with ``precision="highest"`` on the same numpy-seeded weights
(``make_numpy_params`` through ``state_dict_from_jax_params``).

(a) The golden rows ``turbo_k4_T40`` and ``turbo2_k8cr_T40`` of
    tests/golden/scores_f32.json (tools/gen_golden_scores.py's config),
    atol = rtol = 1e-5, as tests/test_golden_scores.py holds JAX to.
(b) Each knob on the per-video path (embed 64, depth 2, 2 heads, 32 px,
    48 frames (32 where every teacher window runs), chunk 8, teacher_temp
    0.1: at the default 0.02 this
    random-weight teacher's softmax is one-hot and the strided losses equal
    the exact ones to 2e-7, so no loss could show the teacher rows'
    interpolation; at 0.1 linear and Catmull-Rom differ by 8e-3): teacher_stride 4 and 8 with linear and
    Catmull-Rom, teacher_refine, teacher_adaptive, score_stride 2 with
    score_refine (one case that bails, one that does not),
    global_subsample 2, teacher_target "probs", teacher_img (48 -> 32 px,
    exact windows and stride 4, 32 frames), student_dispatch 1: losses atol = rtol =
    1e-5 of JAX's, and ``teacher_rows`` / ``student_rows`` equal to JAX's.
(c) The group path (two videos, 48 and 40 frames, sharing chunks) against
    the per-video path: the port's group losses within 1e-5 of its own
    per-video losses and of JAX's, its row counts their sum.
(d) The properties of JAX's tests/test_fast_scoring.py that read no
    reference files, on the port (stride 1 equal to the exact path bit
    for bit, the probs target exact at the knots and equal to the
    interpolated knot losses, unreachable refinement thresholds equal to
    the plain stride, the bail, student_dispatch 4 equal to 1 bit for bit
    per video and per group).
(e) ``band_mode`` with each strided knob raises JAX's ValueError naming
    the knob; banded int8 raises NotImplementedError on the kernel route
    only, and the pairings the scorer once refused score.
(The CLI: tests/test_torch_strided_cli.py.)
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import conftest

import jax

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import banded
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import quant
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_params, make_video)

sys.path.insert(0, os.path.join(conftest.REPO_ROOT, "tools"))
from gen_golden_scores import GOLDEN_PATH  # noqa: E402

KW = dict(patch_size=16, num_heads=2, num_classes=0, embed_dim=64, depth=2, num_frames=4)
TOL = dict(atol=1e-5, rtol=1e-5)
T1, T2, T3 = 48, 40, 32  # T3: the tests that run every teacher window
TEMP = 0.1  # the teacher temperature of (b)-(d)


def _normalized(vid):
    return (vid.astype(np.float32) / 255.0 - 0.45) / 0.225


@pytest.mark.parametrize("name,kw", [
    ("turbo_k4_T40", dict(teacher_stride=4)),
    ("turbo2_k8cr_T40", dict(teacher_stride=8, teacher_interp="catmullrom"))])
def test_f32_strided_scorer_matches_golden(name, kw):
    """The config of tools/gen_golden_scores.py (student_dispatch at its
    default, 4: the student pass takes 4 chunks a call)."""
    cfg = tsf.TimeSformerConfig(img_size=224, **KW)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, 0), cfg)
    scorer = scoring.FrameScorer(sd, cfg, local_size=3, global_size=30, chunk=8,
                                 device="cpu", **kw)
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[name]
    loc, glob, eff = window_indices(40, 3, 30)
    got = scorer.score_video(_normalized(make_video(seed=3, T=40, size=224)),
                             loc, glob, eff)
    np.testing.assert_allclose(got, want, **TOL)


class _Setup:
    """Module-wide weights, clips and cached scorers and results; the JAX
    scorers of one dtype, teacher target and teacher_img share their
    compiled functions (which read nothing else of the scorer)."""

    def __init__(self):
        self.models = {}
        self.clips = {}
        self.jax_base = {}
        self.cache = {}

    def model(self, img):
        if img not in self.models:
            jcfg, cfg = (jtsf.TimeSformerConfig(img_size=img, **KW),
                         tsf.TimeSformerConfig(img_size=img, **KW))
            params = jsyn.make_numpy_params(jcfg, seed=0)
            sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)
            self.models[img] = (jcfg, cfg, params, sd)
        return self.models[img]

    def clip(self, T, img=32, seed=None):
        key = (T, img)
        if key not in self.clips:
            vid = make_video(seed=5 if seed is None else seed, T=T, size=img)
            self.clips[key] = (_normalized(vid), *window_indices(T, 3, 30))
        return self.clips[key]

    def jax(self, T=T1, img=32, **kw):
        key = ("jax", T, img, tuple(sorted(kw.items())))
        if key not in self.cache:
            jcfg, _, params, _ = self.model(img)
            sc = jscoring.FrameScorer(params, jcfg, chunk=8, teacher_temp=TEMP, **kw)
            base = (kw.get("teacher_target", "cls"), kw.get("teacher_img", 0), img)
            if base in self.jax_base:
                sc._jitted = self.jax_base[base]._jitted
            else:
                self.jax_base[base] = sc
            before = dict(sc.stats)
            out = sc.score_video(*self.clip(T, img))
            self.cache[key] = (out, {k: sc.stats[k] - before[k]
                                     for k in ("teacher_rows", "student_rows")})
        return self.cache[key]

    def port(self, T=T1, img=32, **kw):
        _, cfg, _, sd = self.model(img)
        sc = scoring.FrameScorer(sd, cfg, chunk=8, device="cpu", teacher_temp=TEMP, **kw)
        out = sc.score_video(*self.clip(T, img))
        return out, {k: sc.stats[k] for k in ("teacher_rows", "student_rows")}, sc


@pytest.fixture(scope="module")
def setup():
    return _Setup()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KNOBS = {
    "k4_linear": dict(teacher_stride=4),
    "k4_catmullrom": dict(teacher_stride=4, teacher_interp="catmullrom"),
    "k8_linear": dict(teacher_stride=8),
    "k8_catmullrom": dict(teacher_stride=8, teacher_interp="catmullrom"),
    "k8cr_refine": dict(teacher_stride=8, teacher_interp="catmullrom", teacher_refine=0.02),
    "k8_adaptive": dict(teacher_stride=8, teacher_adaptive=1.0),
    "m2_refine": dict(teacher_stride=4, score_stride=2, score_refine=0.3, score_bail=0.0),
    "m2_refine_bail": dict(teacher_stride=4, score_stride=2, score_refine=1e-9),
    "k4_subsample2": dict(teacher_stride=4, global_subsample=2),
    "k4_probs": dict(teacher_stride=4, teacher_target="probs"),
    "k4_dispatch1": dict(teacher_stride=4, student_dispatch=1),
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_f32_knob_matches_jax(setup, name):
    kw = KNOBS[name]
    want, want_rows = setup.jax(**kw)
    got, rows, _ = setup.port(**kw)
    assert got.dtype == np.float64 and got.shape == (T1,)
    np.testing.assert_allclose(got, want, **TOL)
    assert rows == want_rows, (rows, want_rows)
    plain = {k: v for k, v in kw.items() if k in ("teacher_stride", "score_stride")}
    if name.endswith("refine") or name == "k8_adaptive":
        # the refinement really added rows here (a case that tests nothing
        # would pass trivially)
        _, base_rows = setup.jax(**plain)
        assert rows != base_rows, (rows, base_rows)
    if name == "m2_refine_bail":
        assert rows["student_rows"] == T1  # bailed: every frame scored
    if name == "m2_refine":
        assert T1 // 2 < rows["student_rows"] < 0.9 * T1


@pytest.mark.parametrize("kw", [dict(), dict(teacher_stride=4)], ids=["exact", "k4"])
def test_f32_teacher_img_matches_jax(setup, kw):
    """teacher_img 32 on 48-px frames (a 3 x 3 patch grid resized to 2 x
    2): the bilinear antialiased resize and the nearest positional-grid
    resize, JAX's."""
    want, want_rows = setup.jax(T=T3, img=48, teacher_img=32, **kw)
    got, rows, _ = setup.port(T=T3, img=48, teacher_img=32, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    assert rows == want_rows
    unresized, _, _ = setup.port(T=T3, img=48, **kw)
    assert np.abs(got - unresized).max() > 1e-3  # the resize changes the scores


def test_teacher_img_needs_two_patches(setup):
    _, cfg, _, sd = setup.model(32)
    with pytest.raises(AssertionError):
        scoring.FrameScorer(sd, cfg, device="cpu", teacher_img=16)


def _items(setup, Ts):
    items = []
    for i, T in enumerate(Ts):
        frames, loc, glob, eff = setup.clip(T, seed=5 + i)
        items.append({"path": f"v{i}", "dummy": False, "frames": frames, "local_idx": loc,
                      "global_idx": glob, "eff_global": eff})
    return items


@pytest.mark.parametrize("name", ["k8cr_refine", "m2_refine", "k4_probs", "k8_adaptive",
                                  "k4_subsample2"])
def test_group_path_matches_per_video_and_jax(setup, name):
    """Two videos (48 and 40 frames) in one group: the teacher and student
    chunks shared across them, the refinement readback and passes shared;
    each video's losses equal to its per-video losses and to JAX's."""
    kw = KNOBS[name]
    items = _items(setup, (T1, T2))
    _, cfg, _, sd = setup.model(32)
    sc = scoring.FrameScorer(sd, cfg, chunk=8, device="cpu", teacher_temp=TEMP, **kw)
    grouped = [h.fetch() for h in sc.score_group_async(items)]
    solo_rows = {"teacher_rows": 0, "student_rows": 0}
    for it, g in zip(items, grouped):
        T = it["frames"].shape[0]
        solo, rows, _ = setup.port(T=T, **kw)
        np.testing.assert_allclose(g, solo, **TOL)
        np.testing.assert_allclose(g, setup.jax(T=T, **kw)[0], **TOL)
        for k in solo_rows:
            solo_rows[k] += rows[k]
    assert {k: sc.stats[k] for k in solo_rows} == solo_rows


def test_strided_path_is_exact_at_stride_one(setup):
    """JAX test_strided_path_is_exact_at_stride_one: the strided path at
    stride 1 (teacher pass, then students against its rows) equals the
    exact path bit for bit."""
    exact, _, sc = setup.port(T=T3)
    frames, loc, glob, _ = setup.clip(T3)
    item = {"frames": frames, "local_idx": loc, "global_idx": glob}
    np.testing.assert_array_equal(sc._score_group_strided([item])[0].fetch(), exact)


def test_teacher_target_probs_exact_at_knots_and_loss_interpolation(setup):
    """JAX test_teacher_target_probs_exact_at_knots and
    _is_loss_interpolation: at the knots the probs target gives the exact
    losses; between two knots the loss is the interpolation of the losses
    the student pays against each knot's teacher."""
    exact, _, _ = setup.port(T=T3)
    out, _, sc = setup.port(T=T3, teacher_stride=4, teacher_target="probs")
    frames, loc, glob, _ = setup.clip(T3)
    knots = sc._teacher_positions(np.arange(T3), frames)
    np.testing.assert_allclose(out[knots], exact[knots], rtol=1e-5, atol=1e-7)

    def cls(idx):  # the CLS row of one window, (D,)
        with torch.inference_mode():
            return sc.model(torch.from_numpy(frames[np.asarray(idx)])[None]
                            .permute(0, 4, 1, 2, 3))[0]

    logp = torch.log_softmax(cls(loc[2]) / sc.student_temp, dim=-1)
    losses = [float(-(torch.softmax(cls(glob[k]) / sc.teacher_temp, dim=-1) * logp).sum())
              for k in (0, 4)]
    np.testing.assert_allclose(out[2], 0.5 * losses[0] + 0.5 * losses[1], rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(teacher_stride=8, teacher_interp="catmullrom", teacher_refine=1e9),
    dict(teacher_stride=4, score_stride=2, score_refine=1e9)], ids=["teacher", "score"])
def test_unreachable_refinement_is_the_plain_stride(setup, kw):
    """JAX test_teacher_refine_inf_is_plain_stride and
    test_score_refine_inf_is_plain_stride: no rows added, losses equal."""
    plain_kw = {k: v for k, v in kw.items() if not k.endswith("refine")}
    got, rows, _ = setup.port(**kw)
    want, want_rows, _ = setup.port(**plain_kw)
    np.testing.assert_array_equal(got, want)
    assert rows == want_rows


def test_score_refine_bailout(setup):
    """JAX test_score_refine_bailout_scores_dense and _off_below_threshold:
    a threshold that flags every knot scores every frame, with the bail
    (contiguous) or without it (scattered midpoints), to the same losses;
    an unreachable one stays under the bail fraction."""
    kw = dict(teacher_stride=4, score_stride=2, score_refine=1e-9)
    bail, rows, _ = setup.port(score_bail=0.9, **kw)
    assert rows["student_rows"] == T1
    scatter, _, _ = setup.port(score_bail=0.0, **kw)
    np.testing.assert_allclose(bail, scatter, rtol=2e-5, atol=1e-7)
    _, rows, _ = setup.port(teacher_stride=4, score_stride=2, score_refine=1e9)
    assert rows["student_rows"] < 0.9 * T1


def test_student_dispatch_is_bit_equal_per_video_and_group(setup):
    """student_dispatch 4 (one view gather per 4 chunks, the 48 rows in
    calls of 32 and 16) against 1, per video and per group: bit for bit."""
    kw = dict(teacher_stride=8, teacher_interp="catmullrom")
    a, _, sc1 = setup.port(student_dispatch=1, **kw)
    b, _, sc4 = setup.port(student_dispatch=4, **kw)
    np.testing.assert_array_equal(a, b)
    assert sc4._student_sub(T1) == 4
    items = _items(setup, (T1, T2))
    g1 = [h.fetch() for h in sc1.score_group_async(items)]
    g4 = [h.fetch() for h in sc4.score_group_async(items)]
    for x, y in zip(g1, g4):
        np.testing.assert_array_equal(x, y)


BAND_KNOBS = {"teacher_stride": 2, "score_stride": 2, "global_subsample": 2,
              "teacher_img": 32, "teacher_target": "probs", "teacher_adaptive": 0.5,
              "teacher_refine": 0.5, "score_refine": 0.5}


@pytest.mark.parametrize("knob", list(BAND_KNOBS))
@pytest.mark.parametrize("mode", ["both", "teacher"])
def test_band_mode_with_a_strided_knob_raises(setup, knob, mode):
    """JAX's ValueError, with the same list of names."""
    jcfg, cfg, params, sd = setup.model(32)
    kw = {knob: BAND_KNOBS[knob], "band_mode": mode}
    with pytest.raises(ValueError, match=rf"band_mode does not compose with \['{knob}'\]"):
        jscoring.FrameScorer(params, jcfg, **kw)
    with pytest.raises(ValueError, match=rf"band_mode does not compose with \['{knob}'\]"):
        scoring.FrameScorer(sd, cfg, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(band_mode="both", teacher_quant="int8"),
    dict(band_mode="teacher", student_quant="int8"),
    dict(compute_dtype=torch.bfloat16, teacher_dtype=torch.float32, teacher_quant="int8"),
    dict(compute_dtype=torch.bfloat16, teacher_dtype=torch.float32, band_mode="both")],
    ids=["band_int8_t", "band_int8_s", "tq_mixed", "band_mixed"])
def test_the_refusals_that_stay(setup, kw, monkeypatch):
    """(The name predates their ports.) Of the four pairings the scorer
    refused, banded int8 stays refused on the kernel route only, naming
    JAX's Pallas refusal; on the plain route (JAX's XLA route) it scores
    through the quantized layers. ``teacher_quant`` and ``band_mode`` with
    the mixed teacher score, their teacher on an f32 model (quantized for
    the first) fed f32 views, the students on a bf16 model fed bf16 views."""
    _, cfg, _, sd = setup.model(32)
    frames, loc, glob, eff = setup.clip(T3)
    seen = []
    real_q8 = quant.int8_linear
    monkeypatch.setattr(quant, "int8_linear", lambda x, *a, **k: (
        seen.append(("int8_linear", x.dtype)), real_q8(x, *a, **k))[1])
    real_pass = banded.banded_cls_features
    monkeypatch.setattr(banded, "banded_cls_features", lambda m, fr, *a, **k: (
        seen.append(("pass", m.pos_embed.dtype, fr.dtype, m.quantized)),
        real_pass(m, fr, *a, **k))[1])
    if "band_mode" in kw and any(k.endswith("_quant") for k in kw):
        with pytest.raises(NotImplementedError, match="Pallas banded route"):
            scoring.FrameScorer(sd, cfg, device="cpu", use_kernels=True, **kw)
    sc = scoring.FrameScorer(sd, cfg, device="cpu", **kw)
    got = sc.score_video(frames, loc, glob, eff)
    assert got.shape == (T3,) and np.all(np.isfinite(got))
    t_dtype = torch.float32
    assert sc.t_model.pos_embed.dtype == t_dtype
    assert sc.t_model.quantized == ("teacher_quant" in kw)
    assert sc.model.quantized == ("student_quant" in kw)
    if kw.get("teacher_quant") or kw.get("student_quant"):
        assert ("int8_linear", t_dtype) in seen
    if "band_mode" in kw:
        passes = {s for s in seen if s[0] == "pass"}
        s_dtype = kw.get("compute_dtype", torch.float32)
        want = {("pass", t_dtype, t_dtype, sc.t_model.quantized)}
        if kw["band_mode"] == "both":
            want.add(("pass", s_dtype, s_dtype, sc.model.quantized))
        assert passes == want


def test_bad_knob_values_raise_as_jax(setup):
    _, cfg, _, sd = setup.model(32)
    with pytest.raises(ValueError, match="teacher_interp"):
        scoring.FrameScorer(sd, cfg, device="cpu", teacher_interp="cubic")
    with pytest.raises(ValueError, match="teacher_target"):
        scoring.FrameScorer(sd, cfg, device="cpu", teacher_target="logits")
