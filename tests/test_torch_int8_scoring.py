"""The int8 tiers of the scorer (``teacher_quant`` / ``student_quant``) on
the CPU, against the JAX package's ``FrameScorer`` with the same options.

The port quantizes the original state dict once (``ops/quant.py``) and
builds the quantized teacher or students from it; on the kernel route
(``use_kernels=True``, the twins on CPU tensors) their blocks run the int8
tier of rows 1 and 2, on the plain route ``quant.int8_linear``. JAX runs
its whole-block Pallas kernels in interpret mode (``use_pallas=True``) or
its XLA path with ``int8_linear``.

Sizes: D = 128 with 2 heads, depth 2, 32-px frames, on two cases:
* "small", the bf16 scorer's (tests/test_torch_scoring.py: seed 1's
  weights, a 12-frame clip, local 3 / global 8 windows, chunk 4);
* "clip", the slice's window geometry (the mixed teacher's case,
  tests/test_torch_mixed_teacher.py: seed 0's weights, a 44-frame clip,
  local 3 / global 30 windows, chunk 8), on which the teacher distribution
  (temperature 0.02) is not one-hot.

Tolerances, for each of teacher-int8, student-int8 and both:
* on "small", the f32 plain scorer against JAX's f32 scorer, per-frame
  losses within 1e-3 relative (the same codes of the same weights; f32
  summation order differs); the bf16 kernel route against JAX's bf16
  Pallas scorer, per frame within 0.25 x the mean f32 loss, the bf16
  scorer's rule (the teacher softmax at temperature 0.02 multiplies
  feature rounding by 50, and the two tiers round at different points);
* on "clip", Spearman rank correlation against the unquantized scorer of
  the same route above 0.9, JAX's rule (tests/test_quant.py); and with
  both int8 (the teacher's and the students' tier at once) the bf16
  kernel route's losses no further from JAX's f32 int8 scorer's than
  JAX's bf16 Pallas scorer's (mean, 1.5x + 1e-3; reading 0.064 against
  0.079; teacher-int8 alone read 0.045 against 0.062, student-int8 0.047
  against 0.032). The per-frame rules hold there for no bf16 tier, the
  unquantized one included: the port's and JAX's bf16 kernel routes sit
  up to 0.44 x the mean f32 loss apart without int8 (0.78, 0.44 and 0.77
  with teacher, student and both int8, readings on the CPU), and an int8
  code that flips between two f32 paths (a value within an ulp of a
  rounding boundary) moves a teacher loss by up to 36%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch import dino_similarity as cli
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import banded
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import quant
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video

f32, bf16 = torch.float32, torch.bfloat16
KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          num_frames=4, num_classes=0)
CONFIGS = {"teacher": dict(teacher_quant="int8"),
           "student": dict(student_quant="int8"),
           "both": dict(teacher_quant="int8", student_quant="int8")}
PORT_BF16 = dict(use_kernels=True, compute_dtype=bf16, precision=None)
JAX_BF16 = dict(use_pallas=True, compute_dtype=jnp.bfloat16, precision=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, T, global_size, chunk, video_seed):
    jcfg, cfg = jtsf.TimeSformerConfig(**KW), tsf.TimeSformerConfig(**KW)
    params = jsyn.make_numpy_params(jcfg, seed=seed)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)
    vid = make_video(seed=video_seed, T=T, size=32)
    frames = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "sd": sd, "frames": frames,
            "idx": window_indices(T, 3, global_size), "T": T,
            "geo": dict(local_size=3, global_size=global_size, chunk=chunk), "cache": {}}


@pytest.fixture(scope="module")
def small():
    return _case(1, 12, 8, 4, 4)


def _port(clip, **kw):
    sc = scoring.FrameScorer(clip["sd"], clip["cfg"], device="cpu", **clip["geo"], **kw)
    return sc, sc.score_video(clip["frames"], *clip["idx"])


def _cached(clip, key, fn):
    if key not in clip["cache"]:
        clip["cache"][key] = fn()
    return clip["cache"][key]


def _jax(clip, **kw):
    return _cached(clip, ("jax", str(sorted(kw.items(), key=str))), lambda: jscoring.FrameScorer(
        clip["params"], clip["jcfg"], **clip["geo"], **kw).score_video(clip["frames"],
                                                                    *clip["idx"]))


def _port_bf16(clip, name):
    """The port's bf16 kernel-route losses with CONFIGS[name]."""
    return _cached(clip, ("port bf16", name),
                   lambda: _port(clip, **PORT_BF16, **CONFIGS[name])[1])


def _f32(clip):
    """The unquantized f32 scorer's losses (the f32 loss scale)."""
    return _cached(clip, "f32", lambda: _port(clip)[1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f32_int8_scorer_matches_jax(small, name):
    """The f32 plain scorer with the int8 option == JAX's f32 scorer with
    it, per frame within 1e-3 relative; the quantized side holds codes (its
    QuantLinear layers), the other side float weights."""
    kw = CONFIGS[name]
    want = _jax(small, compute_dtype=jnp.float32, precision="highest", **kw)
    sc, got = _port(small, **kw)
    assert sc.model.quantized == ("student_quant" in kw)
    assert sc.t_model.quantized == ("teacher_quant" in kw)
    assert (sc.t_model is sc.model) == (name == "both")
    assert got.shape == (small["T"],) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_kernel_route_int8_scorer_matches_jax(small, name):
    """The bf16 kernel route with the int8 option (the twins of rows 1 and
    2's int8 tier for the quantized side, their bf16 tier for the other)
    against JAX's bf16 Pallas scorer with it: per frame within 0.25 x the
    mean f32 loss; no launch on CPU tensors."""
    kw = CONFIGS[name]
    want = _jax(small, **JAX_BF16, **kw)
    calls = []
    real = fb.temporal_phase_tm

    def spy(x, p, *a, **k):
        calls.append(fb.is_q8(p))
        return real(x, p, *a, **k)

    before = dict(fb.launches)
    fb.temporal_phase_tm = spy
    try:
        sc, got = _port(small, **PORT_BF16, **kw)
    finally:
        fb.temporal_phase_tm = real
    assert dict(fb.launches) == before
    assert sc.model_cfg.use_kernels
    # each chunk: the student forward, then the teacher forward, each over
    # the two blocks
    n_chunks = -(-small["T"] // small["geo"]["chunk"])
    pattern = [("student_quant" in kw)] * 2 + [("teacher_quant" in kw)] * 2
    assert calls == pattern * n_chunks
    assert np.all(np.isfinite(got)) and got.shape == (small["T"],)
    scale = np.abs(_f32(small)).mean()
    assert np.abs(got - want).max() <= 0.25 * scale, (np.abs(got - want).max(), scale)


def test_student_int8_with_the_mixed_teacher(small):
    """``student_quant`` with the mixed teacher (the pairing behind JAX's
    turbo2e-mt-q8s): int8 bf16 students, the f32 float teacher; against
    JAX's same scorer (Pallas) by the bf16 rule."""
    kw = dict(student_quant="int8", teacher_dtype=f32)
    want = _jax(small, **JAX_BF16, student_quant="int8", teacher_dtype=jnp.float32)
    sc, got = _port(small, **PORT_BF16, **kw)
    assert sc.model.quantized and not sc.t_model.quantized
    assert sc.t_model.pos_embed.dtype == f32 and sc.model.pos_embed.dtype == bf16
    scale = np.abs(_f32(small)).mean()
    assert np.abs(got - want).max() <= 0.25 * scale


@pytest.mark.parametrize("kw", [dict(teacher_quant="int8", band_mode="both"),
                                dict(student_quant="int8", band_mode="teacher"),
                                dict(teacher_quant="int8", teacher_dtype=f32,
                                     compute_dtype=bf16)])
def test_refused_combinations_raise(small, kw):
    """(The name predates their ports.) Banded scoring with either int8
    option raises NotImplementedError on the kernel route only, naming
    JAX's Pallas refusal, and builds its quantized model on the plain
    route; ``teacher_quant`` with the mixed teacher builds a quantized f32
    teacher on the kernel route. An option other than None / "int8" raises
    ValueError."""
    if "band_mode" in kw:
        with pytest.raises(NotImplementedError, match="Pallas banded route"):
            scoring.FrameScorer(small["sd"], small["cfg"], device="cpu", **small["geo"],
                                **PORT_BF16, **kw)
        sc = scoring.FrameScorer(small["sd"], small["cfg"], device="cpu", **small["geo"], **kw)
        assert not sc.model_cfg.use_kernels
    else:
        sc = scoring.FrameScorer(small["sd"], small["cfg"], device="cpu", **small["geo"],
                                 **{**PORT_BF16, **kw})
        assert sc.model_cfg.use_kernels and sc.t_model.pos_embed.dtype == f32
    assert sc.t_model.quantized == ("teacher_quant" in kw)
    assert sc.model.quantized == ("student_quant" in kw)
    with pytest.raises(ValueError, match="int8"):
        scoring.FrameScorer(small["sd"], small["cfg"], device="cpu", student_quant="int4")


def test_quantized_model_refuses_what_its_kernels_do_not_take(small):
    """On the kernel route a quantized model runs only the whole-block pair:
    a geometry the kernels refuse raises (no plain fallback); the per-phase
    dispatch, the banded pass's kernel route and training raise on a
    quantized model (its banded pass runs on the plain route)."""
    cfg = tsf.TimeSformerConfig(**{**KW, "embed_dim": 192, "num_heads": 3})
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jsyn.make_numpy_params(
        jtsf.TimeSformerConfig(**{**KW, "embed_dim": 192, "num_heads": 3}), seed=0)), cfg)
    sc = scoring.FrameScorer(sd, cfg, device="cpu", student_quant="int8", **small["geo"],
                             **PORT_BF16)
    with pytest.raises(ValueError, match="multiples of 128"):
        sc.score_video(small["frames"], *small["idx"])
    model = tsf.build_timesformer(small["cfg"], quant.quantize_state_dict_int8(small["sd"]),
                                  device="cpu", dtype=bf16)
    x = torch.zeros(1, 3, 3, 32, 32, dtype=bf16)
    cls, grid = model.tokens(x)
    B, T, N, D = grid.shape
    with pytest.raises(NotImplementedError, match="float-only"):
        model.blocks[0](cls, grid.transpose(1, 2).reshape(B, N * T, D), B, T, N,
                        use_fused=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        model.forward_train(x.float())
    # the quantized model's plain route runs int8_linear in every block
    kmodel = tsf.build_timesformer(dataclasses.replace(small["cfg"], use_kernels=True),
                                   quant.quantize_state_dict_int8(small["sd"]),
                                   device="cpu", dtype=bf16)
    # the banded pass: the plain route only (JAX's XLA route), as JAX's
    # Pallas banded route has no int8 tier
    with pytest.raises(NotImplementedError, match="Pallas banded route"):
        banded.banded_cls_features(kmodel, torch.zeros(8, 32, 32, 3, dtype=bf16), 8, 3)
    rows = banded.banded_cls_features(model, torch.zeros(8, 32, 32, 3, dtype=bf16), 8, 3)
    assert rows.shape == (8, D) and torch.isfinite(rows).all()
    got, want = kmodel(x).float(), model(x).float()
    assert got.shape == want.shape == (1, D) and torch.isfinite(got).all()


def test_cli_takes_the_int8_flags_and_refuses_their_unported_pairings():
    """``--teacher_quant int8`` and ``--student_quant int8`` pass the CLI's
    check alone, together and with ``--teacher_precision float32``, and
    with ``--band`` in f32 or on the CPU (the plain route); with ``--band``
    in bfloat16 on the card (the kernel route) either raises, naming JAX's
    Pallas refusal."""
    parse = cli.get_args_parser().parse_args
    for argv in (["--teacher_quant", "int8"], ["--student_quant", "int8"],
                 ["--teacher_quant", "int8", "--student_quant", "int8"],
                 ["--student_quant", "int8", "--teacher_precision", "float32"],
                 ["--teacher_quant", "int8", "--teacher_precision", "float32"],
                 ["--teacher_quant", "int8", "--band", "both"],
                 ["--student_quant", "int8", "--band", "teacher", "--precision",
                  "bfloat16", "--device", "cpu"]):
        cli.check_unported(parse(argv))
    for argv in (["--teacher_quant", "int8", "--band", "both", "--precision", "bfloat16"],
                 ["--student_quant", "int8", "--band", "teacher", "--precision",
                  "bfloat16"]):
        with pytest.raises(NotImplementedError, match="Pallas banded route"):
            cli.check_unported(parse(argv))


# ---------------------------------------------------------------------------
# The slice's window geometry
# ---------------------------------------------------------------------------

T_CLIP = 44


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra * ra).sum() * (rb * rb).sum()))


@pytest.fixture(scope="module")
def clip():
    return _case(0, T_CLIP, 30, 8, 2)


@pytest.mark.parametrize("name", ["both"])
def test_bf16_int8_scorer_no_further_from_f32_int8_than_jax(clip, name):
    """On the 30-frame teacher windows: the bf16 kernel route's int8 losses
    no further from JAX's f32 int8 scorer's than JAX's bf16 Pallas int8
    scorer's (mean, 1.5x + 1e-3)."""
    kw = CONFIGS[name]
    ref = _jax(clip, compute_dtype=jnp.float32, precision="highest", **kw)
    e_jax = np.abs(_jax(clip, **JAX_BF16, **kw) - ref).mean()
    e_port = np.abs(_port_bf16(clip, name) - ref).mean()
    assert e_port <= 1.5 * e_jax + 1e-3, (e_port, e_jax)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_scorer_ranks_frames_as_the_unquantized_one(clip, name):
    """Spearman of each int8 scorer against the unquantized scorer of the
    same route above 0.9, on the f32 plain route and the bf16 kernel route
    (JAX's rule for its int8 tiers)."""
    kw = CONFIGS[name]
    plain_f32 = _port(clip, **kw)[1]
    kern = _port_bf16(clip, name)
    base_kern = _cached(clip, "bf16", lambda: _port(clip, **PORT_BF16)[1])
    rho32 = _spearman(plain_f32, _f32(clip))
    rho16 = _spearman(kern, base_kern)
    assert rho32 > 0.9 and rho16 > 0.9, (rho32, rho16)
