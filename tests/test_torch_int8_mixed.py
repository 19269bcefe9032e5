"""The int8 teacher under the mixed teacher (``teacher_quant="int8"`` with
``teacher_dtype=float32``: rows 1qf and 2qf, the int8 tier's f32 block
boundary) and banded int8 on the plain route, on the CPU, against the JAX
package.

Sizes: D = 128 with 2 heads (head dim 64, the kernels' geometry) for the
int8 tiers, D = 64 with 2 heads for the f32 banded scorer; depth 2, 32 x 32
frames, numpy-seeded weights crossed with ``state_dict_from_jax_params``.

Tolerances (fixed before any run):
* rows 1qf and 2qf (their twins on CPU tensors) against JAX's
  ``_temporal_phase_tm_kernel`` / ``_spatial_mlp_kernel`` on f32 x and an
  f32 CLS row with ``qkernel`` weights (Pallas interpret mode): atol = rtol
  = 8e-2, JAX's own bound between its int8 kernels and XLA
  (tests/test_quant.py:91-107), and each branch no further from JAX's f32
  forward on the float weights than Pallas's (mean, 1.1x + 1e-3), as the
  bf16 int8 tier is held (tests/test_torch_quant.py). The f32 tier reads
  its f32 inputs unrounded: on rows with a large common offset it differs
  from the bf16 tier fed the same rows rounded to bf16.
* the int8-teacher mixed scorer: its teacher's weight codes and scales
  are JAX's scorer's (quantized from the original f32 weights) bit for
  bit; against JAX's same scorer (Pallas) per frame within 0.25 x the
  mean f32 loss, the int8 scorers' rule (tests/test_torch_int8_scoring.py
  "small"); its teacher forwards run rows 1qf and 2qf, its students the
  bf16 tiers.
* banded int8 at f32 on the plain route against JAX's XLA banded int8
  scorer: at least 95% of the frames within atol = rtol = 1e-5, as the
  f32 banded path (tests/test_torch_banded_scoring.py (a)), and every frame
  within 5e-3 relative: the same codes of the same weights, f32 sums in
  another order, where an activation value within an ulp of a rounding
  boundary takes another code (one frame of 40 read 2.0e-3 relative with
  the int8 students; tests/test_torch_int8_scoring.py holds the exact-
  window int8 scorers at 1e-3 for the same reason). The kernel route
  refuses it and names JAX's Pallas refusal.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu.ops import quant as jquant
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch import dino_similarity as cli
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import quant, twin_check
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video

D, H = 128, 2
Q8_TOL = 8e-2
f32, bf16 = torch.float32, torch.bfloat16
KW = dict(img_size=32, patch_size=16, num_frames=4, num_classes=0, depth=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, D_=D):
    kw = dict(KW, embed_dim=D_, num_heads=2)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(**kw)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    return jcfg, cfg, params, convert.state_dict_from_jax_params(params, cfg)


def _block(seed):
    """Block 0: JAX's float and quantized blocks, the port's kernel-layout
    weights of its quantized f32 model."""
    _, cfg, params, sd = _weights(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    jq = jax.tree.map(lambda a: a[0], jquant.quantize_tree_int8(
        jax.tree.map(jnp.asarray, params))["blocks"])
    model = tsf.build_timesformer(cfg, quant.quantize_state_dict_int8(sd), device="cpu")
    return jp, jq, fb.block_params(model.blocks[0])


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


def _offset(shape, seed):
    """f32 rows with a large common offset (``twin_check.offset_rows``): a
    tier that rounds them to bf16 before LN loses their spread."""
    return twin_check.offset_rows(np.random.RandomState(seed), shape)


# ---------------------------------------------------------------------------
# Rows 1qf and 2qf against the Pallas int8 tier on f32 boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,N", [(30, 4), (3, 16)])
def test_temporal_phase_tm_q8_f32_in_matches_pallas(T, N):
    """Row 1qf: f32 x -> f32 x + fc on s8 weights, against JAX
    ``_fused_temporal_phase_tm_impl`` on f32 x and the quantized block; the
    branch no further from JAX's f32 temporal phase on the float weights
    than Pallas's; the f32 rows read unrounded."""
    jp, jq, p = _block(seed=T + 40)
    x = _offset((2, T, N, D), seed=N)
    want = _np(jfb._fused_temporal_phase_tm_impl(
        jq["temporal_norm1"], jq["temporal_attn"], jq["temporal_fc"], jnp.asarray(x), H,
        out_dtype=jnp.float32))
    before = dict(fb.launches)
    got = fb.temporal_phase_tm(torch.from_numpy(x), p["temporal"], H)
    assert fb.launches == before and got.dtype == f32
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=Q8_TOL, rtol=Q8_TOL)
    xpm = x.transpose(0, 2, 1, 3).reshape(2 * N, T, D)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(
            jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
            jnp.asarray(xpm), H)).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    _no_further(got - x, want - x, oracle - x)
    # the branch differs from the bf16 tier's on the same rows rounded to
    # bf16 (readings 1e-3 to 4e-3): the LN reads the f32 rows
    xb = torch.from_numpy(x).to(bf16)
    got16 = _np(fb.temporal_phase_tm(xb, p["temporal"], H))
    assert np.abs((got - x) - (got16 - _np(xb))).max() > 1e-4


@pytest.mark.parametrize("T,N", [(30, 4), (3, 16)])
def test_spatial_mlp_q8_f32_cls_matches_pallas(T, N):
    """Row 2qf: the f32 carry and an f32 CLS row -> (f32 grid, f32 per-frame
    CLS rows) on s8 weights, against JAX ``_fused_spatial_mlp_impl`` with
    an f32 CLS row and ``out_dtype=f32``; each no further from JAX's f32
    spatial phase and MLP on the float weights than Pallas's."""
    jp, jq, p = _block(seed=T + 41)
    x1 = np.random.RandomState(N + 1).randn(2, T, N, D).astype(np.float32)
    cls = _offset((2, 1, D), seed=N + 2)
    want_g, want_c = jfb._fused_spatial_mlp_impl(
        jq["norm1"], jq["attn"], jq["norm2"], jq["mlp"], jnp.asarray(cls), jnp.asarray(x1),
        H, out_dtype=jnp.float32)
    got_g, got_c = fb.spatial_mlp(torch.from_numpy(x1), torch.from_numpy(cls),
                                  p["spatial"], H)
    assert got_g.dtype == got_c.dtype == f32
    got_g, got_c, want_g, want_c = _np(got_g), _np(got_c), _np(want_g), _np(want_c)
    np.testing.assert_allclose(got_g, want_g, atol=Q8_TOL, rtol=Q8_TOL)
    np.testing.assert_allclose(got_c, want_c, atol=Q8_TOL, rtol=Q8_TOL)
    seq = np.concatenate([np.broadcast_to(cls[:, None], (2, T, 1, D)), x1], axis=2)
    with jax.default_matmul_precision("highest"):
        res = np.asarray(jtsf.attn_phase(jp["norm1"], jp["attn"],
                                         jnp.asarray(seq.reshape(2 * T, N + 1, D)), H))
        res = res.reshape(2, T, N + 1, D)
        x2 = x1 + res[:, :, 1:]
        oracle_g = np.asarray(jtsf.mlp_phase_res(jp["norm2"], jp["mlp"], jnp.asarray(x2)))
    _no_further(got_g - x1, want_g - x1, oracle_g - x1)
    _no_further(got_c, want_c, res[:, :, 0])
    # the grid is not rounded to bf16 (the bf16 tier's grid is)
    assert twin_check.bf16_exact(torch.from_numpy(got_g)) < 0.01


# ---------------------------------------------------------------------------
# The scorer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """tests/test_torch_int8_scoring.py's "small" case: a 12-frame clip,
    local 3 / global 8 windows, chunk 4."""
    jcfg, cfg, params, sd = _weights(seed=1)
    vid = make_video(seed=4, T=12, size=32)
    frames = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "sd": sd, "frames": frames,
            "idx": window_indices(12, 3, 8), "geo": dict(local_size=3, global_size=8,
                                                         chunk=4)}


def test_int8_teacher_mixed_scorer_matches_jax(small, monkeypatch):
    """``teacher_quant="int8"`` with ``teacher_dtype=float32`` and bf16
    students on the kernel route: the teacher's codes and scales are JAX's
    scorer's bit for bit; its forwards run rows 1qf and 2qf (f32 x, an f32
    CLS row, s8 weights), the students the bf16 tiers; the losses within
    0.25 x the mean f32 loss of JAX's same scorer (Pallas)."""
    seen = []
    for name in ("temporal_phase_tm", "spatial_mlp"):
        def spy(*a, _fn=getattr(fb, name), _name=name, **k):
            seen.append((_name, a[1 if _name == "spatial_mlp" else 0].dtype,
                         fb.is_q8(a[2 if _name == "spatial_mlp" else 1])))
            return _fn(*a, **k)
        monkeypatch.setattr(fb, name, spy)
    before = dict(fb.launches)
    sc = scoring.FrameScorer(small["sd"], small["cfg"], device="cpu", **small["geo"],
                             use_kernels=True, compute_dtype=bf16, teacher_dtype=f32,
                             precision=None, teacher_quant="int8")
    got = sc.score_video(small["frames"], *small["idx"])
    assert dict(fb.launches) == before
    assert sc.t_model.quantized and not sc.model.quantized
    assert sc.t_model.pos_embed.dtype == f32 and sc.model.pos_embed.dtype == bf16
    assert set(seen) == {("temporal_phase_tm", f32, True), ("spatial_mlp", f32, True),
                         ("temporal_phase_tm", bf16, False), ("spatial_mlp", bf16, False)}
    js = jscoring.FrameScorer(small["params"], small["jcfg"], **small["geo"], use_pallas=True,
                              compute_dtype=jnp.bfloat16, teacher_dtype=jnp.float32,
                              precision=None, teacher_quant="int8")
    blk, jblk = sc.t_model.blocks[1], js.t_params["blocks"]
    for lin, jp in ((blk.attn.qkv, jblk["attn"]["qkv"]), (blk.mlp.fc2, jblk["mlp"]["fc2"]),
                    (blk.temporal_fc, jblk["temporal_fc"])):
        np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(jp["qkernel"][1]).T)
        np.testing.assert_array_equal(lin.qscale.numpy().view(np.uint32),
                                      np.asarray(jp["qscale"][1]).view(np.uint32))
    want = js.score_video(small["frames"], *small["idx"])
    scale = np.abs(scoring.FrameScorer(small["sd"], small["cfg"], device="cpu",
                                       **small["geo"]).score_video(
        small["frames"], *small["idx"])).mean()
    assert got.shape == (12,) and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 0.25 * scale, (np.abs(got - want).max(), scale)


# ---------------------------------------------------------------------------
# Banded int8 on the plain route (JAX's XLA route)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def band():
    jcfg, cfg, params, sd = _weights(seed=6, D_=64)
    vid = make_video(seed=40, T=40, size=32)
    frames = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "sd": sd, "frames": frames,
            "idx": window_indices(40, 3, 30)}


@pytest.mark.parametrize("mode,kw", [
    ("both", dict(teacher_quant="int8")), ("teacher", dict(student_quant="int8")),
    ("both", dict(teacher_quant="int8", student_quant="int8"))],
    ids=["both-teacher_int8", "teacher-student_int8", "both-both_int8"])
def test_f32_banded_int8_matches_jax_xla(band, mode, kw):
    """The f32 banded scorer with an int8 option on the plain route (its
    quantized model's ``QuantLinear`` layers in the banded forward) against
    JAX's f32 XLA banded scorer with it (the module docstring's bound);
    the kernel route refuses, naming JAX's Pallas refusal."""
    geo = dict(local_size=3, global_size=30, chunk=8)
    want = jscoring.FrameScorer(band["params"], band["jcfg"], band_mode=mode, **geo,
                                **kw).score_video(band["frames"], *band["idx"])
    sc = scoring.FrameScorer(band["sd"], band["cfg"], device="cpu", band_mode=mode,
                             **geo, **kw)
    assert not sc.model_cfg.use_kernels
    assert sc.t_model.quantized == ("teacher_quant" in kw)
    assert sc.model.quantized == ("student_quant" in kw)
    got = sc.score_video(band["frames"], *band["idx"])
    assert got.shape == (40,) and np.all(np.isfinite(got))
    assert np.mean(np.isclose(got, want, atol=1e-5, rtol=1e-5)) >= 0.95
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=5e-3)
    with pytest.raises(NotImplementedError, match="Pallas banded route"):
        scoring.FrameScorer(band["sd"], band["cfg"], device="cpu", band_mode=mode,
                            use_kernels=True, **geo, **kw)


def test_cli_refuses_banded_int8_only_on_the_kernel_route():
    """``check_unported``: ``--band`` with an int8 flag raises only where the
    scorer would take the kernel route (``--precision bfloat16`` on the
    card); ``--device cpu`` and f32 pass, as does ``--teacher_quant int8``
    with ``--teacher_precision float32``."""
    parse = cli.get_args_parser().parse_args
    for argv in (["--teacher_quant", "int8", "--band", "both"],
                 ["--student_quant", "int8", "--band", "teacher", "--device", "cpu",
                  "--precision", "bfloat16"],
                 ["--teacher_quant", "int8", "--teacher_precision", "float32",
                  "--precision", "bfloat16"],
                 ["--band", "both", "--teacher_precision", "float32",
                  "--precision", "bfloat16"]):
        cli.check_unported(parse(argv))
    with pytest.raises(NotImplementedError, match="Pallas banded route"):
        cli.check_unported(parse(["--teacher_quant", "int8", "--band", "both",
                                  "--precision", "bfloat16"]))
