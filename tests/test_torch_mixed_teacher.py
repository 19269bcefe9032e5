"""The mixed teacher (``teacher_dtype=torch.float32`` with bf16 students)
on the CPU, against the JAX package's.

The teacher forward carries f32 activations and block boundaries through
the f32 tiers of rows 1 (``temporal_phase_tm`` on f32 x), 2
(``spatial_mlp`` with an f32 CLS row and an f32 grid), 3 (``mlp_phase`` on
f32 rows) and 11 (``spatial_phase_pf`` on f32 rows); on the CPU each
wrapper runs its plain twin. JAX runs its Pallas kernels in interpret mode,
as its own tests run them.

Sizes: D = 128 with 2 heads (head dim 64, the kernels' geometry), 4 and 16
positions, T = 3 and 30; the slice at depth 2 on 32-px frames (N = 4) over
a 44-frame clip, windowed (chunk 8). The scorer refuses ``band_mode`` with
the mixed teacher (ROADMAP §3); the banded forward on an f32 model (its
banded teacher pass) is held against JAX's mixed banded forward alone.

Tolerances:
* per op, twin vs Pallas at f32 x: atol = rtol = 5e-2 (the JAX kernel
  tests' bound for bf16-operand kernels, tests/test_torch_fused_block.py),
  and the branch (out - x) no further from an f32 oracle than Pallas's
  (mean, 1.1x + 1e-3): the port follows the XLA numerics (max-subtracted
  softmax, erf GELU), the Pallas kernels clamp logits and use tanh GELU.
* the f32 tiers read their f32 rows unrounded: on rows with a large common
  offset (``twin_check.offset_rows``, phase 3's inputs on the card), the
  twin fed bf16-rounded rows fails ``twin_check``'s bound, so a kernel that
  rounds them fails it too. On the same rows the twin is held against JAX's
  f32 tier within that bound, which the twin fed bf16-rounded rows fails
  against JAX too (readings in the test).
* the banded f32 forward against JAX's (``banded_cls_features`` at
  ``compute_dtype=f32`` with the Pallas kernels): atol = rtol = 5e-2, and
  mean|port - f32| <= 1.1 x mean|JAX - f32| + 1e-3, as the bf16 banded
  forward is held (tests/test_torch_banded_model.py); and closer to the
  f32 forward than the bf16 banded forward on the kernels (mean, strictly).
* the scorers: per frame |port - JAX| <= 0.25 x mean f32 loss (the bf16
  scorer's bound, tests/test_torch_scoring.py: the teacher softmax at
  temperature 0.02 multiplies feature rounding by 50, and the two tiers
  round at different points); mean|port - f32| <= 1.5 x mean|JAX - f32| +
  1e-3; the mixed scorer closer to f32 than the bf16 scorer on the same
  weights (mean, strictly), as JAX's tests/test_mixed_teacher.py holds
  JAX's; ``teacher_dtype=None`` (or equal to the compute dtype) bit for bit
  the scorer without it.
* the workspace mirrors: equal to the layouts the CUDA sources declare.
"""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu.models import banded as jbanded
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import banded_block as jbb
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.data.windows import window_indices
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.models import banded
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video

D, H = 128, 2
TOL = 5e-2
f32, bf16 = torch.float32, torch.bfloat16
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dino_video_summarization_transformer_tpu_torch", "ops", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(seed=0):
    """Block 0 of numpy-seeded params: the JAX pytree (f32) and the port's
    kernel-layout dict (bf16 matrices, f32 vectors), from the same numbers."""
    kw = dict(img_size=32, patch_size=16, embed_dim=D, depth=1, num_heads=H,
              num_frames=4, num_classes=0)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(
        jtsf.TimeSformerConfig(**kw), seed=seed))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    cfg = tsf.TimeSformerConfig(**kw)
    model = tsf.build_timesformer(
        cfg, convert.state_dict_from_jax_params(params, cfg), device="cpu")
    return jp, fb.block_params(model.blocks[0])


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


# ---------------------------------------------------------------------------
# The f32 tiers, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,N", [(3, 16), (30, 4)])
def test_temporal_phase_tm_f32_in_matches_pallas(T, N):
    """Row 1's f32-in tier: JAX ``_fused_temporal_phase_tm_impl(...,
    out_dtype=f32)`` on f32 x."""
    jp, p = _block(seed=T)
    x = np.random.RandomState(N).randn(2, T, N, D).astype(np.float32)
    want = _np(jfb._fused_temporal_phase_tm_impl(
        jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
        jnp.asarray(x), H, out_dtype=jnp.float32))
    before = dict(fb.launches)
    got = fb.temporal_phase_tm(torch.from_numpy(x), p["temporal"], H)
    assert fb.launches == before  # a CPU tensor: the twin, no launch
    assert got.dtype == f32
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    xpm = x.transpose(0, 2, 1, 3).reshape(2 * N, T, D)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(
            jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
            jnp.asarray(xpm), H)).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    _no_further(got - x, want - x, oracle - x)


@pytest.mark.parametrize("T,N", [(3, 16), (30, 4)])
def test_spatial_mlp_f32_grid_and_cls_match_pallas(T, N):
    """Row 2's mixed tier: an f32 CLS row in, an f32 grid out, against JAX
    ``_fused_spatial_mlp_impl(..., out_dtype=f32)`` with the f32 CLS row."""
    jp, p = _block(seed=T + 1)
    r = np.random.RandomState(N + 1)
    x1 = r.randn(2, T, N, D).astype(np.float32)
    cls = r.randn(2, 1, D).astype(np.float32)
    want_g, want_c = jfb._fused_spatial_mlp_impl(
        jp["norm1"], jp["attn"], jp["norm2"], jp["mlp"], jnp.asarray(cls),
        jnp.asarray(x1), H, out_dtype=jnp.float32)
    got_g, got_c = fb.spatial_mlp(torch.from_numpy(x1), torch.from_numpy(cls),
                                  p["spatial"], H)
    assert got_g.dtype == got_c.dtype == f32
    np.testing.assert_allclose(_np(got_g), _np(want_g), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(got_c), _np(want_c), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,N", [(3, 16), (30, 4)])
def test_divided_block_wb_f32_matches_pallas_and_oracle(T, N):
    """The whole block at f32 boundaries (JAX ``fused_divided_block_wb``
    on f32 cls and grid, the mixed tier): both outputs f32, within the
    bound of JAX's, no further from the f32 XLA block."""
    jp, p = _block(seed=T + 2)
    r = np.random.RandomState(N + 2)
    cls = r.randn(2, 1, D).astype(np.float32)
    grid = r.randn(2, T, N, D).astype(np.float32)
    want_c, want_g = jfb.fused_divided_block_wb(jp, jnp.asarray(cls),
                                                jnp.asarray(grid), H)
    got_c, got_g = fb.divided_block_wb(p, torch.from_numpy(cls),
                                       torch.from_numpy(grid), H)
    assert got_c.dtype == got_g.dtype == f32
    flat = grid.transpose(0, 2, 1, 3).reshape(2, N * T, D)
    with jax.default_matmul_precision("highest"):
        oc, og = jtsf.divided_block(jp, jnp.asarray(cls), jnp.asarray(flat),
                                    2, T, 1, N, H)
    og = np.asarray(og).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    for got, want, oracle, x in [(got_c, want_c, np.asarray(oc), cls),
                                 (got_g, want_g, og, grid)]:
        got, want = _np(got), _np(want)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        _no_further(got - x, want - x, oracle - x)


@pytest.mark.parametrize("M", [512, 200])
def test_mlp_phase_f32_matches_pallas(M):
    """Row 3's f32 tier: JAX ``fused_mlp_phase`` on f32 rows (x + fc2 in
    f32, nothing rounded), and ``residual=False`` the branch alone."""
    jp, p = _block(seed=M)
    x = np.random.RandomState(M).randn(M, D).astype(np.float32)
    want = _np(jfb.fused_mlp_phase(jp["norm2"], jp["mlp"], jnp.asarray(x),
                                   residual=True))
    got = fb.mlp_phase(torch.from_numpy(x), p["spatial"])
    assert got.dtype == f32
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.mlp(jp["mlp"], jtsf.layer_norm(
            jp["norm2"], jnp.asarray(x))))
    _no_further(got - x, want - x, oracle)
    branch = fb.mlp_phase(torch.from_numpy(x), p["spatial"], residual=False)
    assert branch.dtype == f32
    np.testing.assert_allclose(_np(branch), got - x, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [64, 50])
def test_spatial_phase_pf_f32_matches_pallas(C):
    """Row 11's f32 tier: JAX ``spatial_phase_pf`` on f32 x and f32
    per-frame CLS rows; the grid f32, the exported qkv bf16 as JAX's."""
    jp, p = _block(seed=C)
    N = 16
    r = np.random.RandomState(C)
    x = r.randn(C, N, D).astype(np.float32)
    cls = r.randn(C, D).astype(np.float32)
    g_j, _, kv_j, kvc_j, qc_j = jbb.spatial_phase_pf(
        jp["norm1"], jp["attn"], jnp.asarray(cls), jnp.asarray(x), H)
    assert g_j.dtype == jnp.float32
    before = dict(bb.launches)
    g_t, qkv_t, qkv_cls_t = bb.spatial_phase_pf(torch.from_numpy(x),
                                                torch.from_numpy(cls),
                                                p["spatial"], H)
    assert bb.launches == before
    assert g_t.dtype == f32 and qkv_t.dtype == qkv_cls_t.dtype == bf16
    for got, want in [(g_t, g_j), (qkv_t[..., D:], kv_j),
                      (qkv_cls_t[:, D:], kvc_j), (qkv_cls_t[:, :D], qc_j)]:
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    lo = np.clip(np.arange(C) - 1, 0, C - 3)
    with jax.default_matmul_precision("highest"):
        _, pat_res = jbanded._banded_spatial(
            jp["norm1"], jp["attn"], jnp.asarray(cls)[:, None], jnp.asarray(x),
            jnp.asarray(lo), 3, H, 32)
    _no_further(_np(g_t) - x, _np(g_j) - x, np.asarray(pat_res))


def test_f32_tiers_refuse_mixed_dtypes():
    """Row 11 takes x and its CLS rows in one dtype; rows 1 and 3 take bf16
    or f32 rows; row 2's CLS row (and so its grid) is bf16 or f32."""
    _, p = _block()
    x = torch.zeros(4, 16, D)
    with pytest.raises(TypeError):
        bb.spatial_phase_pf(x, torch.zeros(4, D, dtype=bf16), p["spatial"], H)
    with pytest.raises(TypeError):
        fb.mlp_phase(x.reshape(64, D).half(), p["spatial"])
    with pytest.raises(TypeError):
        fb.spatial_mlp(x.reshape(1, 4, 16, D), torch.zeros(1, 1, D).half(),
                       p["spatial"], H)


def _rounded(t):
    return t.to(bf16).to(t.dtype)


@pytest.mark.parametrize("op", ["row1_x", "row2_cls", "row3_x", "row11_x", "row11_cls"])
def test_twin_bound_rejects_f32_inputs_rounded_to_bf16(op):
    """On phase 3's inputs (``twin_check.offset_rows``: rows with a large
    common offset and a small spread, which bf16 rounding mostly erases
    before the LN sees them), the twin fed bf16-rounded f32 rows fails the
    card's kernel-vs-twin bound: a kernel that rounds an f32 input (the
    planted faults ``f32_in_read_as_bf16`` and ``cls_rounded_bf16``) cannot
    pass phase 3."""
    _, p = _block(seed=5)
    r = np.random.RandomState(5)

    def rows(*shape):
        return torch.from_numpy(twin_check.offset_rows(r, shape))

    if op == "row1_x":
        x = rows(2, 3, 16, D)
        sound = fb.temporal_phase_tm_plain(x, p["temporal"], H)
        bad = fb.temporal_phase_tm_plain(_rounded(x), p["temporal"], H)
        pairs = [(bad - _rounded(x) + x, sound, x)]
    elif op == "row2_cls":
        x1, cls = rows(2, 3, 16, D), rows(2, 1, D)
        sound = fb.spatial_mlp_plain(x1, cls, p["spatial"], H)
        bad = fb.spatial_mlp_plain(x1, _rounded(cls), p["spatial"], H)
        pairs = [(bad[1], sound[1], None)]
    elif op == "row3_x":
        x = rows(96, D)
        sound = fb.mlp_phase_plain(x, p["spatial"])
        bad = fb.mlp_phase_plain(_rounded(x), p["spatial"])
        pairs = [(bad - _rounded(x) + x, sound, x)]
    else:
        x, cls = rows(8, 16, D), rows(8, D)
        xr, cr = (_rounded(x), cls) if op == "row11_x" else (x, _rounded(cls))
        sound = bb.spatial_phase_pf_plain(x, cls, p["spatial"], H)
        bad = bb.spatial_phase_pf_plain(xr, cr, p["spatial"], H)
        pairs = [(bad[1], sound[1], None), (bad[2], sound[2], None)]
    assert any(twin_check.twin_failures(twin_check.twin_gap(g, w, b))
               for g, w, b in pairs)
    # and the sound twin against itself passes, of course
    assert not twin_check.twin_failures(twin_check.twin_gap(
        pairs[0][1], pairs[0][1], pairs[0][2]))


def _offset_case(op, rounded):
    """One f32 tier on offset rows: (JAX's tier, the port's twin, the base
    its gap is measured from) for the output where rounding ``op``'s input
    shows; with ``rounded`` the twin is fed that input rounded to bf16 (and
    a residual output gets the unrounded input back, so only what the LN
    saw differs)."""
    jp, p = _block(seed=6)
    r = np.random.RandomState(6)

    def rows(*shape):
        return twin_check.offset_rows(r, shape)

    def t(a, base=None):
        a = torch.from_numpy(a)
        return _rounded(a) if base == op and rounded else a

    if op in ("row1_x", "row3_x"):
        x = rows(2, 3, 16, D) if op == "row1_x" else rows(96, D)
        xt = t(x, op)
        if op == "row1_x":
            want = jfb._fused_temporal_phase_tm_impl(
                jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
                jnp.asarray(x), H, out_dtype=jnp.float32)
            got = fb.temporal_phase_tm_plain(xt, p["temporal"], H)
        else:
            want = jfb.fused_mlp_phase(jp["norm2"], jp["mlp"], jnp.asarray(x),
                                       residual=True)
            got = fb.mlp_phase_plain(xt, p["spatial"])
        return _np(want), _np(got - xt) + x, x
    if op in ("row2_x1", "row2_cls"):
        x1, cls = rows(2, 3, 16, D), rows(2, 1, D)
        want_g, want_c = jfb._fused_spatial_mlp_impl(
            jp["norm1"], jp["attn"], jp["norm2"], jp["mlp"], jnp.asarray(cls),
            jnp.asarray(x1), H, out_dtype=jnp.float32)
        x1t = t(x1, "row2_x1")
        got_g, got_c = fb.spatial_mlp_plain(x1t, t(cls, "row2_cls"), p["spatial"], H)
        if op == "row2_x1":
            return _np(want_g), _np(got_g - x1t) + x1, x1
        return _np(want_c), _np(got_c), None
    x, cls = rows(8, 16, D), rows(8, D)
    g_j, _, _, kvc_j, _ = jbb.spatial_phase_pf(jp["norm1"], jp["attn"], jnp.asarray(cls),
                                               jnp.asarray(x), H)
    xt = t(x, "row11_x")
    g_t, _, qkv_cls_t = bb.spatial_phase_pf_plain(xt, t(cls, "row11_cls"), p["spatial"], H)
    if op == "row11_x":
        return _np(g_j), _np(g_t - xt) + x, x
    return _np(kvc_j), _np(qkv_cls_t[:, D:]), None


@pytest.mark.parametrize("op", ["row1_x", "row2_x1", "row2_cls", "row3_x", "row11_x",
                                "row11_cls"])
def test_f32_tiers_match_pallas_on_offset_rows(op):
    """Each f32 tier's twin against JAX's f32 tier (Pallas in interpret
    mode) on phase 3's inputs, rows with a large common offset
    (``twin_check.offset_rows``), within ``twin_check``'s bound (rel_rms
    1e-2, rel_max 2e-2 on the output, or on out - x for a residual output);
    the same twin fed the input rounded to bf16 fails that bound against
    JAX, so this comparison tells the f32 tier from a bf16-input one, where
    the atol = rtol = 5e-2 tests above on unit-variance rows cannot.
    Readings (rel_rms / rel_max), sound then rounded:
    row1_x (out) 1.82e-3 / 2.27e-3, 6.52e-2 / 8.64e-2;
    row2_x1 (grid) 2.03e-3 / 2.32e-3, 1.21e-1 / 1.89e-1;
    row2_cls (CLS rows) 2.13e-3 / 2.50e-3, 1.72e-2 / 1.85e-2;
    row3_x (out) 5.65e-4 / 1.40e-3, 1.22e-1 / 1.92e-1;
    row11_x (grid) 2.16e-3 / 2.92e-3, 8.70e-2 / 1.11e-1;
    row11_cls (the CLS rows' K and V) 2.60e-4 / 2.33e-3, 1.19e-1 / 1.58e-1."""
    def gap(rounded):
        want, got, base = _offset_case(op, rounded)
        return twin_check.twin_gap(torch.from_numpy(np.array(got)),
                                   torch.from_numpy(np.array(want)),
                                   None if base is None else torch.from_numpy(base))
    sound, bad = gap(False), gap(True)
    assert not twin_check.twin_failures(sound), sound
    assert twin_check.twin_failures(bad), bad


# ---------------------------------------------------------------------------
# Workspaces: the mirrors are the layouts the CUDA sources declare
# ---------------------------------------------------------------------------

def test_workspace_mirrors_are_the_sources_layouts():
    """Each wrapper sizes its workspace from the library's ``*_ws`` answer
    on the card and from its mirror here (a card test holds the two
    equal). The mirror is the source's Carve layout: each buffer from a
    256-byte boundary, bf16 for every row the C side stages in bf16, f32
    for row 2's post-spatial carry x2 in every tier. The source's lines
    are restated here, so a layout change that the mirror does not follow
    fails."""
    fsrc = open(os.path.join(CSRC, "fused_block.cu")).read()
    bsrc = open(os.path.join(CSRC, "banded_block.cu")).read()
    csrc = open(os.path.join(CSRC, "dvst_common.cuh")).read()
    assert "off = (off + 255) & ~size_t(255);" in csrc
    for block in [
            # temporal_ws (Dq: the attention width, D but in the partial
            # tier; the wrappers' mirror sizes the full-width tiers)
            ["w.qkv = c.take<bf16>(M * 3 * Dq);", "w.buf1 = c.take<bf16>(M * D);",
             "w.buf2 = c.take<bf16>(M * Dq);"],
            # spatial_mlp_ws
            ["w.y = c.take<bf16>(M * D);", "w.qkv = c.take<bf16>(M * 3 * D);",
             "w.a = c.take<bf16>(M * D);", "w.hid = c.take<bf16>(M * Dh);",
             "w.y_cls = c.take<bf16>((long)B * D);",
             "w.qkv_cls = c.take<bf16>((long)B * 3 * D);",
             "w.a_cls = c.take<bf16>((long)B * T * D);", "w.x2 = c.take<float>(M * D);"],
            # mlp_ws
            ["w.y = c.take<bf16>(M * D);", "w.hid = c.take<bf16>(M * Dh);"]]:
        at = fsrc.index(block[0])
        for line in block:  # in this order
            at = fsrc.index(line, at)
    # the full-width tiers carve temporal_ws at Dq = D, the mirror's layout
    assert "return (long)temporal_ws(nullptr, (long)B * T * N, D, D).bytes;" in fsrc
    at = bsrc.index("SpatialPfWs spatial_pf_ws(")
    for line in ["w.y = c.take<bf16>(M * D);", "w.y_cls = c.take<bf16>((long)C * D);",
                 "w.a = c.take<bf16>(M * D);"]:
        at = bsrc.index(line, at)

    def up(n):
        return -(-n // 256) * 256

    for B, T, N, Dm, Dh in [(8, 30, 196, 768, 3072), (8, 3, 196, 768, 3072),
                            (2, 3, 5, 128, 512), (1, 1, 1, 128, 128)]:
        M = B * T * N
        rows = [M * 3 * Dm * 2, M * Dm * 2, M * Dm * 2]
        assert fb.temporal_phase_tm_ws(B, T, N, Dm) == (
            up(rows[0]) + up(rows[1]) + rows[2])
        parts = [M * Dm * 2, M * 3 * Dm * 2, M * Dm * 2, M * Dh * 2, B * Dm * 2,
                 B * 3 * Dm * 2, B * T * Dm * 2, M * Dm * 4]
        assert fb.spatial_mlp_ws(B, T, N, Dm, Dh) == sum(up(n) for n in parts[:-1]) + parts[-1]
        assert fb.mlp_phase_ws(M, Dm, Dh) == up(M * Dm * 2) + M * Dh * 2
        assert bb.spatial_phase_pf_ws(B * T, N, Dm) == (
            up(M * Dm * 2) + up(B * T * Dm * 2) + M * Dm * 2)
    # row 2's workspace holds its f32 carry: more than the bf16 element
    # count the wrapper once allocated would give (M * (5 D + Dh) + 4 B D +
    # B T D bf16 elements)
    B, T, N, Dm, Dh = 8, 30, 196, 768, 3072
    M = B * T * N
    assert fb.spatial_mlp_ws(B, T, N, Dm, Dh) > 2 * (M * (5 * Dm + Dh) + 4 * B * Dm
                                                     + B * T * Dm)


# ---------------------------------------------------------------------------
# The slice: the mixed scorer against JAX's
# ---------------------------------------------------------------------------

KW = dict(img_size=32, patch_size=16, embed_dim=D, depth=2, num_heads=H,
          num_frames=4, num_classes=0)
GEO = dict(local_size=3, global_size=30, chunk=8)
T_CLIP = 44


@pytest.fixture(scope="module")
def clip():
    """Seed 0's weights: a model whose teacher distribution (temperature
    0.02) is not one-hot on this clip. Where it is (seed 3's), the teacher's
    precision cannot move a loss, and the mixed and bf16 scorers read the
    same losses to the last bit."""
    jcfg, cfg = jtsf.TimeSformerConfig(**KW), tsf.TimeSformerConfig(**KW)
    params = jsyn.make_numpy_params(jcfg, seed=0)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg)
    vid = make_video(seed=2, T=T_CLIP, size=32)
    frames = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "sd": sd,
            "frames": frames, "idx": window_indices(T_CLIP, 3, 30)}


def _port(clip, **kw):
    sc = scoring.FrameScorer(clip["sd"], clip["cfg"], device="cpu", **GEO, **kw)
    return sc, sc.score_video(clip["frames"], *clip["idx"])


def _jax(clip, **kw):
    return jscoring.FrameScorer(clip["params"], clip["jcfg"], **GEO, **kw).score_video(
        clip["frames"], *clip["idx"])


def test_mixed_scorer_matches_jax_and_is_closer_to_f32(clip):
    """The port's mixed scorer (kernel route; twins on CPU tensors) against
    JAX's FrameScorer(compute_dtype=bf16, teacher_dtype=f32,
    use_pallas=True), both held against the f32 scores; and closer to them
    than the port's bf16 scorer."""
    _, want32 = _port(clip)
    jax_mixed = _jax(clip, use_pallas=True, compute_dtype=jnp.bfloat16,
                     teacher_dtype=jnp.float32, precision=None)
    before = (dict(fb.launches), dict(bb.launches))
    sc, mixed = _port(clip, use_kernels=True, compute_dtype=bf16,
                      teacher_dtype=f32, precision=None)
    assert (dict(fb.launches), dict(bb.launches)) == before
    assert sc.model.pos_embed.dtype == bf16 and sc.t_model.pos_embed.dtype == f32
    assert sc.t_model.cfg.use_kernels and sc.teacher_dtype == f32
    _, bf = _port(clip, use_kernels=True, compute_dtype=bf16, precision=None)
    assert np.all(np.isfinite(mixed)) and mixed.shape == (T_CLIP,)
    scale = np.mean(want32)
    e_mixed = np.mean(np.abs(mixed - want32))
    e_jax = np.mean(np.abs(jax_mixed - want32))
    e_bf16 = np.mean(np.abs(bf - want32))
    print(f"mean f32 loss {scale:.4f}; mean |. - f32|: port mixed {e_mixed:.3e}, "
          f"JAX mixed {e_jax:.3e}, port bf16 {e_bf16:.3e}; max |port - JAX| "
          f"{np.max(np.abs(mixed - jax_mixed)):.3e}")
    assert np.max(np.abs(mixed - jax_mixed)) <= 0.25 * scale
    assert e_mixed <= 1.5 * e_jax + 1e-3, (e_mixed, e_jax)
    assert e_mixed < e_bf16, (e_mixed, e_bf16)


@pytest.mark.parametrize("t_real,eff", [(64, 30), (50, 3)])
def test_banded_f32_forward_matches_jax_mixed_forward(monkeypatch, t_real, eff):
    """The banded forward on an f32 model with the kernels (the mixed
    teacher's banded pass: rows 11 and 3's f32 tiers, rows 10 and 12 on
    bf16 operands, the temporal glue in f32; twins on CPU tensors) against
    JAX's ``banded_cls_features(compute_dtype=f32)`` with the Pallas
    kernels, both held against the f32 forward; and closer to it than the
    bf16 banded forward on the kernels (the banded teacher's precision,
    which the scorer's losses cannot show where the teacher softmax is
    one-hot)."""
    import dataclasses

    kw = dict(KW, embed_dim=256, num_heads=4, num_frames=8)
    jcfg, cfg = jtsf.TimeSformerConfig(**kw), tsf.TimeSformerConfig(use_kernels=True, **kw)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=5 + eff))
    fr = np.random.RandomState(eff).randn(64, 32, 32, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jbanded.banded_cls_features(
            jax.tree.map(jnp.asarray, params), jnp.asarray(fr), t_real, jcfg, eff=eff))
    want = np.asarray(jbanded.banded_cls_features(
        jax.tree.map(jnp.asarray, params), jnp.asarray(fr), t_real,
        dataclasses.replace(jcfg, use_fused=True), eff=eff, compute_dtype=jnp.float32))
    model = tsf.build_timesformer(cfg, convert.state_dict_from_jax_params(params, cfg),
                                  device="cpu")
    seen = []
    for name, mod in (("mlp_phase", fb), ("spatial_phase_pf", bb)):
        def spy(*a, _fn=getattr(mod, name), _name=name, **k):
            seen.append((_name, a[0].dtype))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    with torch.inference_mode():
        got = banded.banded_cls_features(model, torch.from_numpy(fr), t_real,
                                         eff).numpy()
    assert set(seen) == {("mlp_phase", f32), ("spatial_phase_pf", f32)}
    got, want, oracle = got[:t_real], want[:t_real], oracle[:t_real]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, oracle)
    m16 = tsf.build_timesformer(cfg, convert.state_dict_from_jax_params(params, cfg),
                                device="cpu", dtype=bf16)
    with torch.inference_mode():
        g16 = banded.banded_cls_features(m16, torch.from_numpy(fr).to(bf16), t_real,
                                         eff).float().numpy()[:t_real]
    e32, e16 = np.abs(got - oracle).mean(), np.abs(g16 - oracle).mean()
    assert e32 < e16, (e32, e16)


def test_band_mode_with_the_mixed_teacher_raises(clip, monkeypatch):
    """(The name predates the banded mixed teacher's port.) ``band_mode``
    with the mixed teacher builds and scores: its banded teacher pass on
    the f32 model, fed f32 views, through the f32 tiers of the banded
    spatial phase and the grid MLP; the students' pass (``"both"``) on the
    bf16 model, fed bf16 views, through their bf16 tiers
    (tests/test_torch_banded_mixed.py holds it against JAX)."""
    frames, idx = clip["frames"][:32], window_indices(32, 3, 30)
    for mode in ("both", "teacher"):
        seen = []
        for name, mod in (("mlp_phase", fb), ("spatial_phase_pf", bb)):
            real = getattr(fb if name == "mlp_phase" else bb, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=real, _n=name, **k: (
                seen.append((_n, a[0].dtype)), _fn(*a, **k))[1])
        sc = scoring.FrameScorer(clip["sd"], clip["cfg"], device="cpu", use_kernels=True,
                                 compute_dtype=bf16, teacher_dtype=f32, band_mode=mode,
                                 precision=None, **GEO)
        got = sc.score_video(frames, *idx)
        monkeypatch.undo()
        assert got.shape == (32,) and np.all(np.isfinite(got))
        want = {("mlp_phase", f32), ("spatial_phase_pf", f32)}
        if mode == "both":
            want |= {("mlp_phase", bf16), ("spatial_phase_pf", bf16)}
        assert set(seen) == want


def test_mixed_teacher_runs_the_f32_tiers(clip, monkeypatch):
    """The mixed scorer's teacher forwards go through the f32 tiers (f32
    rows into row 1, an f32 CLS row and grid for row 2) and its students
    through the bf16 tiers; the teacher's weights are the original f32
    ones, its kernel matrices their bf16 rounding."""
    seen = []
    for name in ("temporal_phase_tm", "spatial_mlp"):
        def spy(*a, _fn=getattr(fb, name), _name=name, **k):
            seen.append((_name, a[0].dtype, a[1].dtype if _name == "spatial_mlp" else None))
            return _fn(*a, **k)
        monkeypatch.setattr(fb, name, spy)
    sc, _ = _port(clip, use_kernels=True, compute_dtype=bf16, teacher_dtype=f32,
                  precision=None)
    assert {("temporal_phase_tm", f32, None), ("temporal_phase_tm", bf16, None),
            ("spatial_mlp", f32, f32), ("spatial_mlp", f32, bf16)} == set(seen)
    w = clip["sd"]["blocks.0.attn.qkv.weight"]
    assert torch.equal(sc.t_model.blocks[0].attn.qkv.weight, torch.from_numpy(np.asarray(w)))
    assert torch.equal(sc.t_model.kernel_params()[0]["spatial"]["qkv_w"],
                       torch.from_numpy(np.asarray(w)).to(bf16))


@pytest.mark.parametrize("kw", [
    dict(use_kernels=True, compute_dtype=bf16, precision=None),
    dict(compute_dtype=f32)], ids=["bf16_kernels", "f32"])
def test_teacher_dtype_none_is_identity(clip, kw):
    """``teacher_dtype=None``, or equal to the compute dtype, is the scorer
    without it bit for bit, with one model for both forwards (JAX
    tests/test_mixed_teacher.py:37)."""
    a, got_a = _port(clip, **kw)
    b, got_b = _port(clip, teacher_dtype=kw["compute_dtype"], **kw)
    np.testing.assert_array_equal(got_a, got_b)
    assert a.t_model is a.model and b.t_model is b.model


def test_unsupported_teacher_dtypes_raise(clip):
    """A bf16 teacher with f32 students is not a tier; f32 students on the
    kernels are (JAX's ``use_pallas=True`` at f32: one f32 model for both
    forwards on the kernel route), so that no longer raises."""
    with pytest.raises(NotImplementedError, match="mixed teacher"):
        scoring.FrameScorer(clip["sd"], clip["cfg"], device="cpu",
                            compute_dtype=f32, teacher_dtype=bf16)
    sc = scoring.FrameScorer(clip["sd"], clip["cfg"], device="cpu",
                             compute_dtype=f32, use_kernels=True)
    assert sc.model_cfg.use_kernels and sc.t_model is sc.model
    assert sc.model.pos_embed.dtype == f32
