"""Row 7's new blocks on the CPU: the tensor-core attention backward at
stride N (``fused_block.temporal_attention_bwd``) and the LayerNorm
backward of rows 7-9 (``fused_block.layer_norm_bwd``), through their plain
twins; row 7 (``temporal_phase_tm_bwd``) as those blocks chained; the
kernel-vs-twin bound (``ops/twin_check.py``) against the faults the
strided tile and the LayerNorm backward could make; the wrappers' input
checks and the shared memory by which the CPU twins refuse what the
kernel refuses.

Tolerances:
* the strided backward's twin against ``jax.vjp`` of the same bf16
  attention contract (``tests/test_torch_backward_tile.py``'s
  ``_jax_attention``: f32 scores, the row max subtracted, probabilities
  rounded to bf16 for PV with the rounding passed straight through) over
  the sequences gathered at stride N: per output max|diff| / max|JAX| <
  2e-2, the JAX package's ``_grad_compare`` bound (the twin also rounds ds
  and the outputs to bf16, which the straight-through VJP does not);
* the LayerNorm backward's twin against ``jax.vjp`` of the JAX package's
  ``layer_norm`` (``models/timesformer.py:207``) in f32: its f32 outputs
  (the tail rows' dx, dscale, dbias) within 1e-5 of each output's max
  (summation order only); its bf16 dx, bf16(dx + res), within one bf16 ulp
  of JAX's dx + res rounded (a rounding flip);
* planted faults: the tile's gradients by twin_check's f32 rules (as the
  card holds them: their elements are sums whose coefficients sum to
  zero), row 7's outputs by the rules the card holds them to (dx within 4
  ulps of dx - dout, the gradients by rms and max).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models.timesformer import layer_norm as jax_layer_norm
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb, twin_check
from test_torch_backward_tile import _jax_attention, _no_rowsum

GRAD_TOL = 2e-2
bf16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=bf16):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _inputs(B, T, N, D, seed):
    r = np.random.RandomState(seed)
    return _t(r.randn(B, T, N, 3 * D)), _t(r.randn(B, T, N, D))


def _sequences(x, h):
    """(B, T, N, W) -> (B*N, h, T, W / h): sequence (b, n) at each head, its
    rows gathered at stride N, as f32 numpy."""
    B, T, N, W = x.shape
    return x.float().numpy().reshape(B, T, N, h, W // h).transpose(0, 2, 3, 1, 4).reshape(
        B * N, h, T, W // h)


def _unsequence(g, B, T, N):
    """(B*N, h, T, hd) -> (B, T, N, h * hd)."""
    _, h, _, hd = g.shape
    return g.reshape(B, N, h, T, hd).transpose(0, 3, 1, 2, 4).reshape(B, T, N, h * hd)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _params(D, seed):
    r = np.random.RandomState(seed)
    return {"ln_w": _t(1 + 0.1 * r.randn(D), torch.float32),
            "ln_b": _t(0.05 * r.randn(D), torch.float32),
            "qkv_w": _t(r.randn(3 * D, D) * 0.1), "qkv_b": _t(r.randn(3 * D) * 0.02, torch.float32),
            "proj_w": _t(r.randn(D, D) * 0.1), "proj_b": _t(r.randn(D) * 0.02, torch.float32),
            "fc_w": _t(r.randn(D, D) * 0.1), "fc_b": _t(r.randn(D) * 0.02, torch.float32)}


# ---------------------------------------------------------------------------
# The twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [4, 16, 36])
@pytest.mark.parametrize("T", [8, 3, 5])
def test_temporal_attention_bwd_twin_matches_jax_vjp(T, N):
    """T = 8 (the train step's: two sequences a strip), 3 and 5, at N = 4,
    16 and 36, two heads of 64 (D = 128)."""
    B, D, h = 2, 128, 2
    qkv, da = _inputs(B, T, N, D, seed=10 * T + N)
    got = fb.temporal_attention_bwd(qkv, da, h).float().numpy()  # CPU: the twin
    q, k, v = (_sequences(qkv[..., i * D:(i + 1) * D], h) for i in range(3))
    _, f = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, (D // h) ** -0.5),
                   *(jnp.asarray(x) for x in (q, k, v)))
    grads = f(jnp.asarray(_sequences(da, h)))
    for i, name in enumerate("qkv"):
        want = _unsequence(np.asarray(grads[i]), B, T, N)
        rel = _rel(got[..., i * D:(i + 1) * D], want)
        assert rel < GRAD_TOL, (name, rel)


@pytest.mark.parametrize("M,P,div,residual,dtype", [
    pytest.param(12, 0, 1, True, bf16, id="12-0-1-True"),
    pytest.param(12, 2, 3, True, bf16, id="12-2-3-True"),
    pytest.param(9, 4, 8, False, bf16, id="9-4-8-False"),
    pytest.param(12, 0, 1, True, torch.float32, id="12-0-1-True-f32"),
    pytest.param(12, 2, 3, True, torch.float32, id="12-2-3-True-f32")])
def test_layer_norm_bwd_twin_matches_jax_vjp(M, P, div, residual, dtype):
    """The grid rows alone (rows 7 and 9: the residual added), with tail rows
    each shared by ``div`` rows (row 8's per-frame CLS rows, div = T), and
    without a residual, at D = 128; bf16 rows, and f32 rows (the trainer's
    mixed tier: x, the tail rows and the residual f32, dx f32 held by the
    test's f32 rule)."""
    D = 128
    r = np.random.RandomState(M + P)
    x, xt = _t(r.randn(M, D) * 2 + 0.3, dtype), (_t(r.randn(P, D), dtype) if P else None)
    dy, w = _t(r.randn(M + P * div, D), torch.float32), _t(1 + 0.2 * r.randn(D), torch.float32)
    res = _t(r.randn(M, D), dtype) if residual else None
    dx, dx_tail, dscale, dbias = fb.layer_norm_bwd(x, dy, w, res, xt, div)  # CPU: the twin
    rows = x if xt is None else torch.cat([x, xt.repeat_interleave(div, 0)])
    jp = {"scale": jnp.asarray(w.numpy()), "bias": jnp.zeros(D, jnp.float32)}
    _, f = jax.vjp(lambda p, a: jax_layer_norm(p, a), jp, jnp.asarray(rows.float().numpy()))
    gp, gx = f(jnp.asarray(dy.numpy()))
    gx = np.asarray(gx)
    for got, want in ((dscale, gp["scale"]), (dbias, gp["bias"])) + (
            ((dx_tail, gx[M:]),) if P else ()):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    want_dx = gx[:M] + (res.float().numpy() if residual else 0.0)
    assert dx.dtype == dtype
    if dtype == bf16:
        assert twin_check.twin_gap(dx, torch.from_numpy(want_dx).to(bf16))["max_ulps"] <= 1
    else:
        assert np.abs(dx.numpy() - want_dx).max() <= 1e-5 * np.abs(want_dx).max()
    assert dx_tail is None if not P else dx_tail.shape == (P * div, D)


def test_row7_twin_is_its_blocks():
    """Row 7's twin equals its blocks' wrappers chained as the kernel chains
    them (on the CPU each wrapper runs its twin), bit for bit: the forward
    recompute through ``temporal_attention``, the dX and dW products through
    ``gemm_dx`` and ``gemm_dw``, the attention backward through
    ``temporal_attention_bwd``, the LayerNorm backward through
    ``layer_norm_bwd`` with dout as its residual."""
    B, T, N, D, h = 2, 8, 5, 128, 2
    M = B * T * N
    p = _params(D, 3)
    r = np.random.RandomState(4)
    x, dout = _t(r.randn(B, T, N, D)), _t(r.randn(B, T, N, D))
    dx, g = fb.temporal_phase_tm_bwd(x, dout, p, h)
    y = fb._ln(x.float(), p["ln_w"], p["ln_b"]).to(bf16)
    qkv = fb.gemm(y.reshape(M, D), p["qkv_w"], p["qkv_b"], "bf16").reshape(B, T, N, 3 * D)
    a = fb.temporal_attention(qkv, h).reshape(M, D)
    proj = fb.gemm(a, p["proj_w"], p["proj_b"], "bf16")
    dfc = dout.reshape(M, D)
    dproj = fb.gemm_dx(dfc, p["fc_w"], "bf16")
    da = fb.gemm_dx(dproj, p["proj_w"], "bf16")
    dqkv = fb.temporal_attention_bwd(qkv, da.reshape(B, T, N, D), h).reshape(M, 3 * D)
    dy = fb.gemm_dx(dqkv, p["qkv_w"], "f32")
    dx_, _, dscale, dbias = fb.layer_norm_bwd(x.reshape(M, D), dy, p["ln_w"], dfc)
    want = {"fc_w": fb.gemm_dw(dfc, proj), "proj_w": fb.gemm_dw(dproj, a),
            "qkv_w": fb.gemm_dw(dqkv, y.reshape(M, D)), "fc_b": dfc.float().sum(0),
            "proj_b": dproj.float().sum(0), "qkv_b": dqkv.float().sum(0),
            "ln_w": dscale, "ln_b": dbias}
    assert torch.equal(dx, dx_.reshape(B, T, N, D))
    assert all(torch.equal(g[k], want[k]) for k in fb.TEMPORAL_KEYS)


# ---------------------------------------------------------------------------
# Faults of the strided tile and the LayerNorm backward, simulated inside the
# twins: the tile's twin and row 7's run the attention backward through
# fb._attention_bwd over (B, N, H, T, hd) sequences, the LayerNorm backward
# through fb._ln_bwd.
# ---------------------------------------------------------------------------

_sound_bwd = fb._attention_bwd
_sound_ln_bwd = fb._ln_bwd


def _strip_unmasked(q, k, v, da, scale=None):
    """Each strip of 16 // T packed sequences (consecutive sequences b*N + n
    of one head, as the tile packs them from the first of its block) run as
    one sequence: every row sees the strip's keys, and each key gathers the
    strip's queries, not its own sequence's."""
    B, N, Hh, T, hd = q.shape
    P = 16 // T

    def flat(t):
        return t.permute(2, 0, 1, 3, 4).reshape(Hh, B * N, T, hd)

    outs = []
    for parts in zip(*(flat(t).split(P, dim=1) for t in (q, k, v, da))):
        n = parts[0].shape[1]
        g = _sound_bwd(*(t.reshape(Hh, 1, n * T, hd) for t in parts), scale)
        outs.append(torch.stack(g).reshape(3, Hh, n, T, hd))
    g = torch.cat(outs, 2).reshape(3, Hh, B, N, T, hd).permute(0, 2, 3, 1, 4, 5)
    return tuple(g.unbind(0))


def _stride_one(t):
    """(B, N, H, T, hd) at stride N -> the same rows read at stride 1:
    sequence n takes rows n*T .. n*T + T - 1 of its clip."""
    B, N, Hh, T, hd = t.shape
    return (t.permute(0, 3, 1, 2, 4).reshape(B, T * N, Hh, hd)
            .reshape(B, N, T, Hh, hd).permute(0, 1, 3, 2, 4))


def _stride_one_back(t):
    """The inverse of ``_stride_one``: gradients written at stride 1 back in
    the stride-N layout."""
    B, N, Hh, T, hd = t.shape
    return (t.permute(0, 1, 3, 2, 4).reshape(B, N * T, Hh, hd)
            .reshape(B, T, N, Hh, hd).permute(0, 2, 3, 1, 4))


def _read_stride_one(q, k, v, da, scale=None):
    g = _sound_bwd(*(_stride_one(t) for t in (q, k, v, da)), scale)
    return tuple(_stride_one_back(t) for t in g)


def _ln_mean_term_dropped(xf, dy, w):
    """dx = rstd * (dxh - mean(dxh)): the mean(dxh * xhat) term dropped."""
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + fb.LN_EPS)
    dx, dscale, dbias = _sound_ln_bwd(xf, dy, w)
    dxh = dy * w
    return rstd * (dxh - dxh.mean(dim=-1, keepdim=True)), dscale, dbias


TILE_FAULTS = {"strip_unmasked": _strip_unmasked, "stride_one": _read_stride_one,
               "no_rowsum": _no_rowsum}


def _tile(T):
    """The tile's twin over B = 1 clip of N = 6 positions (6 sequences: three
    strips of two at T = 8, two of five at T = 3), D = 128, two heads."""
    return fb.temporal_attention_bwd(*_inputs(1, T, 6, 128, seed=T), 2)


def _tile_failures(got, want, parts):
    D = got.shape[-1] // 3
    bad = []
    for i in ("qkv".index(c) for c in parts):
        gap = twin_check.twin_gap(got[..., i * D:(i + 1) * D].float(),
                                  want[..., i * D:(i + 1) * D].float())
        bad.append(bool(twin_check.twin_failures(gap)))
    return bad


@pytest.mark.parametrize("fault,hit", [("strip_unmasked", "qkv"), ("stride_one", "qkv"),
                                       ("no_rowsum", "qk")])
@pytest.mark.parametrize("T", [8, 3])
def test_twin_bound_rejects_strided_tile_faults(monkeypatch, fault, hit, T):
    """Each fault of the strided tile's design, planted in its twin, breaks
    the bound the card holds the tile to, on every output it reaches."""
    want = _tile(T)
    monkeypatch.setattr(fb, "_attention_bwd", TILE_FAULTS[fault])
    got = _tile(T)
    assert all(_tile_failures(got, want, hit)), hit


def _row7():
    """Row 7's twin at B = 2, T = 8, N = 3 (3 sequences a clip), D = 128, two
    heads: (dx, grads), and the base dx is held against (dout)."""
    r = np.random.RandomState(6)
    x, dout = _t(r.randn(2, 8, 3, 128)), _t(r.randn(2, 8, 3, 128))
    return fb.temporal_phase_tm_bwd(x, dout, _params(128, 7), 2), dout


def _row7_failures(got, want, dout, keys):
    bad = []
    for k in keys:
        gap = (twin_check.twin_gap(got[0], want[0], dout) if k == "x"
               else twin_check.twin_gap(got[1][k], want[1][k]))
        bad.append(bool(twin_check.twin_failures(gap)))
    return bad


@pytest.mark.parametrize("fault,target,hit", [
    ("strip_unmasked", "_attention_bwd", ["qkv_w", "qkv_b", "x"]),
    ("stride_one", "_attention_bwd", ["qkv_w", "qkv_b", "x"]),
    ("no_rowsum", "_attention_bwd", ["qkv_w", "x"]),
    ("ln_mean_term_dropped", "_ln_bwd", ["x"])])
def test_twin_bound_rejects_faults_in_row7(monkeypatch, fault, target, hit):
    """The same faults, and the LayerNorm backward's mean(dxh * xhat) term
    dropped, reach row 7's own outputs, held by the rules the card holds them
    to."""
    want, dout = _row7()
    faults = dict(TILE_FAULTS, ln_mean_term_dropped=_ln_mean_term_dropped)
    monkeypatch.setattr(fb, target, faults[fault])
    got, _ = _row7()
    assert all(_row7_failures(got, want, dout, hit)), hit


def test_sound_simulations_reproduce_the_twins(monkeypatch):
    """The fault simulations' sound parts are the twins: the strip-by-strip
    run where every strip holds one sequence (T = 16) and the stride-1
    layout change undone reproduce the tile's twin bit for bit."""
    qkv, da = _inputs(1, 16, 6, 128, seed=1)
    want = fb.temporal_attention_bwd(qkv, da, 2)
    monkeypatch.setattr(fb, "_attention_bwd", _strip_unmasked)
    assert torch.equal(fb.temporal_attention_bwd(qkv, da, 2), want)
    t = torch.arange(2 * 4 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 4, 3, 8, 5)
    assert torch.equal(_stride_one_back(_stride_one(t)), t)


# ---------------------------------------------------------------------------
# The wrappers' checks and the tile's shared memory
# ---------------------------------------------------------------------------

def test_temporal_attention_bwd_wrapper_checks_inputs():
    qkv, da = _inputs(2, 8, 3, 128, seed=0)
    before = dict(fb.launches)
    with pytest.raises(ValueError):  # (B*T*N, 3D) rows: the wrapper takes (B, T, N, 3D)
        fb.temporal_attention_bwd(qkv.reshape(48, 384), da, 2)
    with pytest.raises(ValueError):  # da rows of another width
        fb.temporal_attention_bwd(qkv, da[..., :64].contiguous(), 2)
    with pytest.raises(ValueError):  # da of another clip count
        fb.temporal_attention_bwd(qkv, da[:1].contiguous(), 2)
    with pytest.raises(TypeError):
        fb.temporal_attention_bwd(qkv, da.float(), 2)
    with pytest.raises(ValueError):  # head dim 128 / 3
        fb.temporal_attention_bwd(qkv, da, 3)
    with pytest.raises(ValueError):
        fb.temporal_attention_bwd(qkv.transpose(1, 2), da, 2)
    dq = fb.temporal_attention_bwd(qkv, da, 2, scale=0.5)
    assert dq.shape == (2, 8, 3, 384) and dq.dtype == bf16
    assert torch.equal(dq, fb.temporal_attention_bwd_plain(qkv, da, 2, 0.5))
    assert fb.launches == before  # the twin is no launch


def test_layer_norm_bwd_wrapper_checks_inputs():
    r = np.random.RandomState(0)
    x, xt = _t(r.randn(8, 128)), _t(r.randn(2, 128))
    dy, w = _t(r.randn(8 + 2 * 3, 128), torch.float32), torch.ones(128)
    before = dict(fb.launches)
    with pytest.raises(ValueError):  # D = 96
        fb.layer_norm_bwd(x[:, :96].contiguous(), dy[:8, :96].contiguous(), w[:96])
    with pytest.raises(ValueError):  # dy has the tail rows, x_tail is missing
        fb.layer_norm_bwd(x, dy, w)
    with pytest.raises(ValueError):  # two tail rows a clip, not three
        fb.layer_norm_bwd(x, dy, w, None, xt, 2)
    with pytest.raises(ValueError):
        fb.layer_norm_bwd(x, dy, w, None, xt, 0)
    with pytest.raises(TypeError):  # dy is f32
        fb.layer_norm_bwd(x, dy.to(bf16), w, None, xt, 3)
    with pytest.raises(TypeError):  # the residual is bf16
        fb.layer_norm_bwd(x, dy, w, x.float(), xt, 3)
    dx, dx_tail, dscale, dbias = fb.layer_norm_bwd(x, dy, w, x, xt, 3)
    assert dx.shape == (8, 128) and dx.dtype == bf16 and dx_tail.shape == (6, 128)
    assert dscale.shape == dbias.shape == (128,)
    assert fb.launches == before


@pytest.mark.parametrize("S,L,hd,need", [
    (3136, 8, 64, 16 + 8 * 14 * 8 * 64 + 192 * 7),   # the global crops: 58704 B
    (2304, 8, 64, 16 + 8 * 14 * 8 * 64 + 192 * 7),   # the local crops
    (13, 8, 64, 16 + 8 * 13 * 8 * 64 + 192 * 7),     # fewer sequences than a group
    (100, 3, 64, 16 + 8 * 35 * 3 * 64 + 192 * 7),    # five sequences a strip
    (5, 30, 64, 16 + 8 * 3 * 30 * 64 + 192 * 6),     # two strips a sequence
    (1, 197, 128, 16 + 8 * 197 * 128 + 192 * 13)])   # 204 KB: one sequence
def test_temporal_attention_bwd_shared_memory(S, L, hd, need):
    """The mirror of the library's dvst_temporal_attn_bwd_smem (a card test
    holds them equal): 16 zero bytes, the group's Q, K, V and dA, three
    floats per row of its strips."""
    assert fb.temporal_attn_bwd_smem(S, L, hd) == need
    assert 2 * fb.temporal_attn_bwd_smem(3136, 8, 64) <= fb.SMEM_LIMIT


def test_row7_refuses_what_shared_memory_cannot_hold():
    """A 300-row sequence at hd 128 needs 304 KB: the tile's wrapper and row 7
    refuse it on the CPU as on the card; 197 rows at hd 128 (which the first
    design's 185 KB L x L backward refused) and every train-step length
    pass."""
    assert fb.temporal_attn_bwd_smem(1, 300, 128) > fb.SMEM_LIMIT
    for L in (3, 8, 30, 197):
        for hd in (16, 64, 128):
            fb.check_temporal_attn_bwd_smem(3136, L, hd)
    p = _params(128, 0)
    x = torch.zeros(1, 300, 1, 128, dtype=bf16)
    for call in (lambda: fb.temporal_attention_bwd(x.repeat(1, 1, 1, 3), x, 1),
                 lambda: fb.temporal_phase_tm_bwd(x, x, p, 1)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
