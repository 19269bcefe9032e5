"""Rows 8 and 9's new blocks on the CPU: the tensor-core attention
backward over [CLS, grid] sequences (``fused_block.spatial_attention_bwd``),
the dX and dW GEMMs (``gemm_dx``, ``gemm_dw``) and row 9's fc1 recompute
with its two outputs (``gemm_gelu_grad``), through their plain twins; the
kernel-vs-twin bound (``ops/twin_check.py``) against the faults the tile
and the split dW could make; the wrappers' input checks and the shared
memory by which the CPU twins refuse what the kernel refuses.

Tolerances:
* the attention-backward twin against ``jax.vjp`` of the same bf16
  attention contract (f32 scores, the row max subtracted, probabilities
  rounded to bf16 for PV with the rounding passed straight through): per
  output max|diff| / max|JAX| < 2e-2, the JAX package's ``_grad_compare``
  bound; the twin also rounds ds and the outputs to bf16, which the
  straight-through VJP does not;
* the GEMM twins against XLA's bf16 x bf16 -> f32 dot: f32 outputs within
  1e-5 of the output's max (summation order only), bf16 outputs within one
  bf16 ulp of XLA's product rounded (a rounding flip), the ulp taken at
  the output's rms below it (``twin_check``'s rule: GELU's tail, where
  erf's f32 cancellation differs between the two libraries, sits far
  below it);
* planted faults: the tile's gradients by twin_check's f32 rules (as the
  card holds them: their elements are sums whose coefficients sum to
  zero), row 8's and row 9's outputs by the rules the card holds them to.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb, twin_check

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


def _spatial_inputs(S, P, N, D, seed, q_scale=1.0):
    r = np.random.RandomState(seed)
    qkv, pre = r.randn(S, N, 3 * D), r.randn(P, 3 * D)
    qkv[..., :D] *= q_scale
    pre[:, :D] *= q_scale
    return _t(qkv), _t(pre), _t(r.randn(S, N, D)), _t(r.randn(S, D))


def _sequences(qkv, pre, da, dap, h):
    """Per (sequence, head): q, k, v, da (S, h, L, hd) as f32 numpy, the
    prefix row first."""
    S, N, D3 = qkv.shape
    D = D3 // 3
    pre_s = pre.repeat_interleave(S // pre.shape[0], dim=0)
    seq = torch.cat([pre_s[:, None], qkv], 1).float().numpy()
    dseq = torch.cat([dap[:, None], da], 1).float().numpy()

    def heads(x):
        return x.reshape(S, N + 1, h, D // h).transpose(0, 2, 1, 3)

    return [heads(seq[..., i * D:(i + 1) * D]) for i in range(3)] + [heads(dseq)]


def _unsequence(g):
    """(S, h, L, hd) -> (S, L, h * hd)."""
    S, h, L, hd = g.shape
    return g.transpose(0, 2, 1, 3).reshape(S, L, h * hd)


def _jax_attention(q, k, v, scale):
    s = jnp.einsum("...id,...jd->...ij", q, k) * scale
    e = jnp.exp(s - jax.lax.stop_gradient(s.max(-1, keepdims=True)))
    p = e / e.sum(-1, keepdims=True)
    pb = p + jax.lax.stop_gradient(p.astype(jnp.bfloat16).astype(jnp.float32) - p)
    return jnp.einsum("...ij,...jd->...id", pb, v)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# The twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,P,N", [(4, 2, 16), (3, 3, 36), (2, 1, 4)])
def test_spatial_attention_bwd_twin_matches_jax_vjp(S, P, N):
    """L = 17 (one row past a strip), 37 (the local crops) and 5 (less than
    a strip), two heads of 64 at D = 128."""
    D, h = 128, 2
    qkv, pre, da, dap = _spatial_inputs(S, P, N, D, seed=S + N)
    got, got_pre = fb.spatial_attention_bwd(qkv, pre, da, dap, h)  # CPU: the twin
    q, k, v, dseq = _sequences(qkv, pre, da, dap, h)
    _, f = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, (D // h) ** -0.5),
                   *(jnp.asarray(x) for x in (q, k, v)))
    want = np.concatenate([_unsequence(np.asarray(g)) for g in f(jnp.asarray(dseq))], -1)
    full = torch.cat([got_pre[:, None], got], 1).float().numpy()
    for i, name in enumerate("qkv"):
        rel = _rel(full[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])
        assert rel < GRAD_TOL, (name, rel)


@pytest.mark.parametrize("epi", sorted(fb.GEMM_DX_EPILOGUES))
@pytest.mark.parametrize("M", [16, 100, 256])
def test_gemm_dx_twin_matches_xla_dot(epi, M):
    K, N = 384, 128  # dy (M, 3D) . Wqkv (3D, D) at D = 128
    r = np.random.RandomState(M)
    dy, w = _t(r.randn(M, K)), _t(r.randn(K, N) * K ** -0.5)
    aux = _t(r.rand(M, N) * 1.2 - 0.1, torch.float32) if epi == "mul_f32_bf16" else None
    got = fb.gemm_dx(dy, w, epi, aux)
    assert got.dtype == fb.GEMM_DX_EPILOGUES[epi][2] and got.shape == (M, N)
    ref = np.asarray(jnp.dot(jnp.asarray(dy.float().numpy(), jnp.bfloat16),
                             jnp.asarray(w.float().numpy(), jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    if aux is not None:
        ref = ref * aux.numpy()
    if got.dtype == torch.float32:
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        want = torch.from_numpy(np.array(ref)).to(bf16)
        assert twin_check.twin_gap(got, want)["max_ulps"] <= 1


@pytest.mark.parametrize("R,n_out,k_in", [(16, 128, 512), (100, 384, 128), (256, 512, 128)])
def test_gemm_dw_twin_matches_xla_dot(R, n_out, k_in):
    r = np.random.RandomState(R + n_out)
    dy, x = _t(r.randn(R, n_out)), _t(r.randn(R, k_in))
    got = fb.gemm_dw(dy, x)
    assert got.dtype == torch.float32 and got.shape == (n_out, k_in)
    ref = np.asarray(jnp.dot(jnp.asarray(dy.float().numpy(), jnp.bfloat16).T,
                             jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("M", [16, 100, 256])
def test_gemm_gelu_grad_twin_matches_jax(M):
    """fc1 at D = 128, MLP 512: bf16 exact GELU and its f32 derivative, both
    from the f32 pre-activation."""
    K, N = 128, 512
    r = np.random.RandomState(M + 1)
    a, w, b = _t(r.randn(M, K)), _t(r.randn(N, K) * K ** -0.5), _t(r.randn(N), torch.float32)
    hg, gp = fb.gemm_gelu_grad(a, w, b)
    h = jnp.dot(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                jnp.asarray(w.float().numpy(), jnp.bfloat16).T,
                preferred_element_type=jnp.float32) + jnp.asarray(b.numpy())
    ref_g = np.asarray(jax.vmap(jax.grad(lambda t: jax.nn.gelu(t, approximate=False)))(
        h.reshape(-1))).reshape(M, N)
    assert np.abs(gp.numpy() - ref_g).max() <= 1e-5 * np.abs(ref_g).max()
    want = torch.from_numpy(np.array(jax.nn.gelu(h, approximate=False))).to(bf16)
    assert twin_check.twin_gap(hg, want)["max_ulps"] <= 1


def test_mlp_bwd_twin_is_its_blocks():
    """Row 9's twin is its blocks' twins chained: dh1 is gemm_dx's
    mul_f32_bf16 of do . W2 and gemm_gelu_grad's derivative, dW2 is
    gemm_dw of do and the bf16 GELU, bit for bit."""
    D, Dh, M = 128, 512, 40
    r = np.random.RandomState(3)
    p = {"ln2_w": _t(1 + 0.1 * r.randn(D), torch.float32),
         "ln2_b": _t(0.1 * r.randn(D), torch.float32),
         "fc1_w": _t(r.randn(Dh, D) * 0.1), "fc1_b": _t(r.randn(Dh) * 0.02, torch.float32),
         "fc2_w": _t(r.randn(D, Dh) * 0.05), "fc2_b": _t(r.randn(D) * 0.02, torch.float32)}
    x, do = _t(r.randn(M, D)), _t(r.randn(M, D))
    _, g = fb.mlp_phase_bwd_plain(x, do, p)
    y = fb._ln(x.float(), p["ln2_w"], p["ln2_b"]).to(bf16)
    hg, gp = fb.gemm_gelu_grad_plain(y, p["fc1_w"], p["fc1_b"])
    dh1 = fb.gemm_dx_plain(do, p["fc2_w"], "mul_f32_bf16", gp)
    assert torch.equal(g["fc2_w"], fb.gemm_dw_plain(do, hg))
    assert torch.equal(g["fc1_w"], fb.gemm_dw_plain(dh1, y))
    assert torch.equal(g["fc1_b"], dh1.float().sum(0))


# ---------------------------------------------------------------------------
# Faults of the tile and the split dW, simulated inside the twins: the tile's
# twin and row 8's run the attention backward through fb._attention_bwd over
# (..., H, L, hd) sequences with the prefix row first, every dW through
# fb._dw.
# ---------------------------------------------------------------------------

_sound_bwd = fb._attention_bwd
_sound_dw = fb._dw


def _no_rowsum(q, k, v, da, scale=None):
    """Delta omitted: ds = pn * dp * scale."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    pf = fb._attention_probs(q, k, scale).float()
    daf = da.float()
    dv = torch.matmul(pf.transpose(-2, -1), daf).to(bf16)
    ds = (pf * torch.matmul(daf, v.float().transpose(-2, -1)) * scale).to(bf16).float()
    return (torch.matmul(ds, k.float()).to(bf16),
            torch.matmul(ds.transpose(-2, -1), q.float()).to(bf16), dv)


def _cls_key_dropped(q, k, v, da, scale=None):
    """The key strips start past the prefix: its dk and dv stay zero."""
    dq, dk, dv = _sound_bwd(q, k, v, da, scale)
    dk, dv = dk.clone(), dv.clone()
    dk[..., 0, :] = 0
    dv[..., 0, :] = 0
    return dq, dk, dv


def _dk_first_strip(q, k, v, da, scale=None):
    """dk summed over the first 16 query rows only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dq, _, dv = _sound_bwd(q, k, v, da, scale)
    pf = fb._attention_probs(q, k, scale).float()
    dp = torch.matmul(da.float(), v.float().transpose(-2, -1))
    ds = (pf * (dp - (dp * pf).sum(-1, keepdim=True)) * scale).to(bf16).float()
    dk = torch.matmul(ds[..., :16, :].transpose(-2, -1), q.float()[..., :16, :]).to(bf16)
    return dq, dk, dv


def _split_left_out(dy, x):
    """The last of four row splits' partial left out of the sum."""
    keep = dy.shape[0] - dy.shape[0] // 4
    return _sound_dw(dy[:keep], x[:keep])


BWD_FAULTS = {"no_rowsum": _no_rowsum, "cls_key_dropped": _cls_key_dropped,
              "dk_first_strip": _dk_first_strip}


def _tile_outputs(N):
    """The tile's twin over 3 sequences of L = N + 1 rows (one prefix each),
    D = 128, two heads: (dqkv, dqkv_prefix)."""
    return fb.spatial_attention_bwd(*_spatial_inputs(3, 3, N, 128, seed=N), 2)


def _tile_failures(got, want, parts):
    """twin_check's f32 rules on the named parts of the tile's outputs."""
    D = got[0].shape[-1] // 3
    bad = []
    for part in parts:
        which, i = part.split("_")
        g, w = (got[0], want[0]) if which == "grid" else (got[1], want[1])
        i = "qkv".index(i)
        gap = twin_check.twin_gap(g[..., i * D:(i + 1) * D].float(),
                                  w[..., i * D:(i + 1) * D].float())
        bad.append(bool(twin_check.twin_failures(gap)))
    return bad


@pytest.mark.parametrize("fault,hit", [
    ("no_rowsum", ["grid_q", "grid_k", "prefix_q", "prefix_k"]),
    ("cls_key_dropped", ["prefix_k", "prefix_v"]),
    ("dk_first_strip", ["grid_k", "prefix_k"])])
@pytest.mark.parametrize("N", [16, 36])
def test_twin_bound_rejects_tile_faults(monkeypatch, fault, hit, N):
    """Each fault of the tile's design, planted in its twin, breaks the
    bound the card holds the tile to, on every output it reaches, at L = 17
    (one query row past the first strip) and 37."""
    want = _tile_outputs(N)
    monkeypatch.setattr(fb, "_attention_bwd", BWD_FAULTS[fault])
    got = _tile_outputs(N)
    assert all(_tile_failures(got, want, hit)), hit


def _row8(seed=5, N=16):
    """Row 8's twin at B=2, T=3, N, D=128, 2 heads: (dx, dcls, grads), and
    the base dx is held against (dgo)."""
    D = 128
    r = np.random.RandomState(seed)
    p = {"ln1_w": _t(1 + 0.1 * r.randn(D), torch.float32),
         "ln1_b": _t(0.05 * r.randn(D), torch.float32),
         "qkv_w": _t(r.randn(3 * D, D) * 0.1), "qkv_b": _t(r.randn(3 * D) * 0.02, torch.float32),
         "proj_w": _t(r.randn(D, D) * 0.1), "proj_b": _t(r.randn(D) * 0.02, torch.float32)}
    x, cls = _t(r.randn(2, 3, N, D)), _t(r.randn(2, 1, D))
    dgo, dco = _t(r.randn(2, 3, N, D)), _t(r.randn(2, 3, D))
    return fb.spatial_phase_bwd(x, cls, dgo, dco, p, 2), dgo


def _row8_failures(got, want, dgo, keys):
    bad = []
    for k in keys:
        if k == "x":
            gap = twin_check.twin_gap(got[0], want[0], dgo)
        elif k == "cls":
            gap = twin_check.twin_gap(got[1], want[1])
        else:
            gap = twin_check.twin_gap(got[2][k], want[2][k])
        bad.append(bool(twin_check.twin_failures(gap)))
    return bad


@pytest.mark.parametrize("fault,hit", [
    ("no_rowsum", ["qkv_w", "ln1_w", "x", "cls"]),
    ("cls_key_dropped", ["qkv_w", "cls"]),
    ("dk_first_strip", ["qkv_w", "x"])])
def test_twin_bound_rejects_tile_faults_in_row8(monkeypatch, fault, hit):
    """The same faults reach row 8's own outputs, held by the rules the card
    holds them to (dx within 4 ulps of dx - dgo, the gradients by rms and
    max)."""
    want, dgo = _row8()
    monkeypatch.setattr(fb, "_attention_bwd", BWD_FAULTS[fault])
    got, _ = _row8()
    assert all(_row8_failures(got, want, dgo, hit)), hit


def test_twin_bound_rejects_a_dw_split_left_out(monkeypatch):
    """One split's partial left out of a weight gradient breaks the bound,
    at the block and in rows 8 and 9."""
    r = np.random.RandomState(9)
    dy, x = _t(r.randn(256, 384)), _t(r.randn(256, 128))
    want = fb.gemm_dw(dy, x)
    want8, dgo = _row8()
    D, Dh, M = 128, 512, 64
    p9 = {"ln2_w": _t(1 + 0.1 * r.randn(D), torch.float32),
          "ln2_b": _t(0.1 * r.randn(D), torch.float32),
          "fc1_w": _t(r.randn(Dh, D) * 0.1), "fc1_b": _t(r.randn(Dh) * 0.02, torch.float32),
          "fc2_w": _t(r.randn(D, Dh) * 0.05), "fc2_b": _t(r.randn(D) * 0.02, torch.float32)}
    x9, do9 = _t(r.randn(M, D)), _t(r.randn(M, D))
    want9 = fb.mlp_phase_bwd(x9, do9, p9)
    monkeypatch.setattr(fb, "_dw", _split_left_out)
    assert twin_check.twin_failures(twin_check.twin_gap(fb.gemm_dw(dy, x), want))
    got8, _ = _row8()
    assert all(_row8_failures(got8, want8, dgo, ["proj_w", "qkv_w"]))
    got9 = fb.mlp_phase_bwd(x9, do9, p9)
    for k in ("fc1_w", "fc2_w"):
        assert twin_check.twin_failures(twin_check.twin_gap(got9[1][k], want9[1][k])), k


@pytest.mark.parametrize("N", [4, 16, 36])
def test_sound_simulation_reproduces_the_twins(monkeypatch, N):
    """The fault simulations' sound parts are the twin: with no fault
    planted the tile's and row 8's outputs are unchanged bit for bit."""
    want = _tile_outputs(N)
    want8, _ = _row8(N=N)
    monkeypatch.setattr(fb, "_attention_bwd", lambda *a: _sound_bwd(*a))
    monkeypatch.setattr(fb, "_dw", lambda dy, x: _sound_dw(dy, x))
    got = _tile_outputs(N)
    got8, _ = _row8(N=N)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got8[0], want8[0]) and torch.equal(got8[1], want8[1])
    assert all(torch.equal(got8[2][k], want8[2][k]) for k in want8[2])


# ---------------------------------------------------------------------------
# The wrappers' checks and the tile's shared memory
# ---------------------------------------------------------------------------

def test_spatial_attention_bwd_wrapper_checks_inputs():
    qkv, pre, da, dap = _spatial_inputs(4, 2, 16, 128, seed=0)
    before = dict(fb.launches)
    with pytest.raises(ValueError):  # 4 sequences, 3 prefixes
        fb.spatial_attention_bwd(qkv, pre[:1].expand(3, -1).contiguous(), da, dap, 2)
    with pytest.raises(ValueError):  # da rows of another width
        fb.spatial_attention_bwd(qkv, pre, da[..., :64].contiguous(), dap, 2)
    with pytest.raises(ValueError):  # one da_prefix row per sequence
        fb.spatial_attention_bwd(qkv, pre, da, dap[:2].contiguous(), 2)
    with pytest.raises(TypeError):
        fb.spatial_attention_bwd(qkv, pre, da.float(), dap, 2)
    with pytest.raises(ValueError):  # head dim 128 / 3
        fb.spatial_attention_bwd(qkv, pre, da, dap, 3)
    with pytest.raises(ValueError):  # (S*N, 3D) rows: the wrapper takes (S, N, 3D)
        fb.spatial_attention_bwd(qkv.reshape(64, 384), pre, da, dap, 2)
    dq, dq_pre = fb.spatial_attention_bwd(qkv, pre, da, dap, 2, scale=0.5)
    assert dq.shape == (4, 16, 384) and dq_pre.shape == (4, 384)
    assert dq.dtype == bf16 and dq_pre.dtype == bf16
    assert torch.equal(dq, fb.spatial_attention_bwd_plain(qkv, pre, da, dap, 2, 0.5)[0])
    assert fb.launches == before  # the twin is no launch


def test_gemm_blocks_check_inputs():
    r = np.random.RandomState(0)
    dy, w = _t(r.randn(64, 256)), _t(r.randn(256, 128))
    before = dict(fb.launches)
    with pytest.raises(ValueError):  # N = 96
        fb.gemm_dx(dy, w[:, :96].contiguous(), "bf16")
    with pytest.raises(ValueError):  # K = 200
        fb.gemm_dx(dy[:, :200].contiguous(), w[:200].contiguous(), "bf16")
    with pytest.raises(ValueError):
        fb.gemm_dx(dy, w, "gelu_bf16")
    with pytest.raises(ValueError):  # aux without its epilogue
        fb.gemm_dx(dy, w, "f32", torch.zeros(64, 128))
    with pytest.raises(TypeError):  # mul_f32_bf16's aux is f32
        fb.gemm_dx(dy, w, "mul_f32_bf16", torch.zeros(64, 128, dtype=bf16))
    with pytest.raises(ValueError):  # rows differ
        fb.gemm_dw(dy, _t(r.randn(63, 128)))
    with pytest.raises(ValueError):  # n_out = 200
        fb.gemm_dw(dy[:, :200].contiguous(), _t(r.randn(64, 128)))
    with pytest.raises(TypeError):
        fb.gemm_dw(dy.float(), _t(r.randn(64, 128)))
    with pytest.raises(ValueError):  # bias of the wrong width
        fb.gemm_gelu_grad(dy[:, :128].contiguous(), w.t().contiguous(),
                          torch.zeros(128, dtype=torch.float32))
    assert fb.launches == before


@pytest.mark.parametrize("L,hd,need", [
    (197, 64, 16 + 4 * 197 * 64 * 2 + 3 * 208 * 4),   # the global crops: 103376 B, two blocks an SM
    (37, 64, 16 + 4 * 37 * 64 * 2 + 3 * 48 * 4),      # the local crops
    (17, 64, 16 + 4 * 17 * 64 * 2 + 3 * 32 * 4),      # one row past a strip
    (5, 128, 16 + 4 * 5 * 128 * 2 + 3 * 16 * 4),      # less than a strip
    (197, 128, 16 + 4 * 197 * 128 * 2 + 3 * 208 * 4)])  # 204 KB: one block an SM
def test_spatial_attention_bwd_shared_memory(L, hd, need):
    """The mirror of the library's dvst_spatial_attn_bwd_smem (a card test
    holds them equal): 16 zero bytes, Q, K, V and dA, three floats per row
    padded to 16 rows."""
    assert fb.spatial_attn_bwd_smem(L, hd) == need
    assert 2 * fb.spatial_attn_bwd_smem(197, 64) <= fb.SMEM_LIMIT


def test_row8_refuses_what_shared_memory_cannot_hold():
    """301 rows at hd 128 need 309 KB: the tile's wrapper and row 8 refuse
    them on the CPU as on the card, and take 197 rows at every head dim."""
    assert fb.spatial_attn_bwd_smem(301, 128) > fb.SMEM_LIMIT
    for hd in (16, 64, 128):
        fb.check_spatial_attn_bwd_smem(197, hd)
    D = 128
    p = {"ln1_w": torch.ones(D), "ln1_b": torch.zeros(D),
         "qkv_w": torch.zeros(3 * D, D, dtype=bf16), "qkv_b": torch.zeros(3 * D),
         "proj_w": torch.zeros(D, D, dtype=bf16), "proj_b": torch.zeros(D)}
    x = torch.zeros(1, 1, 300, D, dtype=bf16)
    for call in (lambda: fb.spatial_phase_bwd(x, torch.zeros(1, 1, D, dtype=bf16), x,
                                              torch.zeros(1, 1, D, dtype=bf16), p, 1),
                 lambda: fb.spatial_attention_bwd(x[0].repeat(1, 1, 3), x[0, :, 0].repeat(1, 3),
                                                  x[0], x[0, :, 0], 1)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
