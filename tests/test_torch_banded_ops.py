"""The plain twins of the port's banded-path kernels against the JAX
package's Pallas kernels (``ops/banded_block.py`` and the MLP phase of
``ops/fused_block.py``), run as ``tests/test_banded_kernels.py`` runs them
(interpret mode on the CPU), on the same bf16 inputs and weights.

Sizes: D = 256, 4 heads (head dim 64), N = 8 positions, chunks of C = 64
frames with t_real in {64, 50} and windows eff in {3, 30} (the Pallas
kernels need a 32-frame block to cover a 30-frame window).

Tolerances (those of ``tests/test_torch_fused_block.py``):
* port twin vs Pallas kernel: atol = rtol = 5e-2, the JAX kernel tests'
  bound for bf16 kernels;
* against an f32 oracle computed from the same bf16 inputs:
  mean|port - oracle| <= 1.1 * mean|pallas - oracle| + 1e-3. The port
  follows the XLA-path numerics (max-subtracted softmax, f32 denominator,
  erf GELU); the Pallas kernels clamp logits at +/-80 without the max, sum
  denominators on the MXU (through a ones column or a group matrix, in
  bf16) and use tanh GELU, so the port may differ from them but must be no
  further from f32.

The kernel-vs-twin bound the card runs use (``ops/twin_check.py``) is
checked here too: it must reject each of the banded path's likely faults.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import banded as jbanded
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import banded_block as jbb
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check

D, H, N = 256, 4, 8
HD = D // H
TOL = 5e-2
# (C, t_real, eff): teacher and student windows, full and padded chunks
BANDS = [(64, 64, 30), (64, 50, 30), (64, 64, 3), (64, 50, 3)]
# chunks that are no multiple of the temporal kernel's 16-frame steps or
# 128-frame blocks (the Pallas kernel needs a divisor of C >= eff - 1)
OFF_TILE = [(90, 77, 30), (90, 77, 3), (150, 131, 30), (150, 131, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, std=0.05):
    """One block's weights as the JAX pytree (f32) and the port's kernel
    layout (bf16 (out, in) matrices, f32 vectors), from the same numbers.
    std 0.05 (the JAX kernel tests' scale) keeps the attention sharp."""
    r = np.random.RandomState(seed)

    def ln():
        return {"scale": (1 + 0.1 * r.randn(D)).astype(np.float32),
                "bias": (0.1 * r.randn(D)).astype(np.float32)}

    def lin(fi, fo):
        return {"kernel": (std * r.randn(fi, fo)).astype(np.float32),
                "bias": (0.02 * r.randn(fo)).astype(np.float32)}

    jp = {"norm1": ln(), "attn": {"qkv": lin(D, 3 * D), "proj": lin(D, D)},
          "norm2": ln(), "mlp": {"fc1": lin(D, 4 * D), "fc2": lin(4 * D, D)},
          "temporal_norm1": ln(),
          "temporal_attn": {"qkv": lin(D, 3 * D), "proj": lin(D, D)},
          "temporal_fc": lin(D, D)}

    def mat(p):
        return torch.from_numpy(p["kernel"].T.copy()).to(torch.bfloat16)

    def vec(a):
        return torch.from_numpy(a)

    ta, sa = jp["temporal_attn"], jp["attn"]
    p = {"temporal": {"ln_w": vec(jp["temporal_norm1"]["scale"]),
                      "ln_b": vec(jp["temporal_norm1"]["bias"]),
                      "qkv_w": mat(ta["qkv"]), "qkv_b": vec(ta["qkv"]["bias"]),
                      "proj_w": mat(ta["proj"]), "proj_b": vec(ta["proj"]["bias"]),
                      "fc_w": mat(jp["temporal_fc"]),
                      "fc_b": vec(jp["temporal_fc"]["bias"])},
         "spatial": {"ln1_w": vec(jp["norm1"]["scale"]),
                     "ln1_b": vec(jp["norm1"]["bias"]),
                     "qkv_w": mat(sa["qkv"]), "qkv_b": vec(sa["qkv"]["bias"]),
                     "proj_w": mat(sa["proj"]), "proj_b": vec(sa["proj"]["bias"]),
                     "ln2_w": vec(jp["norm2"]["scale"]),
                     "ln2_b": vec(jp["norm2"]["bias"]),
                     "fc1_w": mat(jp["mlp"]["fc1"]),
                     "fc1_b": vec(jp["mlp"]["fc1"]["bias"]),
                     "fc2_w": mat(jp["mlp"]["fc2"]),
                     "fc2_b": vec(jp["mlp"]["fc2"]["bias"])}}
    return jax.tree.map(jnp.asarray, jp), p


def _bf16(a):
    """f32 numpy -> (bf16 jax array, bf16 torch tensor) with one rounding."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


def _lo(C, eff, t_real):
    return np.clip(np.arange(C) - eff // 2, 0, max(t_real - eff, 0))


def _softmax(s):
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _temporal_oracle(qkv, t_real, eff):
    """f64 banded attention from the bf16 qkv (C, N, 3D): frame i against
    frames [lo_i, lo_i + eff) at its own position."""
    C = qkv.shape[0]
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(C, N, H, HD)
               for i in range(3))
    out = np.empty((C, N, H, HD))
    for i, lo in enumerate(_lo(C, eff, t_real)):
        s = np.einsum("nhd,tnhd->nht", q[i], k[lo:lo + eff]) * HD ** -0.5
        out[i] = np.einsum("nht,tnhd->nhd", _softmax(s), v[lo:lo + eff])
    return out.reshape(C, N, D)


def _cls_band_oracle(qkv_cls, qkv, t_real, eff):
    """f64 CLS window aggregation: for each frame i the mean over t in its
    window of softmax(q_i . [k_self_i, K_t]) [v_self_i; V_t]."""
    C = qkv.shape[0]
    q, ks, vs = (qkv_cls[:, i * D:(i + 1) * D].reshape(C, H, HD)
                 for i in range(3))
    k, v = (qkv[..., i * D:(i + 1) * D].reshape(C, N, H, HD) for i in (1, 2))
    out = np.zeros((C, H, HD))
    for i, lo in enumerate(_lo(C, eff, t_real)):
        for t in range(lo, lo + eff):
            keys = np.concatenate([ks[i][None], k[t]])    # (1 + N, H, HD)
            vals = np.concatenate([vs[i][None], v[t]])
            s = np.einsum("hd,mhd->hm", q[i], keys) * HD ** -0.5
            out[i] += np.einsum("hm,mhd->hd", _softmax(s), vals) / eff
    return out.reshape(C, D)


def _qkv_inputs(C, seed):
    r = np.random.RandomState(seed)
    return _bf16(1.5 * r.randn(C, N, 3 * D)), _bf16(1.5 * r.randn(C, 3 * D))


@pytest.mark.parametrize("C,t_real,eff", BANDS + OFF_TILE)
def test_banded_temporal_attn_twin_matches_pallas(C, t_real, eff):
    (qkv_j, qkv_t), _ = _qkv_inputs(C, eff + t_real)
    want = _f32(jbb.banded_temporal_attn(qkv_j[..., :D], qkv_j[..., D:],
                                         t_real, eff, H, block_p=32))
    before = dict(bb.launches)
    got = bb.banded_temporal_attn(qkv_t, t_real, eff, H)  # CPU -> twin
    assert bb.launches == before  # the twin is not a launch
    assert got.dtype == torch.bfloat16 and got.shape == (C, N, D)
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, _temporal_oracle(_f32(qkv_t).astype(np.float64),
                                            t_real, eff))


@pytest.mark.parametrize("C,t_real,eff", BANDS)
def test_cls_band_attn_twin_matches_pallas(C, t_real, eff):
    (qkv_j, qkv_t), (cls_j, cls_t) = _qkv_inputs(C, 100 + eff + t_real)
    want = _f32(jbb.cls_band_attn(cls_j[:, :D], cls_j[:, D:], qkv_j[..., D:],
                                  t_real, eff, H))
    got = bb.cls_band_attn(cls_t, qkv_t, t_real, eff, H)
    assert got.dtype == torch.bfloat16 and got.shape == (C, D)
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, _cls_band_oracle(
        _f32(cls_t).astype(np.float64), _f32(qkv_t).astype(np.float64),
        t_real, eff))


@pytest.mark.parametrize("C", [64, 50])
def test_spatial_phase_pf_twin_matches_pallas(C):
    jp, p = _params(seed=C)
    r = np.random.RandomState(C)
    xj, xt = _bf16(r.randn(C, N, D))
    cj, ct = _bf16(r.randn(C, D))
    g_j, _, kv_j, kvc_j, qc_j = jbb.spatial_phase_pf(jp["norm1"], jp["attn"],
                                                     cj, xj, H)
    g_t, qkv_t, qkv_cls_t = bb.spatial_phase_pf(xt, ct, p["spatial"], H)
    assert g_t.dtype == qkv_t.dtype == qkv_cls_t.dtype == torch.bfloat16
    assert qkv_t.shape == (C, N, 3 * D) and qkv_cls_t.shape == (C, 3 * D)
    # the exports are column slices of the port's qkv buffers
    for got, want in [(g_t, g_j), (qkv_t[..., D:], kv_j),
                      (qkv_cls_t[:, D:], kvc_j), (qkv_cls_t[:, :D], qc_j)]:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)
    # f32 oracle for the grid: the XLA banded spatial half under "highest"
    with jax.default_matmul_precision("highest"):
        _, pat_res = jbanded._banded_spatial(
            jp["norm1"], jp["attn"], jnp.asarray(_f32(cj))[:, None],
            jnp.asarray(_f32(xj)), jnp.asarray(_lo(C, 3, C)), 3, H, 32)
    oracle = _f32(xj) + np.asarray(pat_res)
    # the grid is x (rms 1) plus a branch: compare the branches
    _no_further(_f32(g_t) - _f32(xt), _f32(g_j) - _f32(xt), oracle - _f32(xt))


@pytest.mark.parametrize("M", [512, 200])
def test_mlp_phase_twin_matches_pallas(M):
    jp, p = _params(seed=M)
    xj, xt = _bf16(np.random.RandomState(M).randn(M, D))
    want = _f32(jfb.fused_mlp_phase(jp["norm2"], jp["mlp"], xj, residual=True))
    before = dict(fb.launches)
    got = fb.mlp_phase(xt, p["spatial"])
    assert fb.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with jax.default_matmul_precision("highest"):
        x32 = jnp.asarray(_f32(xt))
        oracle = np.asarray(x32 + jtsf.mlp(jp["mlp"],
                                           jtsf.layer_norm(jp["norm2"], x32)))
    x = _f32(xt)
    _no_further(got - x, want - x, oracle - x)
    # residual=False is the branch alone
    branch = _f32(fb.mlp_phase(xt, p["spatial"], residual=False))
    np.testing.assert_allclose(branch, oracle - x, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("C,t_real,eff", [(64, 64, 30), (64, 50, 3)])
def test_banded_temporal_phase_matches_pallas_phase(C, t_real, eff):
    """The temporal half around the attention (LN, qkv, proj, fc in plain
    torch, as JAX leaves them to XLA) against JAX's banded_temporal_phase."""
    jp, p = _params(seed=eff)
    xj, xt = _bf16(0.5 * np.random.RandomState(eff).randn(C, N, D))
    want = _f32(jbb.banded_temporal_phase(
        jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"], xj,
        t_real, eff, H))
    got = _f32(bb.banded_temporal_phase(xt, p["temporal"], t_real, eff, H))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_padding_rows_never_reach_valid_rows():
    """Rows >= t_real may hold anything: the valid rows' outputs of both
    attention twins do not change."""
    C, t_real = 64, 50
    (_, qkv), (_, qkv_cls) = _qkv_inputs(C, 5)
    junk = qkv.clone()
    junk[t_real:] = 50.0
    junk_cls = qkv_cls.clone()
    junk_cls[t_real:] = -50.0
    for eff in (3, 30):
        a = bb.banded_temporal_attn(qkv, t_real, eff, H)
        b = bb.banded_temporal_attn(junk, t_real, eff, H)
        torch.testing.assert_close(a[:t_real], b[:t_real], atol=0, rtol=0)
        a = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, H)
        b = bb.cls_band_attn(junk_cls, junk, t_real, eff, H)
        torch.testing.assert_close(a[:t_real], b[:t_real], atol=0, rtol=0)


def test_banded_wrappers_check_inputs_on_cpu():
    (_, qkv), (_, qkv_cls) = _qkv_inputs(64, 6)
    with pytest.raises(ValueError):  # window longer than the chunk
        bb.banded_temporal_attn(qkv, 64, 65, H)
    with pytest.raises(ValueError):  # more valid frames than rows
        bb.cls_band_attn(qkv_cls, qkv, 65, 3, H)
    with pytest.raises(TypeError):
        bb.banded_temporal_attn(qkv.float(), 64, 3, H)
    with pytest.raises(ValueError):  # qkv_cls rows must match the chunk
        bb.cls_band_attn(qkv_cls[:32].contiguous(), qkv, 64, 3, H)
    assert bb.banded_ok(768, 12, 196, 3072)
    assert not bb.banded_ok(768, 5, 196, 3072)
    assert not bb.banded_ok(256, 4, 1600, 1024)  # CLS K/V of 1600 patches


# ---------------------------------------------------------------------------
# Planted faults: the twin-gap bound must reject each
# ---------------------------------------------------------------------------

def _window_plus_one_temporal(qkv, t_real, eff, num_heads):
    """Planted fault: each window one key too long, [lo, lo + eff + 1)."""
    C = qkv.shape[0]
    q, k, v = (bb._split_heads(qkv[..., i * D:(i + 1) * D], num_heads).float()
               for i in range(3))
    lo = bb.band_starts(torch.arange(C), eff, t_real)
    kj = torch.arange(C)
    band = (kj[None] >= lo[:, None]) & (kj[None] < lo[:, None] + eff + 1)
    s = torch.einsum("inhd,jnhd->nhij", q, k) * HD ** -0.5
    s = s.masked_fill(~band, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("nhij,jnhd->inhd", e.to(torch.bfloat16).float(), v)
    o = o / e.sum(-1).permute(2, 0, 1)[..., None]
    return o.reshape(C, N, D).to(torch.bfloat16)


def _cls_band_faulty(qkv_cls, qkv, t_real, eff, num_heads, fault):
    """The CLS window aggregation, with one planted fault or none:
    "window+1" sums eff + 1 frames per window; "no_self" leaves the self
    key out of each pair's softmax; "count_mean" lets the windows shrink at
    the edges ([i - eff//2, i - eff//2 + eff) cut to [0, t_real)) and takes
    the mean over the frames left instead of dividing by eff."""
    C = qkv.shape[0]
    q, k_self, v_self = (bb._split_heads(qkv_cls[:, i * D:(i + 1) * D],
                                         num_heads).float() for i in range(3))
    k_pat, v_pat = (bb._split_heads(qkv[..., i * D:(i + 1) * D],
                                    num_heads).float() for i in (1, 2))
    idx = torch.arange(C)
    if fault == "count_mean":
        starts = idx - eff // 2
    else:
        starts = bb.band_starts(idx, eff, t_real)
    acc = torch.zeros_like(q)
    count = torch.zeros(C)
    for j in range(eff + 1 if fault == "window+1" else eff):
        t = starts + j
        inside = (t >= 0) & (t < t_real) if fault == "count_mean" else t >= 0
        t = t.clamp(0, C - 1)
        s = torch.einsum("chd,cnhd->chn", q, k_pat[t]) * HD ** -0.5
        vals = v_pat[t]
        if fault != "no_self":
            s_self = (q * k_self).sum(-1, keepdim=True) * HD ** -0.5
            s = torch.cat([s_self, s], -1)
            vals = torch.cat([v_self[:, None], vals], dim=1)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("chn,cnhd->chd", e.to(torch.bfloat16).float(), vals)
        acc += inside[:, None, None] * o / e.sum(-1, keepdim=True)
        count += inside
    div = count[:, None, None] if fault == "count_mean" else eff
    return (acc / div).reshape(C, D).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["window+1", "no_self", "count_mean"])
def test_twin_tolerance_rejects_planted_banded_fault(fault):
    """The kernel-vs-twin tolerance (ops/twin_check.py, which chip_smoke.py
    and the card tests hold the banded kernels to) rejects each fault the
    banded kernels are most likely to carry. The fault-free reimplementation
    passes it, so the bound is what tells them apart."""
    C, t_real, eff = 64, 50, 30
    (_, qkv), (_, qkv_cls) = _qkv_inputs(C, 11)
    want = bb.cls_band_attn_plain(qkv_cls, qkv, t_real, eff, H)
    sound = _cls_band_faulty(qkv_cls, qkv, t_real, eff, H, None)
    assert not twin_check.twin_failures(twin_check.twin_gap(sound, want))
    gap = twin_check.twin_gap(
        _cls_band_faulty(qkv_cls, qkv, t_real, eff, H, fault), want)
    assert twin_check.twin_failures(gap), gap
    if fault == "window+1":
        t_want = bb.banded_temporal_attn_plain(qkv, t_real, eff, H)
        gap = twin_check.twin_gap(
            _window_plus_one_temporal(qkv, t_real, eff, H), t_want)
        assert twin_check.twin_failures(gap), gap


# Faults the tensor-core temporal kernel's design could make (steps of 16
# query frames inside blocks of 128, each step's keys [lo(first),
# lo(last) + eff) scanned in 16-key blocks, the keys past them read as
# zero rows), simulated in torch at chip_smoke.py's input scale
# (unit-variance qkv).

def _temporal_faulty(qkv, t_real, eff, num_heads, fault, scale=HD ** -0.5):
    C = qkv.shape[0]
    q, k, v = (bb._split_heads(qkv[..., i * D:(i + 1) * D], num_heads).float()
               for i in range(3))  # (C, N, H, hd)
    idx = torch.arange(C)
    lo = bb.band_starts(idx, eff, t_real)
    # each row's step: its first row, its block's end, its keys [kb, ke)
    q0 = idx // 16 * 16
    i1 = torch.clamp((idx // 128 + 1) * 128, max=C)
    kb = bb.band_starts(q0, eff, t_real)
    ke = bb.band_starts(torch.minimum(q0 + 16, i1) - 1, eff, t_real) + eff
    win = lo + 1 if fault == "shifted" else lo
    kj = torch.arange(C)
    band = (kj[None] >= win[:, None]) & (kj[None] < win[:, None] + eff)
    s = torch.einsum("inhd,jnhd->nhij", q, k) * scale
    s = s.masked_fill(~band, float("-inf"))
    if fault == "max_first_block":
        first = band & (kj[None] < kb[:, None] + 16)
        m = s.masked_fill(~first, float("-inf")).amax(-1, keepdim=True)
    else:
        m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    if fault == "pad_keys_scored_zero":  # (-(ke - kb)) % 16 zero keys per row
        den = den + ((-(ke - kb)) % 16)[:, None] * torch.exp(-m)
    o = torch.einsum("nhij,jnhd->inhd", e.to(torch.bfloat16).float(), v)
    o = o / den.permute(2, 0, 1, 3)
    if fault == "last_strip_unwritten":
        o[q0 == (i1 - 1) // 16 * 16] = 0
    return o.reshape(C, -1, D).to(torch.bfloat16)


def _unit_qkv(C, seed):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(C, N, 3 * D)).to(torch.bfloat16)


@pytest.mark.parametrize("eff", [30, 3])
@pytest.mark.parametrize("fault", ["shifted", "pad_keys_scored_zero",
                                   "last_strip_unwritten"])
def test_twin_tolerance_rejects_tensor_core_band_faults(fault, eff):
    """The kernel-vs-twin bound rejects each fault of the temporal kernel's
    steps, over two 128-frame blocks with padding frames; the fault-free
    simulation passes it."""
    C, t_real = 150, 131
    qkv = _unit_qkv(C, eff)
    want = bb.banded_temporal_attn_plain(qkv, t_real, eff, H)
    sound = _temporal_faulty(qkv, t_real, eff, H, None)
    assert not twin_check.twin_failures(twin_check.twin_gap(sound, want))
    gap = twin_check.twin_gap(_temporal_faulty(qkv, t_real, eff, H, fault), want)
    assert twin_check.twin_failures(gap), gap


@pytest.mark.parametrize("eff", [30, 3])
def test_twin_tolerance_and_the_first_block_max_of_a_band(eff):
    """A row max taken from the step's first 16-key block only is invisible
    at chip_smoke.py's logits (softmax is shift-invariant; the partial max
    only rescales the exponentials) and shows where the logits spread past
    exp's range (scores 64x chip_smoke's): the output is not finite."""
    C, t_real = 150, 131
    qkv = _unit_qkv(C, 7 + eff)
    want = bb.banded_temporal_attn_plain(qkv, t_real, eff, H)
    gap = twin_check.twin_gap(
        _temporal_faulty(qkv, t_real, eff, H, "max_first_block"), want)
    assert not twin_check.twin_failures(gap), gap
    big = _temporal_faulty(qkv, t_real, eff, H, "max_first_block",
                           scale=64 * HD ** -0.5)
    gap = twin_check.twin_gap(big, _temporal_faulty(
        qkv, t_real, eff, H, None, scale=64 * HD ** -0.5))
    assert not gap["finite"] and twin_check.twin_failures(gap), gap
