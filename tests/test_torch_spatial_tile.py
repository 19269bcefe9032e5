"""Rows 2 and 11's redesigned blocks on the CPU: the spatial attention with
its CLS prefix key (``fused_block.spatial_attention``, the tensor-core
tile on the card) and the wgmma GEMM (``fused_block.gemm``), through their
plain twins, and the kernel-vs-twin bound (``ops/twin_check.py``) against
the faults the tile's design could make.

Tolerances: the spatial attention's twin against the JAX package's Pallas
attention kernel (interpret mode) on the same [CLS, grid] sequences at
atol = rtol = 2e-2, and no further from a float64 oracle than Pallas
(1.1x + 1e-3), as ``tests/test_torch_attention.py`` holds row 13's twin;
the GEMM's twin against XLA's bf16 x bf16 -> f32 dot with the same
epilogue at 1e-5 relative to the output's max (both sum the same bf16
products in f32).
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.ops import attention as jat
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import (
    _build, banded_block as bb, fused_block as fb, twin_check)
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_numpy_params

N, D, H = 196, 768, 12  # rows 2 and 11 at ViT-B/16: 197 rows with the prefix, hd 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vitb_spatial():
    """Block 0's spatial weights of a numpy-seeded ViT-B/16, as chip_smoke.py
    makes them (seed 0)."""
    cfg = tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=8,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    return fb.block_params(tsf.build_timesformer(cfg, sd, device="cpu").blocks[0])["spatial"]


# ---------------------------------------------------------------------------
# Faults of the tile's design, simulated inside the ops' twins: both twins
# run their attention through fb._attention over (..., L, hd) sequences
# whose row / key 0 is the CLS prefix and whose batch axis 0 is the sample
# (row 2: B, row 11: the frame, each with its own CLS row).
# ---------------------------------------------------------------------------

_sound_attention = fb._attention


def _faulty_attention(fault):
    def attention(q, k, v, scale=None):
        if fault == "cls_key_dropped":
            return _sound_attention(q, k[..., 1:, :], v[..., 1:, :], scale)
        if fault == "cls_key_wrong_sample":
            k, v = k.clone(), v.clone()
            k[..., 0, :] = torch.roll(k[..., 0, :], 1, 0)
            v[..., 0, :] = torch.roll(v[..., 0, :], 1, 0)
            return _sound_attention(q, k, v, scale)
        out = _sound_attention(q, k, v, scale).clone()
        if fault == "cls_query_unwritten":
            out[..., 0, :] = 0
        elif fault == "last_strip_unwritten":  # query rows 192-196
            out[..., 16 * ((out.shape[-2] - 1) // 16):, :] = 0
        return out
    return attention


def _row2(p, fault=None):
    """spatial_mlp's twin at B=2 samples of T=2 frames: (grid, CLS rows) and
    the base each is held against (chip_smoke.py's checks)."""
    r = np.random.RandomState(3)
    x1 = torch.from_numpy(r.randn(2, 2, N, D)).float()
    cls = torch.from_numpy(r.randn(2, 1, D)).to(torch.bfloat16)
    grid, rows = fb.spatial_mlp_plain(x1, cls, p, H)
    return [(grid, x1), (rows, None)]


def _row11(p, fault=None):
    """spatial_phase_pf's twin at C=4 frames: (grid, qkv, qkv_cls) and
    their bases."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(4, N, D)).to(torch.bfloat16)
    cls = torch.from_numpy(r.randn(4, D)).to(torch.bfloat16)
    out, qkv, qkv_cls = bb.spatial_phase_pf_plain(x, cls, p, H)
    return [(out, x), (qkv, None), (qkv_cls, None)]


ROWS = {"row2": _row2, "row11": _row11}


@pytest.mark.parametrize("row,fault", [
    ("row2", "cls_key_dropped"), ("row2", "cls_key_wrong_sample"),
    ("row2", "cls_query_unwritten"), ("row2", "last_strip_unwritten"),
    ("row11", "cls_key_dropped"), ("row11", "cls_key_wrong_sample"),
    ("row11", "last_strip_unwritten")])
def test_twin_bound_rejects_spatial_tile_faults(monkeypatch, vitb_spatial, row, fault):
    """Each fault, planted in the op's twin, breaks the bound that
    chip_smoke.py holds the op's outputs to (any output failing fails the
    run). Row 11 computes no CLS query output, so that fault is row 2's."""
    want = ROWS[row](vitb_spatial)
    monkeypatch.setattr(fb, "_attention", _faulty_attention(fault))
    got = ROWS[row](vitb_spatial)
    bad = [twin_check.twin_failures(twin_check.twin_gap(g, w, base))
           for (g, _), (w, base) in zip(got, want)]
    assert any(bad), bad


@pytest.mark.parametrize("row", sorted(ROWS))
def test_sound_attention_passes_the_bound(monkeypatch, vitb_spatial, row):
    """The fault simulation without a fault reproduces the twin exactly."""
    want = ROWS[row](vitb_spatial)
    monkeypatch.setattr(fb, "_attention", _faulty_attention(None))
    got = ROWS[row](vitb_spatial)
    for (g, _), (w, _) in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The spatial attention's own twin
# ---------------------------------------------------------------------------

def _spatial_inputs(S, P, n, d, seed, q_scale=1.0):
    r = np.random.RandomState(seed)
    qkv, pre = r.randn(S, n, 3 * d).astype(np.float32), r.randn(P, 3 * d).astype(np.float32)
    qkv[..., :d] *= q_scale
    pre[:, :d] *= q_scale
    return (torch.from_numpy(qkv).to(torch.bfloat16),
            torch.from_numpy(pre).to(torch.bfloat16))


@pytest.mark.parametrize("S,P", [(4, 2), (3, 3)], ids=["row2_layout", "row11_layout"])
def test_spatial_attention_twin_matches_pallas(S, P):
    """spatial_attention's twin against JAX's Pallas attention kernel over
    the same [prefix, grid] sequences, (S * H, 1 + n, hd)."""
    n, d, h = 16, 128, 2
    qkv, pre = _spatial_inputs(S, P, n, d, seed=S)
    out, out_pre = fb.spatial_attention(qkv, pre, h)  # CPU -> twin
    seq = torch.cat([pre.repeat_interleave(S // P, 0)[:, None], qkv], 1)
    q, k, v = (seq[..., i * d:(i + 1) * d].reshape(S, n + 1, h, d // h)
               .transpose(1, 2).reshape(S * h, n + 1, d // h).float().numpy()
               for i in range(3))
    scale = (d // h) ** -0.5
    pallas = np.asarray(jat.fused_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), scale, block_b=2),
        np.float32).reshape(S, h, n + 1, d // h).transpose(0, 2, 1, 3).reshape(S, n + 1, d)
    got = torch.cat([out_pre[:, None], out], 1).float().numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)
    s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    oracle = np.einsum("bnm,bmd->bnd", p / p.sum(-1, keepdims=True), v).reshape(
        S, h, n + 1, d // h).transpose(0, 2, 1, 3).reshape(S, n + 1, d)
    assert np.abs(got - oracle).mean() <= 1.1 * np.abs(pallas - oracle).mean() + 1e-3


def test_spatial_attention_is_the_ops_attention(monkeypatch, vitb_spatial):
    """What spatial_mlp's twin attends over [cls_b, x_t] equals
    spatial_attention's twin on the split layout (the kernel's layout: grid
    qkv rows and one prefix row per sample)."""
    seen = {}

    def record(q, k, v, scale=None):
        seen["a"] = _sound_attention(q, k, v, scale)
        return seen["a"]

    monkeypatch.setattr(fb, "_attention", record)
    _row2(vitb_spatial)
    a = seen["a"].transpose(2, 3).reshape(2, 2, N + 1, D)  # (B, T, L, D)
    r = np.random.RandomState(3)
    x1 = torch.from_numpy(r.randn(2, 2, N, D)).float()
    cls = torch.from_numpy(r.randn(2, 1, D)).to(torch.bfloat16)
    p = vitb_spatial
    y = fb._ln(x1, p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    y_c = fb._ln(cls.float()[:, 0], p["ln1_w"], p["ln1_b"]).to(torch.bfloat16)
    qkv = (fb._mm(y, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16).reshape(4, N, 3 * D)
    qkv_c = (fb._mm(y_c, p["qkv_w"]) + p["qkv_b"]).to(torch.bfloat16)
    monkeypatch.setattr(fb, "_attention", _sound_attention)
    out, out_pre = fb.spatial_attention_plain(qkv, qkv_c, H)
    torch.testing.assert_close(out.reshape(2, 2, N, D), a[:, :, 1:], atol=0, rtol=0)
    torch.testing.assert_close(out_pre.reshape(2, 2, D), a[:, :, 0], atol=0, rtol=0)


@pytest.mark.parametrize("S,P", [(8, 2), (4, 4)])
def test_twin_bound_and_the_first_block_max_of_the_prefix_attention(S, P):
    """A row max from the first 16-key block only (the prefix and grid keys
    0-14) is invisible at unit-variance logits and non-finite at scores 64x
    those: the card tests hold the tile there (scale 8 at hd 64)."""
    qkv, pre = _spatial_inputs(S, P, N, D, seed=S + P)
    seq = torch.cat([pre.repeat_interleave(S // P, 0)[:, None], qkv], 1)
    q, k, v = seq.reshape(S, N + 1, 3, H, D // H).permute(2, 0, 3, 1, 4).unbind(0)

    def first_block_max(scale):
        s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
        e = torch.exp(s - s[..., :16].amax(-1, keepdim=True))
        o = torch.matmul(e.to(torch.bfloat16).float(), v.float()) / e.sum(-1, keepdim=True)
        return o.to(torch.bfloat16)

    for scale, visible in ((0.125, False), (8.0, True)):
        gap = twin_check.twin_gap(first_block_max(scale), fb._attention(q, k, v, scale))
        assert bool(twin_check.twin_failures(gap)) == visible, (scale, gap)
        assert gap["finite"] != visible


def test_spatial_attention_wrapper_checks_inputs():
    qkv, pre = _spatial_inputs(4, 2, 16, 128, seed=0)
    with pytest.raises(ValueError):  # 4 sequences over 3 prefix rows
        fb.spatial_attention(qkv, torch.cat([pre, pre[:1]]), 2)
    with pytest.raises(TypeError):
        fb.spatial_attention(qkv.float(), pre, 2)
    with pytest.raises(ValueError):  # head dim 128 / 3
        fb.spatial_attention(qkv, pre, 3)
    out, out_pre = fb.spatial_attention(qkv, pre, 2, prefix_out=False)
    assert out.shape == (4, 16, 128) and out_pre is None
    assert fb.launches["spatial_attention"] == 0  # the twin is no launch


# ---------------------------------------------------------------------------
# The GEMM's twin
# ---------------------------------------------------------------------------

def _xla_epilogue(epi, a, w, b, res):
    """The same epilogue in JAX: XLA's bf16 dot accumulated in f32."""
    v = jnp.dot(a, w.T, preferred_element_type=jnp.float32) + b
    if epi == "gelu_bf16":
        return jax.nn.gelu(v, approximate=False).astype(jnp.bfloat16)
    if epi == "add_bf16":
        return (res.astype(jnp.float32) + v.astype(jnp.bfloat16).astype(jnp.float32)
                ).astype(jnp.bfloat16)
    if epi in ("res_f32_f32", "res_f32_bf16", "res_bf16_f32"):
        v = res.astype(jnp.float32) + v
    return v.astype(jnp.bfloat16 if epi.endswith("bf16") else jnp.float32)


@pytest.mark.parametrize("epi", sorted(fb.GEMM_EPILOGUES))
def test_gemm_twin_matches_xla(epi):
    r = np.random.RandomState(7)
    M, N_, K = 77, 256, 192
    a, w = r.randn(M, K).astype(np.float32), (r.randn(N_, K) / 8).astype(np.float32)
    b, res = r.randn(N_).astype(np.float32), (4 * r.randn(M, N_)).astype(np.float32)
    res_dtype = fb.GEMM_EPILOGUES[epi][1]
    tres = None if res_dtype is None else torch.from_numpy(res).to(res_dtype)
    got = fb.gemm(torch.from_numpy(a).bfloat16(), torch.from_numpy(w).bfloat16(),
                  torch.from_numpy(b), epi, tres)  # CPU -> twin
    assert got.dtype == fb.GEMM_EPILOGUES[epi][2] and got.shape == (M, N_)
    jres = None if tres is None else jnp.asarray(tres.float().numpy(),
                                                  jnp.bfloat16 if res_dtype == torch.bfloat16
                                                  else jnp.float32)
    want = np.asarray(_xla_epilogue(epi, jnp.asarray(a, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), jres),
                      np.float32)
    got = got.float().numpy()
    tol = 1e-5 if got.dtype == np.float32 and not epi.endswith("bf16") else 2 ** -7
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), epi


def test_gemm_wrapper_checks_inputs():
    a, w, b = torch.zeros(5, 128).bfloat16(), torch.zeros(256, 128).bfloat16(), torch.zeros(256)
    with pytest.raises(ValueError):  # no such epilogue
        fb.gemm(a, w, b, "relu_bf16")
    with pytest.raises(ValueError):  # N % 128
        fb.gemm(a, w[:200].contiguous(), b[:200].contiguous(), "bf16")
    with pytest.raises(ValueError):  # K % 64
        fb.gemm(a[:, :96].contiguous(), w[:, :96].contiguous(), b, "bf16")
    with pytest.raises(TypeError):  # a residual epilogue without its residual
        fb.gemm(a, w, b, "res_f32_f32")
    with pytest.raises(ValueError):  # a residual where none is taken
        fb.gemm(a, w, b, "bf16", torch.zeros(5, 256))
    with pytest.raises(TypeError):  # the residual's dtype
        fb.gemm(a, w, b, "add_bf16", torch.zeros(5, 256))
    assert fb.gemm(a, w, b, "f32").dtype == torch.float32
    assert fb.launches["gemm"] == 0


# ---------------------------------------------------------------------------
# The build: every header a source includes is one a change rebuilds for
# ---------------------------------------------------------------------------

def _includes(path):
    with open(path) as f:
        return re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_build_headers_list_every_include(lib):
    """An edit to any header a source includes (directly or through another
    header) makes that library stale: _build.HEADERS lists them all."""
    listed = {os.path.basename(h) for h in _build.HEADERS}
    todo, seen = [_build.SOURCES[lib]], set()
    while todo:
        for inc in _includes(todo.pop()):
            assert inc in listed, f"{lib}: {inc} is not in _build.HEADERS"
            if inc not in seen:
                seen.add(inc)
                todo.append(os.path.join(os.path.dirname(_build.SOURCES[lib]), inc))
    assert all(os.path.exists(h) for h in _build.HEADERS)
