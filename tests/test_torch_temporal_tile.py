"""Rows 1 and 6's temporal attention on the CPU: the tensor-core tile at
stride N (``fused_block.temporal_attention``; ``temporal_phase_tm`` and
``temporal_phase`` run it on the card) through its plain twin, the
kernel-vs-twin bound (``ops/twin_check.py``) against the faults the tile's
design could make, and the shared-memory need by which the CPU twins
refuse what the kernel refuses.

Tolerances: the twin against the JAX package's Pallas attention kernel
(interpret mode) on the same sequences, gathered at stride N, at atol =
rtol = 2e-2, and no further from a float64 oracle than Pallas (1.1x +
1e-3), as ``tests/test_torch_spatial_tile.py`` holds the spatial
attention's twin.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.ops import attention as jat
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import (
    attention as at, fused_block as fb, twin_check)
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_numpy_params

D, H = 768, 12  # ViT-B/16: hd 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vitb_temporal():
    """Block 0's temporal weights of a numpy-seeded ViT-B/16, as chip_smoke.py
    makes them (seed 0)."""
    cfg = tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, num_frames=8,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    return fb.block_params(tsf.build_timesformer(cfg, sd, device="cpu").blocks[0])["temporal"]


def _qkv(B, T, N, d, seed, q_scale=1.0):
    qkv = np.random.RandomState(seed).randn(B, T, N, 3 * d).astype(np.float32)
    qkv[..., :d] *= q_scale
    return torch.from_numpy(qkv).to(torch.bfloat16)


def _sequences(qkv, h):
    """(B, T, N, 3D) -> q, k, v (B*N*h, T, hd): sequence (b, n) at each head,
    its rows gathered at stride N."""
    B, T, N, D3 = qkv.shape
    d = D3 // 3
    return [qkv[..., i * d:(i + 1) * d].reshape(B, T, N, h, d // h)
            .permute(0, 2, 3, 1, 4).reshape(B * N * h, T, d // h) for i in range(3)]


def _unsequence(o, B, T, N):
    """(B*N*h, T, hd) -> (B, T, N, D)."""
    h, hd = o.shape[0] // (B * N), o.shape[-1]
    return o.reshape(B, N, h, T, hd).permute(0, 3, 1, 2, 4).reshape(B, T, N, h * hd)


# ---------------------------------------------------------------------------
# The twin against Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 4])
@pytest.mark.parametrize("T", [3, 30])
def test_temporal_attention_twin_matches_pallas(T, N):
    """temporal_attention's twin against JAX's Pallas attention kernel over
    the same sequences, gathered at stride N, (B * N * h, T, hd)."""
    B, d, h = 2, 128, 2
    qkv = _qkv(B, T, N, d, seed=10 * T + N)
    got = fb.temporal_attention(qkv, h).float().numpy()  # CPU -> twin
    q, k, v = (t.float().numpy() for t in _sequences(qkv, h))
    scale = (d // h) ** -0.5
    pallas = _unsequence(torch.from_numpy(np.asarray(jat.fused_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), scale, block_b=2),
        np.float32)), B, T, N).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)
    s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    oracle = _unsequence(torch.from_numpy(np.einsum(
        "bnm,bmd->bnd", p / p.sum(-1, keepdims=True), v)), B, T, N).numpy()
    assert np.abs(got - oracle).mean() <= 1.1 * np.abs(pallas - oracle).mean() + 1e-3


@pytest.mark.parametrize("N", [1, 4])
@pytest.mark.parametrize("T", [3, 30])
def test_temporal_attention_twin_is_the_standalone_twin_at_stride_n(T, N):
    """The strided twin equals row 13's twin (``attention.fused_attention``
    on the CPU) on the sequences gathered at stride N, bit for bit: one
    arithmetic, two layouts."""
    B, d, h = 2, 128, 2
    qkv = _qkv(B, T, N, d, seed=T + N)
    want = _unsequence(at.fused_attention(*_sequences(qkv, h), (d // h) ** -0.5), B, T, N)
    assert torch.equal(fb.temporal_attention(qkv, h), want)


# ---------------------------------------------------------------------------
# Faults of the tile's design, simulated inside the twin: temporal_attention's
# twin (and through it temporal_phase_tm's and temporal_phase's) runs its
# attention through fb._attention over (B, N, H, T, hd) sequences.
# ---------------------------------------------------------------------------

_sound_attention = fb._attention


def _stride_one(t):
    """(B, N, H, T, hd) at stride N -> the same rows read at stride 1:
    sequence n takes rows n*T .. n*T + T - 1 of its clip."""
    B, N, Hh, T, hd = t.shape
    return (t.permute(0, 3, 1, 2, 4).reshape(B, T * N, Hh, hd)
            .reshape(B, N, T, Hh, hd).permute(0, 1, 3, 2, 4))


def _stride_one_back(t):
    """The inverse of ``_stride_one``: outputs written at stride 1 back in
    the stride-N layout."""
    B, N, Hh, T, hd = t.shape
    return (t.permute(0, 1, 3, 2, 4).reshape(B, N * T, Hh, hd)
            .reshape(B, T, N, Hh, hd).permute(0, 2, 3, 1, 4))


def _packed_mixed(q, k, v, scale):
    """Every row of a strip of five packed 3-row sequences (consecutive
    sequences b*N + n of one head, the tile's packing at T = 3) sees all 15
    keys of the strip, not its own three."""
    B, N, Hh, T, hd = q.shape

    def flat(t):
        return t.permute(2, 0, 1, 3, 4).reshape(Hh, B * N, T, hd)

    outs = []
    for qs, ks, vs in zip(*(flat(t).split(16 // T, dim=1) for t in (q, k, v))):
        n = qs.shape[1]
        o = _sound_attention(*(t.reshape(Hh, 1, n * T, hd) for t in (qs, ks, vs)), scale)
        outs.append(o.reshape(Hh, n, T, hd))
    return torch.cat(outs, 1).reshape(Hh, B, N, T, hd).permute(1, 2, 0, 3, 4)


def _faulty_attention(fault):
    def attention(q, k, v, scale=None):
        if fault == "stride_one":
            return _stride_one_back(_sound_attention(
                _stride_one(q), _stride_one(k), _stride_one(v), scale))
        if fault == "first_key_dropped":
            return _sound_attention(q, k[..., 1:, :], v[..., 1:, :], scale)
        if fault == "packed_sequences_mixed":
            return _packed_mixed(q, k, v, scale)
        return _sound_attention(q, k, v, scale)
    return attention


def _outputs(p, op, T):
    """(output, the base chip_smoke.py holds it against): the attention alone
    (B=1 clip of N=10 positions: 10 sequences, two strips of five at T =
    3), row 1 (temporal_phase_tm, its f32-out tier, out - x) or row 6 (the
    same op at N = 1 over 10 sequences, through which chip_smoke.py holds
    temporal_phase's branch)."""
    r = np.random.RandomState(T)
    if op == "attention":
        return fb.temporal_attention_plain(_qkv(1, T, 10, D, seed=T), H), None
    shape = (1, T, 10, D) if op == "row1" else (10, T, 1, D)
    x = torch.from_numpy(r.randn(*shape)).to(torch.bfloat16)
    return fb.temporal_phase_tm_plain(x, p, H), x


FAULTS = [("stride_one", 30), ("stride_one", 3), ("first_key_dropped", 30),
          ("first_key_dropped", 3), ("packed_sequences_mixed", 3)]


@pytest.mark.parametrize("fault,T,op", [
    (f, T, op) for f, T in FAULTS for op in ("attention", "row1", "row6")
    if not (f == "stride_one" and op == "row6")])  # at N = 1 stride 1 is stride N
def test_twin_bound_rejects_temporal_tile_faults(monkeypatch, vitb_temporal, fault, T, op):
    """Each fault, planted in the twin, breaks the bound that chip_smoke.py
    holds the op's output to."""
    want, base = _outputs(vitb_temporal, op, T)
    monkeypatch.setattr(fb, "_attention", _faulty_attention(fault))
    got, _ = _outputs(vitb_temporal, op, T)
    assert twin_check.twin_failures(twin_check.twin_gap(got, want, base))


@pytest.mark.parametrize("T", [3, 30])
def test_sound_attention_passes_the_bound(monkeypatch, vitb_temporal, T):
    """The fault simulation without a fault reproduces the twin exactly, and
    the stride-1 layout change alone is undone exactly."""
    for op in ("attention", "row1"):
        want, _ = _outputs(vitb_temporal, op, T)
        monkeypatch.setattr(fb, "_attention", _faulty_attention(None))
        got, _ = _outputs(vitb_temporal, op, T)
        monkeypatch.setattr(fb, "_attention", _sound_attention)
        assert torch.equal(got, want)
    t = torch.arange(2 * 4 * 3 * T * 5, dtype=torch.float32).reshape(2, 4, 3, T, 5)
    assert torch.equal(_stride_one_back(_stride_one(t)), t)


@pytest.mark.parametrize("T", [30])
def test_twin_bound_and_the_first_block_max_of_the_temporal_attention(T):
    """A row max from the first 16-key block only (keys 0-15 of 30) is
    invisible at unit-variance logits and non-finite at scores 64x those:
    the card tests hold the tile there (scale 8 at hd 64)."""
    q, k, v = _sequences(_qkv(2, T, 4, D, seed=5), H)

    def first_block_max(scale):
        s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
        e = torch.exp(s - s[..., :16].amax(-1, keepdim=True))
        o = torch.matmul(e.to(torch.bfloat16).float(), v.float()) / e.sum(-1, keepdim=True)
        return o.to(torch.bfloat16)

    for scale, visible in ((0.125, False), (8.0, True)):
        gap = twin_check.twin_gap(first_block_max(scale), fb._attention(q, k, v, scale))
        assert bool(twin_check.twin_failures(gap)) == visible, (scale, gap)
        assert gap["finite"] != visible


# ---------------------------------------------------------------------------
# The wrapper and its shared memory
# ---------------------------------------------------------------------------

def test_temporal_attention_wrapper_checks_inputs():
    qkv = _qkv(2, 3, 4, 128, seed=0)
    with pytest.raises(ValueError):  # (B*T*N, 3D) rows: the wrapper takes (B, T, N, 3D)
        fb.temporal_attention(qkv.reshape(24, 384), 2)
    with pytest.raises(ValueError):  # 3D not a multiple of 3
        fb.temporal_attention(qkv[..., :380].contiguous(), 2)
    with pytest.raises(TypeError):
        fb.temporal_attention(qkv.float(), 2)
    with pytest.raises(ValueError):  # head dim 128 / 3
        fb.temporal_attention(qkv, 3)
    with pytest.raises(ValueError):
        fb.temporal_attention(qkv.transpose(1, 2), 2)
    out = fb.temporal_attention(qkv, 2, scale=0.5)
    assert out.shape == (2, 3, 4, 128) and out.dtype == torch.bfloat16
    assert torch.equal(out, fb.temporal_attention_plain(qkv, 2, 0.5))
    assert fb.launches["temporal_attention"] == 0  # the twin is no launch


@pytest.mark.parametrize("S,L,hd,need", [
    (1568, 30, 64, 16 + 6 * 3 * 30 * 64),    # the teacher window: 3 sequences a block
    (1568, 3, 64, 16 + 6 * 35 * 3 * 64),     # the student window: 35 (7 strips of 5)
    (2, 3, 64, 16 + 6 * 2 * 3 * 64),         # fewer sequences than a group
    (1568, 197, 64, 16 + 6 * 197 * 64),      # row 6's longest card shape: 75.7 KB
    (3136, 8, 64, 16 + 6 * 14 * 8 * 64),     # the train step's global crops
    (5, 112, 128, 16 + 6 * 112 * 128),       # 7 strips: one sequence a block
    (5, 96, 128, 16 + 6 * 96 * 128)])        # 6 strips: still one
def test_temporal_attention_shared_memory(S, L, hd, need):
    """The mirror of the library's dvst_temporal_attn_smem (a card test
    holds them equal): 16 zero bytes, then a group's Q, K and V."""
    assert fb.temporal_attn_smem(S, L, hd) == need


def test_temporal_ops_refuse_what_shared_memory_cannot_hold():
    """One 700-row sequence at hd 64 needs 263 KB: every temporal op refuses
    it on the CPU as on the card, and admits every length the card tests
    run (T <= 30 windows, sequences up to 197 rows)."""
    assert fb.temporal_attn_smem(1, 700, 64) > fb.SMEM_LIMIT
    for L in (3, 30, 197):
        for hd in (16, 64, 128):
            fb.check_temporal_attn_smem(1568, L, hd)
    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=128, depth=1,
                                num_heads=2, num_frames=4, num_classes=0)
    sd = convert.state_dict_from_jax_params(make_numpy_params(cfg, seed=0), cfg)
    p = fb.block_params(tsf.build_timesformer(cfg, sd, device="cpu").blocks[0])["temporal"]
    x = torch.zeros(1, 700, 1, 128, dtype=torch.bfloat16)
    for call in (lambda: fb.temporal_attention(torch.zeros(1, 700, 1, 384,
                                                           dtype=torch.bfloat16), 2),
                 lambda: fb.temporal_phase_tm(x, p, 2),
                 lambda: fb.temporal_phase(x[:, :, 0], p, 2)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
