"""Rows 12 and 5's new designs on the CPU.

Row 12 (``banded_block.cls_band_attn``, the CLS window aggregation) runs on
the card as blocks of ``16 qs`` query frames, strips of 16 frames on ``ks``
warps each (the frame's keys cut into runs of 16-key blocks, the runs'
row maxima and sums traded between the warps), a strip taking a target
frame only where one of its rows has it in its window, and the target
frames cut into ``z`` runs whose f32 partials are added in run order. A
numpy-seeded simulation of that decomposition here (``_strips``) must
equal the plain twin (``cls_band_attn_plain``) in every block shape, the
twin must match JAX's Pallas ``cls_band_attn`` (interpret mode on the
CPU), and the kernel-vs-twin bound (``ops/twin_check.py``) must reject the
faults the decomposition could make. Row 5 (``fused_block.attn_phase``) is
its blocks chained: LN, the GEMM, the tile at stride N = 1
(``temporal_attention``), the GEMM. The shared-memory mirrors by which
the CPU twins refuse what the kernels refuse must equal the formulas the
CUDA sources state.

Sizes: D = 128 (two heads of 64), N = 12, 16 and 40 patches (one ragged
16-key block; one; three, so the key runs split), chunks of C = 64 and 50
frames, t_real = C and below it, eff 3 and 30.

Tolerances:
* the simulation against the twin: ``twin_check``'s bound (the card's) and
  rel_rms <= 1e-3 (the two differ in f32 summation order and a
  reciprocal, which flip a bf16 rounding now and then);
* the twin against the Pallas kernel: atol = rtol = 5e-2, the JAX kernel
  tests' bound for bf16 kernels (``tests/test_torch_banded_ops.py``);
* row 5 as its blocks: bit for bit (each CPU wrapper runs its twin);
* the simulation against row 12's f32 reference (f32 probabilities): no
  further from it than the twin but for 1 %, the twin within 4e-3 rel_rms.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.ops import banded_block as jbb
from dino_video_summarization_transformer_tpu_torch.ops import banded_block as bb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check

D, H = 128, 2
HD = D // H
bf16 = torch.bfloat16
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dino_video_summarization_transformer_tpu_torch", "ops", "csrc")
# (strips a block, warps a strip, splits of the target frames): the card's
# pick at ViT-B widths, one warp a strip, short tiles, splits that leave
# some blocks no frame, and more key runs than key blocks
CONFIGS = [(4, 4, 1), (1, 1, 1), (2, 4, 3), (4, 2, 2), (1, 4, 5), (3, 3, 16)]
# (C, t_real, eff): teacher and student windows, full and padded chunks, a
# chunk no multiple of the tiles
BANDS = [(64, 64, 30), (64, 50, 30), (64, 64, 3), (64, 50, 3), (50, 41, 30),
         (50, 20, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(C, N, seed):
    r = np.random.RandomState(seed)
    return (torch.from_numpy(1.5 * r.randn(C, 3 * D).astype(np.float32)).to(bf16),
            torch.from_numpy(1.5 * r.randn(C, N, 3 * D).astype(np.float32)).to(bf16))


def _lo(i, eff, t_real):
    return min(max(i - eff // 2, 0), max(t_real - eff, 0))


def _b(t):
    return t.to(bf16).float()


def _strips(qkv_cls, qkv, t_real, eff, config, fault=None):
    """The kernel's decomposition, block by block in f32: tiles of 16 qs
    query frames, each head, each of z runs of the tile's target frames;
    strips of 16 rows on ks key runs; per (row, frame) pair the max over
    the self key and the runs' maxima, the runs' exponentials, sums and
    bf16 P V, the self key's p_self v_self on run 0, the quotient added
    where the row's window holds the frame; the runs' sums added in run
    order, the splits' in split order, times 1 / eff, rounded to bf16.
    Faults: "no_self" leaves the self key out; "shifted" moves every
    window one frame later; "split_twice" adds split 0's partial twice."""
    qs, ks, z = config
    C, N, _ = qkv.shape
    scale = HD ** -0.5
    q, k_self, v_self = (qkv_cls[:, i * D:(i + 1) * D].float().view(C, H, HD)
                         for i in range(3))
    K, V = (qkv[..., i * D:(i + 1) * D].float().view(C, N, H, HD) for i in (1, 2))
    shift = int(fault == "shifted")

    def lo(i):
        return _lo(i, eff, t_real) + shift

    Tq, nb = 16 * qs, -(-N // 16)
    runs = [(16 * (j * nb // ks), min(N, 16 * ((j + 1) * nb // ks))) for j in range(ks)]
    parts = torch.zeros(z, C, H, HD)
    for i0 in range(0, C, Tq):
        nq = min(Tq, C - i0)
        fa, fe = lo(i0), lo(i0 + nq - 1) + eff
        per = -(-(fe - fa) // z)
        for h in range(H):
            for zz in range(z):
                ta = min(fe, fa + zz * per)
                tb = min(fe, ta + per)
                red = torch.zeros(ks, nq, HD)
                for r0 in range(0, nq, 16):
                    rows = torch.arange(i0 + r0, i0 + min(nq, r0 + 16))
                    los = torch.tensor([lo(int(i)) for i in rows])
                    qr = q[rows, h]
                    s_self = (qr * k_self[rows, h]).sum(-1)
                    for t in range(max(ta, int(los[0])), min(tb, int(los[-1]) + eff)):
                        if t >= C:  # a shifted window past the chunk
                            continue
                        s = qr @ K[t, :, h].T
                        mx = torch.stack([s[:, a:e].amax(-1) * scale if a < e
                                          else torch.full((len(rows),), -math.inf)
                                          for a, e in runs]).amax(0)
                        if fault != "no_self":
                            mx = torch.maximum(mx, s_self * scale)
                        ex = torch.exp(s * scale - mx[:, None])
                        e_self = torch.exp(s_self * scale - mx)
                        tot = torch.zeros(len(rows))
                        for a, e in runs:
                            tot = tot + ex[:, a:e].sum(-1)
                        if fault != "no_self":
                            tot = tot + e_self
                        inband = ((t >= los) & (t < los + eff))[:, None]
                        for j, (a, e) in enumerate(runs):
                            o = _b(ex[:, a:e]) @ V[t, a:e, h]
                            if j == 0 and fault != "no_self":
                                o = o + _b(e_self)[:, None] * v_self[rows, h]
                            red[j, r0:r0 + len(rows)] += torch.where(
                                inband, o * (1.0 / tot)[:, None], torch.zeros(()))
                acc = red[0].clone()
                for j in range(1, ks):
                    acc = acc + red[j]
                parts[zz, i0:i0 + nq, h] = acc
    total = parts[0].clone()
    for zz in range(1, z):
        total = total + parts[zz]
    if fault == "split_twice":
        total = total + parts[0]
    return (total * (1.0 / eff)).reshape(C, D).to(bf16)


def _window_softmax(qkv_cls, qkv, t_real, eff):
    """Planted fault: one softmax per frame over its whole window (the self
    key and every patch key of the eff frames), not one per (frame, target
    frame) pair averaged."""
    C, N, _ = qkv.shape
    q, k_self, v_self = (qkv_cls[:, i * D:(i + 1) * D].float().view(C, H, HD)
                         for i in range(3))
    K, V = (qkv[..., i * D:(i + 1) * D].float().view(C, N, H, HD) for i in (1, 2))
    out = torch.empty(C, H, HD)
    for i in range(C):
        a = _lo(i, eff, t_real)
        keys = torch.cat([k_self[i][None], K[a:a + eff].reshape(-1, H, HD)])
        vals = torch.cat([v_self[i][None], V[a:a + eff].reshape(-1, H, HD)])
        s = torch.einsum("hd,mhd->hm", q[i], keys) * HD ** -0.5
        e = torch.exp(s - s.amax(-1, keepdim=True))
        out[i] = torch.einsum("hm,mhd->hd", _b(e), vals) / e.sum(-1, keepdim=True)
    return out.reshape(C, D).to(bf16)


# ---------------------------------------------------------------------------
# Row 12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("C,t_real,eff", BANDS)
def test_strip_decomposition_is_the_twin(C, t_real, eff, config):
    N = 40 if config[1] > 1 else 12
    qkv_cls, qkv = _inputs(C, N, seed=C + t_real + eff)
    want = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, H)  # CPU: the twin
    got = _strips(qkv_cls, qkv, t_real, eff, config)
    gap = twin_check.twin_gap(got, want)
    assert not twin_check.twin_failures(gap), gap
    assert gap["rel_rms"] <= 1e-3, gap


@pytest.mark.parametrize("eff,config", [(30, (4, 4, 4)), (3, (1, 4, 2))])
def test_strip_decomposition_against_the_f32_reference(eff, config):
    """Row 12's error against its f32 reference (``cls_band_attn_f32_plain``:
    f32 probabilities, no bf16 rounding of P or of the output), at the
    512-frame bucket in the card's block shapes at eff 30 and 3: the
    simulated kernel is no further from it than the twin, which rounds
    where the kernel rounds, but for an ulp-scale margin (1 %; readings
    0.99996-1.00001 of the twin's), and the twin sits at the bf16
    roundings' scale (rel_rms <= 4e-3; readings 1.7e-3 to 1.9e-3: P and the
    output each rounded to bf16, ~2^-9 relative)."""
    C, N = 512, 40
    qkv_cls, qkv = _inputs(C, N, seed=eff + N)
    ref = bb.cls_band_attn_f32_plain(qkv_cls, qkv, C, eff, H)
    assert ref.dtype == torch.float32

    def rel(out):
        return float((out.float() - ref).square().mean().sqrt()
                     / ref.square().mean().sqrt())

    e_sim = rel(_strips(qkv_cls, qkv, C, eff, config))
    e_twin = rel(bb.cls_band_attn_plain(qkv_cls, qkv, C, eff, H))
    print(f"eff {eff}: rel_rms against the f32 reference: simulated kernel "
          f"{e_sim:.4e}, twin {e_twin:.4e}")
    assert e_sim <= 1.01 * e_twin, (e_sim, e_twin)
    assert e_twin <= 4e-3, e_twin


@pytest.mark.parametrize("C,t_real,eff", BANDS[:4])
def test_cls_band_twin_matches_pallas(C, t_real, eff):
    N = 16
    qkv_cls, qkv = _inputs(C, N, seed=7 * eff + t_real)
    qc, qk = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qkv_cls, qkv))
    want = np.asarray(jnp.asarray(
        jbb.cls_band_attn(qc[:, :D], qc[:, D:], qk[..., D:], t_real, eff, H), jnp.float32))
    got = bb.cls_band_attn(qkv_cls, qkv, t_real, eff, H).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("fault", ["no_self", "shifted", "window_softmax", "split_twice"])
@pytest.mark.parametrize("eff", [30, 3])
def test_twin_bound_rejects_strip_faults(fault, eff):
    C, t_real, N = 64, 50, 16
    qkv_cls, qkv = _inputs(C, N, seed=3 + eff)
    want = bb.cls_band_attn_plain(qkv_cls, qkv, t_real, eff, H)
    if fault == "window_softmax":
        bad = _window_softmax(qkv_cls, qkv, t_real, eff)
    else:
        bad = _strips(qkv_cls, qkv, t_real, eff, (2, 2, 2), fault)
    assert not twin_check.twin_failures(twin_check.twin_gap(
        _strips(qkv_cls, qkv, t_real, eff, (2, 2, 2)), want))
    gap = twin_check.twin_gap(bad, want)
    assert twin_check.twin_failures(gap), gap


def _source_int(path, name):
    m = re.search(rf"constexpr int {name} = (\d+);", open(os.path.join(CSRC, path)).read())
    assert m, name
    return int(m.group(1))


def test_cls_band_shared_memory_mirror_is_the_sources_formula():
    """banded_block's mirror of the library's dvst_cls_band_smem (one
    strip: the least a block needs): the source's constants and formulas
    (restated here from banded_block.cu), at every head dim and a range of
    patch counts; ViT-B/16's teacher block (four strips, 124 KB) and
    student block (one strip, 105 KB) as the source's cls_config picks
    them."""
    src = open(os.path.join(CSRC, "banded_block.cu")).read()
    assert bb.CLS_STRIPS == _source_int("banded_block.cu", "kClsStrips")
    assert bb.CLS_KEY_RUNS == _source_int("banded_block.cu", "kClsKeyRuns")
    for line in ["const size_t ring = (size_t)8 * N * hd;",
                 "const size_t red = (size_t)64 * ks * qs * hd;",
                 "return 16 + (size_t)96 * qs * hd + (size_t)128 * qs * ks + "
                 "(ring > red ? ring : red);",
                 "return hd <= 64 ? 16 : 8;",
                 "ClsCfg c{(eff + 6) / 8, kClsKeyRuns, 1};",
                 "return (long)cls_smem(N, hd, 1, kClsKeyRuns);"]:
        assert line in src, line
    ks = bb.CLS_KEY_RUNS

    def smem(N, hd, qs):
        return 16 + 96 * qs * hd + 128 * qs * ks + max(8 * N * hd, 64 * ks * qs * hd)

    for N in (8, 16, 40, 196, 256, 400):
        for hd in (16, 32, 48, 64, 80, 96, 112, 128):
            assert bb.cls_band_smem(N, hd) == bb._cls_smem(N, hd, 1, ks) == smem(N, hd, 1)
    assert bb._cls_smem(196, 64, 4, 4) == smem(196, 64, 4) == 126992
    assert bb._cls_smem(196, 64, 1, 4) == 107024


def test_cls_band_refuses_what_shared_memory_cannot_hold():
    """At hd 128 a frame's K and V need 512 B a patch, 1 KB in two stages:
    215 patches overflow even one strip (214 fit), and the twin refuses as
    the kernel would."""
    qkv_cls, qkv = (torch.zeros(32, 3 * 256, dtype=bf16),
                    torch.zeros(32, 215, 3 * 256, dtype=bf16))
    assert bb.cls_band_smem(214, 128) <= fb.SMEM_LIMIT < bb.cls_band_smem(215, 128)
    with pytest.raises(ValueError, match="shared memory"):
        bb.cls_band_attn(qkv_cls, qkv, 32, 3, 2)
    assert bb.banded_problems(256, 2, 215, 1024)
    assert not bb.banded_problems(256, 2, 214, 1024)


@pytest.mark.parametrize("C,t_real,eff,config", [(512, 512, 30, (4, 4, 1)),
                                                 (512, 512, 3, (4, 4, 2)),
                                                 (64, 40, 30, (4, 4, 8))])
def test_cls_band_traffic(C, t_real, eff, config):
    """The traffic model the smoke and the bench print beside row 12's
    bytes bound: each 64-frame tile reads its 64 + eff - 1 frames' patch
    K / V (fewer where the windows clamp at the edges)."""
    from dino_video_summarization_transformer_tpu_torch.tools import cls_band_bench

    N, Dw = 196, 768
    got = cls_band_bench.modelled_traffic(C, N, Dw, t_real, eff, config)
    lo = [_lo(i, eff, t_real) for i in range(C)]
    frames = sum(lo[min(i0 + 64, C) - 1] + eff - lo[i0] for i0 in range(0, C, 64))
    assert got["kv_bytes"] == frames * N * 2 * Dw * 2
    assert got["reread"] == pytest.approx(frames / C)
    z = config[2]
    assert got["bytes"] == got["kv_bytes"] + z * C * 3 * Dw * 2 + C * Dw * 2 + (
        2 * z * C * Dw * 4 if z > 1 else 0)
    if (C, eff) == (512, 30):
        assert got["reread"] == pytest.approx(1 + (29 * 8 - 15 - 14) / 512)


# ---------------------------------------------------------------------------
# Row 5
# ---------------------------------------------------------------------------

def _spatial_params(seed):
    r = np.random.RandomState(seed)

    def t(a, dtype=bf16):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return {"ln1_w": t(1 + 0.1 * r.randn(D), torch.float32),
            "ln1_b": t(0.05 * r.randn(D), torch.float32),
            "qkv_w": t(0.1 * r.randn(3 * D, D)), "qkv_b": t(0.02 * r.randn(3 * D), torch.float32),
            "proj_w": t(0.1 * r.randn(D, D)), "proj_b": t(0.02 * r.randn(D), torch.float32)}


@pytest.mark.parametrize("S,L", [(3, 17), (5, 3), (2, 197), (36, 3)])
def test_attn_phase_is_its_blocks(S, L):
    """Row 5 equals its blocks' wrappers chained as the kernel chains them
    (on the CPU each runs its twin), bit for bit: LN in f32 rounded to
    bf16, the qkv GEMM, the tile over S contiguous sequences of L rows
    (``temporal_attention`` at N = 1: one sequence a block at L = 197, 35
    at L = 3, so S = 36 leaves a ragged group), the proj GEMM."""
    p = _spatial_params(S + L)
    x = torch.from_numpy(np.random.RandomState(L).randn(S, L, D).astype(np.float32)).to(bf16)
    got = fb.attn_phase(x, p, H)
    y = fb._ln(x.float(), p["ln1_w"], p["ln1_b"]).to(bf16).reshape(S * L, D)
    qkv = fb.gemm(y, p["qkv_w"], p["qkv_b"], "bf16").reshape(S, L, 1, 3 * D)
    a = fb.temporal_attention(qkv, H).reshape(S * L, D)
    want = fb.gemm(a, p["proj_w"], p["proj_b"], "bf16").reshape(S, L, D)
    assert torch.equal(got, want)
    assert torch.equal(got, fb.attn_phase_plain(x, p, H))


def test_attn_phase_refuses_what_the_tile_cannot_hold():
    """Row 5's attention is the tile's: a 700-row sequence at hd 64 needs
    16 + 6 * 700 * 64 B of shared memory in one block (the tile's check,
    ``check_temporal_attn_smem``), and the twin refuses it as the kernel
    would; 600 rows fit."""
    p = _spatial_params(1)
    assert fb.temporal_attn_smem(1, 600, HD) <= fb.SMEM_LIMIT < fb.temporal_attn_smem(1, 700, HD)
    with pytest.raises(ValueError, match="shared memory"):
        fb.attn_phase(torch.zeros(1, 700, D, dtype=bf16), p, H)
    assert fb.attn_phase(torch.zeros(1, 600, D, dtype=bf16), p, H).shape == (1, 600, D)


@pytest.mark.parametrize("B,T,N", [(1, 3, 5), (2, 8, 4)])
def test_spatial_phase_f32_tier_is_the_branch(B, T, N):
    """Row 4's f32 grid tier (the same launches on the card, the proj
    epilogue writing x + proj in f32) holds the branch the bf16 tier
    rounds: bf16(x + bf16(f32 tier - x)) is the bf16 tier but for a
    rounding flip (f32 tier - x recovers the branch to an f32 rounding),
    and the CLS rows are the same."""
    p = _spatial_params(B * T)
    r = np.random.RandomState(N)
    x = torch.from_numpy(r.randn(B, T, N, D).astype(np.float32)).to(bf16)
    cls = torch.from_numpy(r.randn(B, 1, D).astype(np.float32)).to(bf16)
    g16, c16 = fb.spatial_phase(x, cls, p, H)
    g32, c32 = fb.spatial_phase(x, cls, p, H, out_dtype=torch.float32)
    assert g32.dtype == torch.float32 and torch.equal(c16, c32)
    branch = (g32 - x.float()).to(bf16).float()
    assert twin_check.rounding_ulps(g16, (x.float() + branch).to(bf16), x) <= 1
    with pytest.raises(ValueError, match="out_dtype"):
        fb.spatial_phase(x, cls, p, H, out_dtype=torch.float16)
