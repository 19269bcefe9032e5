"""The port's standalone attention and the attention swap against the JAX
package's ``ops/attention.py`` (the Pallas kernel in interpret mode on
the CPU, as ``tests/test_fused_block.py`` runs it), and the shared-memory
probe's plain side.

Tolerances, the JAX attention test's own: atol = rtol = 2e-2 against the
Pallas kernel and ``mhsa_pallas``; and no further from the f32 oracle
(numpy softmax attention in float64, or the JAX XLA forward in f32 at
matmul precision "highest") than Pallas: mean|port - oracle| <= 1.1 *
mean|pallas - oracle| + 1e-3. The port subtracts the row max and sums the
denominator in f32; the Pallas kernel clamps logits at +/-80 instead and
sums the bf16 probabilities through a ones column.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import attention as jat
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import attention as at
from dino_video_summarization_transformer_tpu_torch.ops import twin_check
from dino_video_summarization_transformer_tpu_torch.tools import smem_probe

TOL = 2e-2
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
          num_frames=4, num_classes=0)
# The f32 forward with the attention swap against the f32 forward without
# it: the only difference is the bf16 rounding of the probabilities before
# PV. Read here at D=128, depth 2: max 1.24e-3 (JAX's own swap: 2.2e-3).
F32_SWAP_MAX = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


def _qkv(dtype, B=4, L=12, hd=32, seed=0):
    jd, td = DTYPES[dtype]
    r = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        a = r.randn(B, L, hd).astype(np.float32)
        out.append((jnp.asarray(a, jd), torch.from_numpy(a).to(td)))
    return out


def _check_against_pallas(dtype, pack, **shape):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(dtype, **shape)
    B, L, hd = qt.shape
    scale = hd ** -0.5
    want = _f32(jat.fused_attention(qj, kj, vj, scale, block_b=2, pack=pack))
    got = at.fused_attention(qt, kt, vt, scale, pack=pack)  # CPU -> twin
    assert got.dtype == qt.dtype and got.shape == qt.shape
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # oracle: per-sequence softmax attention in float64
    sl = L // pack
    q, k, v = (_f32(t).astype(np.float64).reshape(B * pack, sl, hd)
               for t in (qj, kj, vj))
    s = np.einsum("bnd,bmd->bnm", q, k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    oracle = np.einsum("bnm,bmd->bnd", p / p.sum(-1, keepdims=True), v)
    _no_further(got, want, oracle.reshape(B, L, hd))


@pytest.mark.parametrize("pack", [1, 3])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fused_attention_matches_pallas(dtype, pack):
    _check_against_pallas(dtype, pack)


@pytest.mark.parametrize("L", [15, 16, 17, 63, 64, 65])
def test_fused_attention_bf16_matches_pallas_at_strip_edges(L):
    """The bf16 kernel cuts each sequence into 16-row strips (and puts
    16 // L whole sequences in one strip where L < 16): the twin it is held
    to on the card, against the Pallas kernel, at the strips' edges."""
    _check_against_pallas("bf16", 1, B=3, L=L, hd=64, seed=L)


def test_pack_is_a_view_of_more_sequences():
    (_, q), (_, k), (_, v) = _qkv("bf16", B=2, L=12, hd=16, seed=1)
    got = at.fused_attention(q, k, v, 0.25, pack=4)
    want = at.fused_attention(*(t.reshape(8, 3, 16) for t in (q, k, v)), 0.25)
    assert torch.equal(got, want.reshape(2, 12, 16))


@pytest.fixture(scope="module")
def pair():
    jcfg = jtsf.TimeSformerConfig(**KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=21))
    cfg = tsf.TimeSformerConfig(**KW)
    return params, jcfg, cfg, convert.state_dict_from_jax_params(params, cfg)


@pytest.mark.parametrize("L", [5, 17], ids=["packed_by_jax", "unpacked"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mhsa_fused_matches_mhsa_pallas(pair, dtype, L):
    """mhsa_fused against mhsa_pallas on block 0's spatial weights; at L=5
    JAX packs four sequences per score tile (N <= 48)."""
    params, _, cfg, sd = pair
    jd, td = DTYPES[dtype]
    p = jax.tree.map(lambda a: jnp.asarray(a[0], jd), params["blocks"]["attn"])
    blk = tsf.build_timesformer(cfg, sd, device="cpu", dtype=td).blocks[0]
    x = np.random.RandomState(L).randn(4, L, cfg.embed_dim).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = _f32(jat.mhsa_pallas(p, jnp.asarray(x, jd), cfg.num_heads))
    with torch.inference_mode():
        got = at.mhsa_fused(torch.from_numpy(x).to(td), blk.attn.qkv,
                            blk.attn.proj, cfg.num_heads)
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_attention_swap_forward_matches_jax(pair, dtype):
    """The whole forward with TimeSformerConfig.attention_kernel against
    JAX's forward under use_pallas_attention(True) (restored after), and
    no further from the f32 forward than it. In f32 it stays within
    F32_SWAP_MAX of the port's f32 forward without the swap."""
    params, jcfg, cfg, sd = pair
    jd, td = DTYPES[dtype]
    x = np.random.RandomState(7).randn(2, 3, 5, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.forward_features(params, jnp.asarray(x), jcfg))
        jat.use_pallas_attention(True)
        try:
            want = _f32(jtsf.forward_features(
                jax.tree.map(lambda a: jnp.asarray(a, jd), params),
                jnp.asarray(x, jd), jcfg, compute_dtype=jd))
        finally:
            jat.use_pallas_attention(False)
    model = tsf.build_timesformer(dataclasses.replace(cfg, attention_kernel=True),
                                  sd, device="cpu", dtype=td)
    before = dict(at.launches)
    with torch.inference_mode():
        got = _f32(model.forward_features(torch.from_numpy(x)))
    assert at.launches == before  # CPU tensors run the twin
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, oracle)
    if dtype == "f32":
        plain = tsf.build_timesformer(cfg, sd, device="cpu")
        with torch.inference_mode():
            ref = _f32(plain.forward_features(torch.from_numpy(x)))
        gap = float(np.abs(got - ref).max())
        print(f"f32 forward, swap vs no swap: max |diff| {gap:.3e}")
        assert 0 < gap <= F32_SWAP_MAX
        np.testing.assert_allclose(ref, oracle, atol=1e-5, rtol=1e-5)


def test_swap_is_per_model(pair):
    """Two models, with and without the swap, in one process: only the one
    with it runs mhsa_fused (JAX's swap is process-wide)."""
    _, _, cfg, sd = pair
    on = tsf.build_timesformer(dataclasses.replace(cfg, attention_kernel=True),
                               sd, device="cpu")
    off = tsf.build_timesformer(cfg, sd, device="cpu")
    assert all(b.mhsa_fn is at.mhsa_fused for b in on.blocks)
    assert all(b.mhsa_fn is tsf.mhsa for b in off.blocks)


def test_fused_attention_checks_inputs():
    q = torch.zeros(2, 12, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        at.fused_attention(q, q, q, 1.0, pack=5)  # 12 % 5
    with pytest.raises(TypeError):
        at.fused_attention(q, q.float(), q, 1.0)  # mixed dtypes
    with pytest.raises(TypeError):
        at.fused_attention(q.half(), q.half(), q.half(), 1.0)
    with pytest.raises(ValueError):
        at.fused_attention(q[..., :24].contiguous(), q[..., :24].contiguous(),
                           q[..., :24].contiguous(), 1.0)  # hd % 16
    with pytest.raises(ValueError, match="device"):
        at.fused_attention(*(torch.zeros(1, 4, 16, device="meta"),) * 3, 1.0)
    before = dict(at.launches)
    at.fused_attention(q, q, q, 1.0)
    assert at.launches == before


def _uniform(q, k, v, scale):
    """Planted fault: every key weighted alike."""
    return v.float().mean(dim=-2, keepdim=True).expand(v.shape).to(q.dtype)


def _unscaled(q, k, v, scale, twin=at.fused_attention_plain):
    """Planted fault: the logit scale left out."""
    return twin(q, k, v, 1.0)


@pytest.mark.parametrize("fault", [_uniform, _unscaled], ids=["uniform", "unscaled"])
def test_twin_tolerance_rejects_planted_fault(monkeypatch, fault):
    """The kernel-vs-twin bound (ops/twin_check.py) that chip_smoke.py holds
    row 13 to rejects a wrong attention at chip_smoke's input scale
    (unit-variance q, k, v)."""
    (_, q), (_, k), (_, v) = _qkv("bf16", B=8, L=30, hd=64, seed=3)
    sound = at.fused_attention(q, k, v, 0.125)
    monkeypatch.setattr(at, "fused_attention_plain", fault)
    gap = twin_check.twin_gap(at.fused_attention(q, k, v, 0.125), sound)
    assert twin_check.twin_failures(gap), gap


# Faults the tensor-core kernel's design could make (16-row strips over
# keys in 16-key blocks, the keys past L read as zero rows), simulated in
# torch at chip_smoke.py's input scale (unit-variance q, k, v, hd 64).

def _pad_keys_scored_zero(q, k, v, scale):
    """Planted fault: the zero keys that fill the last 16-key block scored
    0 instead of -inf (they add exp(-max) each to the denominator)."""
    pad = -k.shape[-2] % 16
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    return at.fused_attention_plain(q, kp, vp, scale)


def _last_strip_unwritten(q, k, v, scale):
    """Planted fault: the last 16-row strip of each sequence not written
    (the output buffer is uninitialised; zeros here)."""
    out = at.fused_attention_plain(q, k, v, scale)
    out[:, 16 * ((q.shape[-2] - 1) // 16):] = 0
    return out


def _max_of_first_block(q, k, v, scale):
    """Planted fault: the row max taken over the first 16-key block only."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    e = torch.exp(s - s[..., :16].amax(-1, keepdim=True))
    o = torch.matmul(e.to(torch.bfloat16).float(), v.float())
    return (o / e.sum(-1, keepdim=True)).to(q.dtype)


@pytest.mark.parametrize("L", [30, 197])
@pytest.mark.parametrize("fault", [_pad_keys_scored_zero, _last_strip_unwritten],
                         ids=["pad_keys_scored_zero", "last_strip_unwritten"])
def test_twin_tolerance_rejects_tensor_core_faults(fault, L):
    """The kernel-vs-twin bound (ops/twin_check.py) rejects each fault of the
    strip design at the attention swap's sequence lengths."""
    (_, q), (_, k), (_, v) = _qkv("bf16", B=8, L=L, hd=64, seed=L)
    want = at.fused_attention(q, k, v, 0.125)
    gap = twin_check.twin_gap(fault(q, k, v, 0.125), want)
    assert twin_check.twin_failures(gap), gap


@pytest.mark.parametrize("L", [30, 197])
def test_twin_tolerance_and_the_first_block_max(L):
    """A row max taken from the first key block only is invisible at
    chip_smoke.py's logits: softmax is shift-invariant and the partial max
    only rescales the exponentials, which bf16 rounds to the same relative
    precision, so the bound cannot see it there (as it cannot see a dropped
    max). It shows where the logits spread past exp's range: scores 64x
    chip_smoke's overflow exp and the output is not finite."""
    (_, q), (_, k), (_, v) = _qkv("bf16", B=8, L=L, hd=64, seed=L)
    gap = twin_check.twin_gap(_max_of_first_block(q, k, v, 0.125),
                              at.fused_attention(q, k, v, 0.125))
    assert not twin_check.twin_failures(gap), gap
    gap = twin_check.twin_gap(_max_of_first_block(q, k, v, 8.0),
                              at.fused_attention(q, k, v, 8.0))
    assert not gap["finite"] and twin_check.twin_failures(gap), gap


def test_smem_probe_plain_side():
    """The probe's twin reverses the row; the probe itself measures a card
    and refuses to run without one."""
    x = torch.arange(7, dtype=torch.float32)
    assert torch.equal(smem_probe.roundtrip(x), x.flip(0))
    assert smem_probe.launches["smem_probe"] == 0
    with pytest.raises(ValueError):
        smem_probe.roundtrip(torch.zeros(2, 3))
    with pytest.raises(RuntimeError):
        smem_probe.probe(device="cpu")
