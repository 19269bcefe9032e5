"""The XLA-layout block's per-phase dispatch of the port against the JAX
package: the twins of the two attention-phase kernels against the Pallas
kernels (interpret mode on the CPU, as ``tests/test_fused_block.py`` runs
them), ``Block.forward(use_fused=True)`` against ``divided_block(
use_fused=True)``, its drop-path branch against JAX's fed JAX's own masks,
and the whole forward; same numpy-seeded weights on both sides.

Tolerances, the JAX kernel tests' own: atol = rtol = 5e-2 for the phases
and blocks against their Pallas counterparts; and no further from the f32
oracle (the JAX XLA route in f32, matmul precision "highest") than Pallas:
mean|port - oracle| <= 1.1 * mean|pallas - oracle| + 1e-3. The port
follows the XLA-path numerics (max-subtracted softmax, erf GELU), the
Pallas kernels clamp logits at +/-80 without the max, sum the denominator
through a ones column and use tanh GELU, so the two may differ but the
port must not sit further from f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check

D, H = 128, 2
TOL = 5e-2
KW = dict(img_size=32, patch_size=16, embed_dim=D, depth=2, num_heads=H,
          num_frames=4, num_classes=0)
B, T, HG, WG = 2, 3, 2, 2  # clips, frames, grid rows and columns
N = HG * WG


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """numpy-seeded weights: the JAX pytree (f32, and block 0 in f32 and
    bf16) and the port's bf16 model on the CPU, from the same numbers."""
    jcfg = jtsf.TimeSformerConfig(**KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=11))
    cfg = tsf.TimeSformerConfig(**KW)
    model = tsf.build_timesformer(
        cfg, convert.state_dict_from_jax_params(params, cfg), device="cpu",
        dtype=torch.bfloat16)
    b32 = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    b16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), b32)
    return {"params": params, "jcfg": jcfg, "model": model, "b32": b32,
            "b16": b16, "kp": fb.block_params(model.blocks[0])}


def _bf16(a):
    """f32 numpy -> (bf16 jax array, bf16 torch tensor) with one rounding."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _f32(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


@pytest.mark.parametrize("S,L", [(6, 5), (4, 17)])
def test_attn_phase_twin_matches_pallas(pair, S, L):
    """Row 5: proj(MHSA(LN x)) over (S, L, D) sequences."""
    b32, b16 = pair["b32"], pair["b16"]
    xj, xt = _bf16(np.random.RandomState(L).randn(S, L, D))
    want = _f32(jfb.fused_attn_phase(b16["norm1"], b16["attn"], xj, H))
    got = fb.attn_phase(xt, pair["kp"]["spatial"], H)  # CPU tensor -> twin
    assert got.dtype == torch.bfloat16 and got.shape == (S, L, D)
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.attn_phase(b32["norm1"], b32["attn"],
                                            jnp.asarray(_f32(xj)), H))
    _no_further(got, want, oracle)


@pytest.mark.parametrize("S,L", [(6, 5), (4, 17)])
def test_temporal_phase_twin_matches_pallas(pair, S, L):
    """Row 6: x + fc(proj(MHSA(LN x))) over (S, L, D) sequences."""
    b32, b16 = pair["b32"], pair["b16"]
    xj, xt = _bf16(np.random.RandomState(L + 1).randn(S, L, D))
    want = _f32(jfb.fused_temporal_phase(
        b16["temporal_norm1"], b16["temporal_attn"], b16["temporal_fc"], xj, H))
    got = fb.temporal_phase(xt, pair["kp"]["temporal"], H)
    assert got.dtype == torch.bfloat16 and got.shape == (S, L, D)
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(
            b32["temporal_norm1"], b32["temporal_attn"], b32["temporal_fc"],
            jnp.asarray(_f32(xj)), H))
    _no_further(got, want, oracle)


def _block_inputs(seed):
    r = np.random.RandomState(seed)
    cls = _bf16(r.randn(B, 1, D))
    grid = _bf16(r.randn(B, N * T, D))
    return cls, grid


def _check_block(got, want, oracle):
    for g, w, o in zip(got, want, oracle):
        g, w, o = _f32(g), _f32(w), np.asarray(o)
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
        _no_further(g, w, o)


def test_block_use_fused_matches_jax(pair):
    """Block.forward(use_fused=True) == divided_block(use_fused=True), CLS
    and grid: temporal_phase, attn_phase and the MLP phase (CLS rows and
    grid rows) each through its op."""
    (cj, ct), (gj, gt) = _block_inputs(1)
    want = jtsf.divided_block(pair["b16"], cj, gj, B, T, HG, WG, H,
                              use_fused=True)
    with jax.default_matmul_precision("highest"):
        oracle = jtsf.divided_block(pair["b32"], jnp.asarray(_f32(cj)),
                                    jnp.asarray(_f32(gj)), B, T, HG, WG, H)
    blk = pair["model"].blocks[0]
    got = blk(ct, gt, B, T, N, use_fused=True, kp=pair["kp"])
    assert got[0].shape == (B, 1, D) and got[1].shape == (B, N * T, D)
    _check_block(got, want, oracle)
    # the op route differs from the plain bf16 route it replaces
    plain = blk(ct, gt, B, T, N)
    assert not torch.equal(got[1], plain[1])


def _jax_masks(key, rate):
    """The masks JAX's divided_block draws from ``key``: split(key, 3),
    bernoulli(keep) of shapes (B,1,1), (B*T,1,1), (B,1,1)."""
    r = jax.random.split(key, 3)
    shapes = [(B, 1, 1), (B * T, 1, 1), (B, 1, 1)]
    return tuple(torch.from_numpy(np.asarray(
        jax.random.bernoulli(r[i], 1.0 - rate, s), np.float32).reshape(-1))
        for i, s in enumerate(shapes))


def test_block_drop_path_matches_jax(pair):
    """The drop-path branch (rate 0.3, a Python float, so JAX traces it)
    against divided_block(drop_path_rate=0.3, rng=key, use_fused=True),
    fed JAX's masks; its spatial half runs attn_phase, the rest plain."""
    rate, key = 0.3, jax.random.key(4)
    masks = _jax_masks(key, rate)
    assert all(0 < float(m.sum()) < m.numel() for m in masks)  # mixed
    (cj, ct), (gj, gt) = _block_inputs(2)
    want = jtsf.divided_block(pair["b16"], cj, gj, B, T, HG, WG, H,
                              drop_path_rate=rate, rng=key, use_fused=True)
    with jax.default_matmul_precision("highest"):
        oracle = jtsf.divided_block(pair["b32"], jnp.asarray(_f32(cj)),
                                    jnp.asarray(_f32(gj)), B, T, HG, WG, H,
                                    drop_path_rate=rate, rng=key)
    blk = pair["model"].blocks[0]
    got = blk(ct, gt, B, T, N, use_fused=True, kp=pair["kp"],
              drop_path_rate=rate, masks=masks)
    _check_block(got, want, oracle)
    with pytest.raises(ValueError):
        blk(ct, gt, B, T, N, drop_path_rate=rate)


def test_drop_path_masks_shapes_and_rate():
    g = torch.Generator().manual_seed(0)
    mt, ms, mm = tsf.drop_path_masks(8, 30, 0.25, g)
    assert mt.shape == (8,) and ms.shape == (240,) and mm.shape == (8,)
    allm = torch.cat([mt, ms, mm])
    assert set(allm.tolist()) <= {0.0, 1.0}
    assert 0.6 < float(allm.mean()) < 0.9
    again = tsf.drop_path_masks(8, 30, 0.25, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip((mt, ms, mm), again))


def test_forward_use_fused_matches_jax_fused_forward(pair):
    """The whole bf16 forward with every block on the per-phase ops
    against JAX's bf16 forward with use_fused (its per-phase kernels), and
    no further from the f32 forward than it."""
    params, jcfg = pair["params"], pair["jcfg"]
    x = np.random.RandomState(3).randn(2, 3, 5, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.forward_features(params, jnp.asarray(x), jcfg))
    pallas = _f32(jtsf.forward_features(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(x, jnp.bfloat16), dataclasses.replace(jcfg, use_fused=True),
        compute_dtype=jnp.bfloat16))
    model = pair["model"]
    before = dict(fb.launches)
    with torch.inference_mode():
        cls, grid = model.tokens(torch.from_numpy(x))
        Bx, Tx, Nx, _ = grid.shape
        spat = grid.transpose(1, 2).reshape(Bx, Nx * Tx, D)
        for blk, kp in zip(model.blocks, model.kernel_params()):
            cls, spat = blk(cls, spat, Bx, Tx, Nx, use_fused=True, kp=kp)
        got = _f32(tsf.layer_norm(cls, model.norm.weight, model.norm.bias,
                                  model.cfg.norm_eps)[:, 0])
    assert fb.launches == before  # CPU tensors run the twins
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    _no_further(got, pallas, oracle)


def _bf16_block(Dg, Hg):
    cfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=Dg,
                                depth=1, num_heads=Hg, num_frames=4,
                                num_classes=0)
    sd = convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, jsyn.make_numpy_params(cfg, seed=2)), cfg)
    return tsf.build_timesformer(cfg, sd, device="cpu",
                                 dtype=torch.bfloat16).blocks[0]


@pytest.mark.parametrize("Dg,Hg", [(256, 2), (192, 3)],
                         ids=["head_dim_128", "D_not_128k"])
def test_gate_refuses_and_runs_plain(Dg, Hg):
    """fused_ok, exactly JAX's gate, refuses head dim 128 (JAX's
    MXU-denominator limit) and D % 128 != 0; the phase then runs the plain
    formula, bit-identical to the call without use_fused, as in JAX."""
    blk = _bf16_block(Dg, Hg)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 5, Dg)).to(torch.bfloat16)
    assert not fb.fused_ok(x, Hg)
    kp = fb.block_params(blk)
    with torch.inference_mode():
        got = tsf.attn_phase(blk.norm1, blk.attn, x, Hg, use_fused=True,
                             kp=kp["spatial"])
        want = tsf.attn_phase(blk.norm1, blk.attn, x, Hg)
    assert torch.equal(got, want)
    x768 = torch.zeros(2, 4, 768, dtype=torch.bfloat16)
    assert fb.fused_ok(x768, 12) and not fb.fused_ok(x768, 6)
    assert fb.fused_ok(x768.float(), 12)  # JAX's mixed tier: it raises below
    assert not fb.fused_ok(x768.half(), 12)


@pytest.mark.parametrize("Dg,Hg,L", [(128, 16, 5), (128, 2, 700)],
                         ids=["head_dim_8", "L_past_shared_memory"])
def test_gate_admits_and_the_op_raises(Dg, Hg, L):
    """A bf16 geometry JAX's gate admits but the kernels cannot take (head
    dim 8; 700 rows of attention beyond shared memory) raises in the op,
    as on the card, instead of running the plain formula."""
    blk = _bf16_block(Dg, Hg)
    x = torch.zeros(2, L, Dg, dtype=torch.bfloat16)
    assert fb.fused_ok(x, Hg)
    kp = fb.block_params(blk)
    with pytest.raises(ValueError):
        tsf.attn_phase(blk.norm1, blk.attn, x, Hg, use_fused=True,
                       kp=kp["spatial"])
    with pytest.raises(ValueError):
        tsf.temporal_phase(blk.temporal_norm1, blk.temporal_attn,
                           blk.temporal_fc, x, Hg, use_fused=True,
                           kp=kp["temporal"])


def test_f32_use_fused_raises(pair):
    """The f32 ("mixed") tier that JAX's gate admits is not ported: it
    raises instead of running the plain formula."""
    cfg = tsf.TimeSformerConfig(**KW)
    model = tsf.build_timesformer(cfg, convert.state_dict_from_jax_params(
        pair["params"], cfg), device="cpu")
    blk = model.blocks[0]
    cls, grid = model.tokens(torch.zeros(1, 3, 3, 32, 32))
    _, Tx, Nx, _ = grid.shape
    with pytest.raises(NotImplementedError, match="queue 2 item A3"):
        blk(cls, grid.reshape(1, Tx * Nx, D), 1, Tx, Nx, use_fused=True)
    with pytest.raises(NotImplementedError):
        tsf.mlp_phase_res(blk.norm2, blk.mlp, torch.zeros(2, 1, D),
                          use_fused=True)


def test_wrappers_check_inputs(pair):
    kp = pair["kp"]
    x = torch.zeros(3, 5, D, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fb.attn_phase(x.float(), kp["spatial"], H)
    with pytest.raises(ValueError):
        fb.temporal_phase(x[None], kp["temporal"], H)
    with pytest.raises(ValueError):
        fb.attn_phase(x.transpose(0, 1), kp["spatial"], H)
    with pytest.raises(KeyError):  # the temporal half's keys are ln_w, ...
        fb.attn_phase(x, kp["temporal"], H)
    before = dict(fb.launches)
    fb.temporal_phase(x, kp["temporal"], H)
    assert fb.launches == before


def _uniform_attention(q, k, v):
    """Planted fault: every key weighted alike."""
    return v.float().mean(dim=-2, keepdim=True).expand(v.shape).to(torch.bfloat16)


@pytest.mark.parametrize("op", ["attn_phase", "temporal_phase"])
def test_twin_tolerance_rejects_planted_fault(monkeypatch, pair, op):
    """The kernel-vs-twin bounds (ops/twin_check.py) that chip_smoke.py
    holds rows 5 and 6 to reject a twin with uniform attention: row 5's
    output is the branch itself; row 6's branch is held through its
    f32-out tier as out - x. Row 6's bf16 output, held at ROUNDING_ULPS,
    rejects a twin whose queries attend to themselves only (at D=128 the
    uniform fault moves the branch by 1.5% of its rms, which the f32 tier
    alone is there to see)."""
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 17, D)).to(torch.bfloat16)
    if op == "attn_phase":
        p = pair["kp"]["spatial"]
        sound = fb.attn_phase(x, p, H)
        monkeypatch.setattr(fb, "_attention", _uniform_attention)
        gap = twin_check.twin_gap(fb.attn_phase(x, p, H), sound)
        assert twin_check.twin_failures(gap), gap
        return
    p, x4 = pair["kp"]["temporal"], x.view(4, 17, 1, D)
    sound, sound32 = fb.temporal_phase(x, p, H), fb.temporal_phase_tm(x4, p, H)
    monkeypatch.setattr(fb, "_attention", _uniform_attention)
    gap = twin_check.twin_gap(fb.temporal_phase_tm(x4, p, H), sound32, x4)
    assert twin_check.twin_failures(gap), gap
    monkeypatch.setattr(fb, "_attention", lambda q, k, v: v)
    ulps = twin_check.rounding_ulps(fb.temporal_phase(x, p, H), sound, x)
    assert ulps > twin_check.ROUNDING_ULPS, ulps


@pytest.mark.parametrize("L", [3, 30, 197])
def test_rounding_ulps_bound_holds_for_flipped_roundings(pair, L):
    """The rule for row 6's bf16 output is sound: a branch moved by 2.5e-3
    of its max (the f32-out tier of the kernel reads up to 2.44e-3 on the
    card) before its two bf16 roundings reads at most ROUNDING_ULPS, at
    the sequence lengths of the card checks."""
    x = torch.from_numpy(np.random.RandomState(L).randn(16, L, D)).to(torch.bfloat16)
    x4 = x.view(16, L, 1, D)
    b = fb.temporal_phase_tm(x4, pair["kp"]["temporal"], H).view(x.shape) - x.float()
    noise = torch.from_numpy(np.random.RandomState(L + 1).uniform(
        -1, 1, b.shape)).float() * 2.5e-3 * float(b.abs().max())

    def out(branch):
        return (x.float() + branch.to(torch.bfloat16).float()).to(torch.bfloat16)

    want, got = out(b), out(b + noise)
    assert not torch.equal(got, want)  # some roundings flip
    assert twin_check.rounding_ulps(got, want, x) <= twin_check.ROUNDING_ULPS
