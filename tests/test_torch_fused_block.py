"""The plain twins of the port's Hopper kernels against the JAX package's
Pallas kernels, run as ``tests/test_fused_block.py`` runs them (interpret
mode on the CPU), on the same weights and inputs.

Tolerances:
* port twin vs Pallas kernel: atol = rtol = 5e-2, the JAX kernel tests'
  own bound for bf16 kernels.
* against the f32 oracle (the JAX XLA divided block / temporal phase in
  f32): mean|port - oracle| <= 1.1 * mean|pallas - oracle| + 1e-3. The
  port follows the XLA-path numerics (max-subtracted softmax, erf GELU);
  the Pallas kernels clamp logits at +/-80 without the max, sum the
  denominator through a ones column and use tanh GELU, so the port may
  differ from them but must be no further from f32.

The kernel-vs-twin bound that the card runs use (``ops/twin_check.py``) is
checked here too: it must reject a twin with a planted attention fault.
"""

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
GEOMS = [(3, 4), (5, 16)]  # (T, N): the two window kinds at two grid sizes


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
    kernel-layout dict, from the same numbers."""
    cfg = jtsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=D,
                                 depth=1, num_heads=H, num_frames=4,
                                 num_classes=0)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(cfg, seed=seed))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    pcfg = tsf.TimeSformerConfig(img_size=32, patch_size=16, embed_dim=D,
                                 depth=1, num_heads=H, num_frames=4,
                                 num_classes=0)
    model = tsf.build_timesformer(
        pcfg, convert.state_dict_from_jax_params(params, pcfg), device="cpu")
    return jp, fb.block_params(model.blocks[0])


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


@pytest.mark.parametrize("T,N", GEOMS)
def test_temporal_phase_tm_twin_matches_pallas(T, N):
    jp, p = _block(seed=T)
    xj, xt = _bf16(np.random.RandomState(N).randn(2, T, N, D))
    want = _f32(jfb._fused_temporal_phase_tm_impl(
        jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"], xj, H,
        out_dtype=jnp.float32))
    got = fb.temporal_phase_tm(xt, p["temporal"], H)  # CPU tensor -> twin
    assert got.dtype == torch.float32
    got = _f32(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # f32 oracle: the XLA temporal phase on the position-major layout
    xpm = _f32(xj).transpose(0, 2, 1, 3).reshape(2 * N, T, D)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(
            jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
            jnp.asarray(xpm), H))
    oracle = oracle.reshape(2, N, T, D).transpose(0, 2, 1, 3)
    _no_further(got, want, oracle)


@pytest.mark.parametrize("T,N", GEOMS)
def test_spatial_mlp_twin_matches_pallas(T, N):
    jp, p = _block(seed=T + 1)
    r = np.random.RandomState(N + 1)
    x1 = r.randn(2, T, N, D).astype(np.float32)
    clsj, clst = _bf16(r.randn(2, 1, D))
    want_g, want_c = jfb._fused_spatial_mlp_impl(
        jp["norm1"], jp["attn"], jp["norm2"], jp["mlp"], clsj, jnp.asarray(x1),
        H)
    got_g, got_c = fb.spatial_mlp(torch.from_numpy(x1), clst, p["spatial"], H)
    assert got_g.dtype == torch.bfloat16 and got_c.dtype == torch.float32
    np.testing.assert_allclose(_f32(got_g), _f32(want_g), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_f32(got_c), _f32(want_c), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,N", GEOMS)
def test_divided_block_wb_matches_pallas_and_oracle(T, N):
    jp, p = _block(seed=T + 2)
    r = np.random.RandomState(N + 2)
    clsj, clst = _bf16(r.randn(2, 1, D))
    gj, gt = _bf16(r.randn(2, T, N, D))
    want_c, want_g = jfb.fused_divided_block_wb(jp, clsj, gj, H)
    got_c, got_g = fb.divided_block_wb(p, clst, gt, H)
    assert got_c.dtype == got_g.dtype == torch.bfloat16
    # f32 oracle: the XLA divided block on the flat (B, N*T, D) layout
    grid_flat = _f32(gj).transpose(0, 2, 1, 3).reshape(2, N * T, D)
    with jax.default_matmul_precision("highest"):
        oc, og = jtsf.divided_block(jp, jnp.asarray(_f32(clsj)),
                                    jnp.asarray(grid_flat), 2, T, 1, N, H)
    og = np.asarray(og).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    for got, want, oracle in [(got_c, want_c, np.asarray(oc)),
                              (got_g, want_g, og)]:
        got, want = _f32(got), _f32(want)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        _no_further(got, want, oracle)


@pytest.mark.parametrize("T", [3, 8])
def test_kernel_route_forward_matches_pallas_forward(T):
    """Whole bf16 forwards at depth 2: the port's kernel route (twins on
    CPU tensors) against JAX's fused_wb forward, and no further from the
    f32 forward than it."""
    import dataclasses

    kw = dict(img_size=64, patch_size=16, embed_dim=D, depth=2, num_heads=H,
              num_frames=4, num_classes=0)
    jcfg = jtsf.TimeSformerConfig(**kw)
    params = jsyn.make_numpy_params(jcfg, seed=T)
    x = np.random.RandomState(T).randn(4, 3, T, 64, 64).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.forward_features(params, jnp.asarray(x), jcfg))
    pallas = _f32(jtsf.forward_features(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), params),
        jnp.asarray(x, jnp.bfloat16),
        dataclasses.replace(jcfg, use_fused=True, fused_wb=True),
        compute_dtype=jnp.bfloat16))
    cfg = tsf.TimeSformerConfig(use_kernels=True, **kw)
    model = tsf.build_timesformer(
        cfg, convert.state_dict_from_jax_params(
            jax.tree.map(np.asarray, params), cfg),
        device="cpu", dtype=torch.bfloat16)
    with torch.inference_mode():
        got = _f32(model(torch.from_numpy(x)))
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    _no_further(got, pallas, oracle)


def test_wrapper_checks_inputs_on_cpu():
    """The wrapper validates what the kernel would take, on any device: f32
    rows are the mixed tier, which writes f32 only; f16 is no tier."""
    _, p = _block()
    x = torch.zeros(1, 3, 4, D, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fb.temporal_phase_tm(x.float(), p["temporal"], H, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fb.temporal_phase_tm(x.half(), p["temporal"], H)
    with pytest.raises(ValueError):
        fb.temporal_phase_tm(x[:, :, :, :96].contiguous(), p["temporal"], H)
    with pytest.raises(ValueError):  # head dim 128 / 3 is not a multiple of 16
        fb.temporal_phase_tm(x, p["temporal"], 3)
    with pytest.raises(ValueError):
        fb.temporal_phase_tm(x.transpose(1, 2), p["temporal"], H)
    before = dict(fb.launches)
    fb.temporal_phase_tm(x, p["temporal"], H)
    assert fb.launches == before  # the twin is not a launch


def _uniform_attention(q, k, v):
    """Planted fault: every key weighted alike."""
    return v.float().mean(dim=-2, keepdim=True).expand(v.shape).to(torch.bfloat16)


def _unscaled_attention(q, k, v, attention=fb._attention):
    """Planted fault: the 1/sqrt(hd) logit scale left out."""
    return attention(q * q.shape[-1] ** 0.5, k, v)


@pytest.mark.parametrize("fault", [_uniform_attention, _unscaled_attention],
                         ids=["uniform", "unscaled"])
@pytest.mark.parametrize("op", ["temporal", "spatial"])
def test_twin_tolerance_rejects_planted_fault(monkeypatch, op, fault):
    """The kernel-vs-twin tolerance (ops/twin_check.py, which chip_smoke.py
    and the card tests hold the kernels to) rejects a twin whose attention
    is wrong, on the numpy-seeded weights the card runs use: every output
    that passes through the attention breaks it."""
    _, p = _block(seed=7)
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.randn(2, 5, 16, D)).to(torch.bfloat16)
    x1 = torch.from_numpy(r.randn(2, 5, 16, D).astype(np.float32))
    cls = torch.from_numpy(r.randn(2, 1, D)).to(torch.bfloat16)

    def run():
        if op == "temporal":
            return [(fb.temporal_phase_tm_plain(x, p["temporal"], H), x)]
        g, c = fb.spatial_mlp_plain(x1, cls, p["spatial"], H)
        return [(g, x1), (c, None)]

    sound = run()
    monkeypatch.setattr(fb, "_attention", fault)
    for (got, base), (want, _) in zip(run(), sound):
        gap = twin_check.twin_gap(got, want, base)
        print(op, fault.__name__, {k: round(v, 5) for k, v in gap.items()})
        assert twin_check.twin_failures(gap), gap
