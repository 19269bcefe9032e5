"""The int8 W8A8 tier on the CPU, op by op, against the JAX package's
(``ops/quant.py`` and the int8 refs of the whole-block Pallas kernels).

The port quantizes a reference-layout state dict
(``ops/quant.quantize_state_dict_int8``), builds a quantized model from it
(``QuantLinear`` blocks) and runs rows 1 and 2's int8 tier
(``temporal_phase_tm`` / ``spatial_mlp`` with s8 weights); on the CPU
each wrapper runs its plain twin. JAX runs its Pallas kernels in interpret
mode, as its own tests run them.

Sizes: D = 128 with 2 heads (head dim 64, the kernels' geometry), 4 and 16
positions, T = 3 and 30, depth 2 for the state dict.

Tolerances (fixed before any run):
* weight codes and scales: JAX ``quantize_tree_int8``'s, bit for bit.
* ``int8_linear`` on the same f32 input: within 1e-6 relative of JAX's
  (the same codes; f32 rounding of the rescale).
* rows 1 and 2 and the whole block, int8 twins vs the Pallas int8 tier:
  atol = rtol = 8e-2, JAX's own bound between its q8 kernels and XLA
  (tests/test_quant.py:91-107); and the branch no further from JAX's float
  f32 forward (unquantized weights) than the Pallas int8 output's: mean,
  1.1x + 1e-3. The port follows the XLA numerics (max-subtracted softmax,
  erf GELU, IEEE division by the scale, clipped codes); the Pallas kernel
  clamps logits, uses tanh GELU and multiplies by 1 / sx. Row 1 runs at
  the teacher's and the students' window lengths (T = 30 and 3), row 2
  alone at the teacher's, the whole block at the students'.
* the twins' own arithmetic: the s8 product equal to the integer product
  (exact below 2^53), the row quantization equal to its formula in numpy,
  the LN of ``ln_quant_rows_plain`` within 1e-5 of the f32 LN.
* the workspace mirrors: equal to the layouts the CUDA source declares.
"""

import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu.ops import quant as jquant
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert, timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import quant

D, H = 128, 2
Q8_TOL = 8e-2
bf16 = torch.bfloat16
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dino_video_summarization_transformer_tpu_torch", "ops", "csrc")
KW = dict(img_size=32, patch_size=16, embed_dim=D, num_heads=H, num_frames=4,
          num_classes=0)
# JAX path -> the reference state dict's layer name
DENSE = {("attn", "qkv"): "attn.qkv", ("attn", "proj"): "attn.proj",
         ("temporal_attn", "qkv"): "temporal_attn.qkv",
         ("temporal_attn", "proj"): "temporal_attn.proj",
         ("mlp", "fc1"): "mlp.fc1", ("mlp", "fc2"): "mlp.fc2",
         ("temporal_fc",): "temporal_fc"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0, depth=2):
    cfg = tsf.TimeSformerConfig(depth=depth, **KW)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(
        jtsf.TimeSformerConfig(depth=depth, **KW), seed=seed))
    return cfg, params, convert.state_dict_from_jax_params(params, cfg)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _block(seed=0):
    """Block 0 from one set of numpy-seeded params: JAX's float block, JAX's
    quantized block (``quantize_tree_int8``) and the port's kernel-layout
    weights of its quantized model."""
    cfg, params, sd = _params(seed, depth=1)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    jq = jax.tree.map(lambda a: a[0], jquant.quantize_tree_int8(
        jax.tree.map(jnp.asarray, params))["blocks"])
    model = tsf.build_timesformer(cfg, quant.quantize_state_dict_int8(sd), device="cpu")
    return jp, jq, fb.block_params(model.blocks[0])


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _no_further(port, pallas, oracle):
    e_port = np.abs(port - oracle).mean()
    e_pallas = np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


def _bf16_np(a):
    """numpy f32 rounded to bf16 (the inputs both sides read)."""
    return torch.from_numpy(a).to(bf16).float().numpy()


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def test_state_dict_codes_and_scales_equal_jax_bit_for_bit():
    """``quantize_state_dict_int8`` of the carried-across state dict ==
    JAX ``quantize_tree_int8`` of the same tree: every block's seven dense
    layers' codes (transposed: (out, in) against (in, out)) and scales, bit
    for bit; biases and every other entry untouched."""
    cfg, params, sd = _params(seed=0, depth=2)
    jq = jquant.quantize_tree_int8(jax.tree.map(jnp.asarray, params))
    qsd = quant.quantize_state_dict_int8(sd)
    for i in range(cfg.depth):
        for path, name in DENSE.items():
            p = _get(jq["blocks"], path)
            codes, scale = qsd[f"blocks.{i}.{name}.weight"], qsd[f"blocks.{i}.{name}.qscale"]
            assert codes.dtype == np.int8 and scale.dtype == np.float32
            np.testing.assert_array_equal(codes, np.asarray(p["qkernel"][i]).T)
            np.testing.assert_array_equal(scale.view(np.uint32),
                                          np.asarray(p["qscale"][i]).view(np.uint32))
            assert qsd[f"blocks.{i}.{name}.bias"] is sd[f"blocks.{i}.{name}.bias"]
    extra = {k for k in qsd if k not in sd}
    assert extra == {f"blocks.{i}.{n}.qscale" for i in range(cfg.depth)
                     for n in DENSE.values()}
    for k in sd:
        if not any(k == f"blocks.{i}.{n}.weight" for i in range(cfg.depth)
                   for n in DENSE.values()):
            assert qsd[k] is sd[k], k


def test_quantized_model_holds_codes_and_scales_only():
    """The model built from a quantized state dict: each block's seven dense
    layers are ``QuantLinear`` holding s8 codes and f32 scales and bias (no
    float weight, also under a bf16 build); the patch embedding, norms and
    embeddings stay float in the build's dtype; ``block_params`` hands the
    kernels the codes and scales; an int8 state dict does not load into a
    float model."""
    cfg, params, sd = _params(seed=1, depth=2)
    qsd = quant.quantize_state_dict_int8(sd)
    for dtype in (torch.float32, bf16):
        model = tsf.build_timesformer(cfg, qsd, device="cpu", dtype=dtype)
        assert model.quantized
        for blk in model.blocks:
            for name in quant.BLOCK_DENSE:
                lin = blk.get_submodule(name)
                assert isinstance(lin, tsf.QuantLinear)
                assert lin.weight.dtype == torch.int8
                assert lin.qscale.dtype == lin.bias.dtype == torch.float32
        assert model.patch_embed.proj.weight.dtype == dtype
        assert model.blocks[0].norm1.weight.dtype == dtype
        for k, t in model.state_dict().items():
            if k.endswith(".weight") and t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), qsd[k])
        p = fb.block_params(model.blocks[0])
        assert fb.is_q8(p["temporal"]) and fb.is_q8(p["spatial"])
        for half, keys in (("temporal", fb.TEMPORAL_Q8_KEYS), ("spatial", fb.SPATIAL_Q8_KEYS)):
            assert set(keys) <= set(p[half])
            for k in keys:
                assert p[half][k].dtype == (torch.int8 if k in fb._MATRICES
                                            else torch.float32), k
    plain = tsf.TimeSformer(cfg)
    with pytest.raises(TypeError, match="int8"):
        plain.load_reference_state_dict({**qsd, **{
            k: v for k, v in sd.items() if k not in qsd}})


@pytest.mark.parametrize("shape", [(5, 7, 128), (33, 256)])
def test_int8_linear_matches_jax(shape):
    """The port's ``int8_linear`` == JAX's on the same f32 input and the same
    quantized layer, within 1e-6 relative; with its bias and without."""
    r = np.random.RandomState(len(shape))
    K, F = shape[-1], 96
    kernel = (0.1 * r.randn(K, F)).astype(np.float32)
    bias = (0.01 * r.randn(F)).astype(np.float32)
    x = r.randn(*shape).astype(np.float32)
    jp = jquant.quantize_dense({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    codes, scale = quant.quantize_dense(kernel.T)
    for with_bias in (True, False):
        p = jp if with_bias else {k: v for k, v in jp.items() if k != "bias"}
        want = np.asarray(jquant.int8_linear(p, jnp.asarray(x)))
        got = quant.int8_linear(torch.from_numpy(x), codes, scale,
                                torch.from_numpy(bias) if with_bias else None).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_dequantize_roundtrip_and_zero_channel():
    """Symmetric per-channel codes: |dequant - w| <= amax / 254 per channel;
    an all-zero channel gets the floor scale 1e-12 / 127 and zero codes."""
    w = np.random.RandomState(3).randn(64, 128).astype(np.float32)
    w[5] = 0.0
    codes, scale = quant.quantize_dense(w)
    back = quant.dequantize_dense(codes, scale).numpy()
    amax = np.abs(w).max(axis=1, keepdims=True)
    assert (np.abs(back - w) <= amax / 254 + 1e-7).all()
    assert scale[5] == np.float32(1e-12) / np.float32(127) and not codes[5].any()


def test_quant_rows_twin_is_its_formula():
    """``quant_rows_plain`` on bf16 rows (and the kernel wrapper's CPU
    branch) == numpy's f32 sx = max(amax, 1e-12) / 127, codes = clip(
    round_half_even(x / sx), -127, 127); a zero row has zero codes."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(40, 384).astype(np.float32) * 3).to(bf16)
    x[7] = 0
    q, sx = fb.quant_rows(x)
    q0, sx0 = fb.quant_rows_plain(x)
    assert torch.equal(q, q0) and torch.equal(sx, sx0)
    xf = x.float().numpy()
    want_sx = np.maximum(np.abs(xf).max(axis=1), np.float32(1e-12)) / np.float32(127)
    np.testing.assert_array_equal(sx.numpy(), want_sx)
    want_q = np.clip(np.round(xf / want_sx[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert q.dtype == torch.int8 and not q[7].any()
    with pytest.raises(ValueError, match="D % 128"):
        fb.quant_rows(x[:, :100].contiguous())


def test_ln_quant_rows_twin_is_the_layernorm():
    """``ln_quant_rows_plain`` (the kernel's summation order, step for
    step) on bf16 and f32 rows: its LN within 1e-5 of the f32 LN, its codes
    the row quantization of that LN rounded to bf16, and codes within one
    of those of the f32 LN's bf16 rounding."""
    r = np.random.RandomState(5)
    w = torch.from_numpy(1 + 0.1 * r.randn(D).astype(np.float32))
    b = torch.from_numpy(0.1 * r.randn(D).astype(np.float32))
    for x in (torch.from_numpy(r.randn(64, D).astype(np.float32) + 2.0),
              torch.from_numpy(r.randn(64, D).astype(np.float32)).to(bf16)):
        y = fb._ln_lanes(x.float(), w, b)
        y0 = fb._ln(x.float(), w, b)
        assert float((y - y0).abs().max()) <= 1e-5
        q, sx = fb.ln_quant_rows(x, w, b)
        q1, sx1 = quant.quant_rows(y.to(bf16))
        assert torch.equal(q, q1) and torch.equal(sx, sx1)
        q0, _ = quant.quant_rows(y0.to(bf16))
        assert int((q.int() - q0.int()).abs().max()) <= 1


def test_s8_product_is_exact():
    """The twins' s8 product at K = 3072 with codes at +-127 (the largest
    sums, |sum| = 127^2 K > 2^24) equals the int64 product before the f32
    rounding, and ``gemm_s8``'s CPU branch is the twin."""
    r = np.random.RandomState(6)
    a = torch.from_numpy(r.choice([-127, 127], size=(16, 3072)).astype(np.int8))
    w = torch.from_numpy(r.choice([-127, 127], size=(128, 3072)).astype(np.int8))
    a[0] = 127
    w[0] = 127
    exact = torch.matmul(a.long(), w.long().t())
    assert int(exact[0, 0]) == 127 * 127 * 3072
    got = quant.s8_product(a, w)
    assert torch.equal(got, exact.double().float())
    sx = torch.from_numpy(r.rand(16).astype(np.float32))
    sw = torch.from_numpy(r.rand(128).astype(np.float32))
    bias = torch.from_numpy(r.randn(128).astype(np.float32))
    res = torch.from_numpy(r.randn(16, 128).astype(np.float32))
    for epi in ("bf16", "gelu_bf16", "f32", "res_f32_f32", "res_f32_bf16"):
        rr = res if epi.startswith("res") else None
        out = fb.gemm_s8(a, sx, w, sw, bias, epi, rr)
        assert torch.equal(out, fb.gemm_s8_plain(a, sx, w, sw, bias, epi, rr))
        assert out.dtype == fb.GEMM_EPILOGUES[epi][2]
    want = got * sx[:, None] * sw + bias
    assert torch.equal(fb.gemm_s8(a, sx, w, sw, bias, "f32"), want)
    with pytest.raises(ValueError, match="K % 128"):
        fb.gemm_s8(a[:, :64].contiguous(), sx, w[:, :64].contiguous(), sw, bias, "f32")


# ---------------------------------------------------------------------------
# Rows 1 and 2 and the whole block against the Pallas int8 tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,N", [(3, 16), (30, 4)])
def test_temporal_phase_tm_q8_matches_pallas(T, N):
    """Row 1's int8 tier: bf16 x -> f32 x + fc, against JAX
    ``_fused_temporal_phase_tm_impl(..., out_dtype=f32)`` on the quantized
    block; the branch no further from JAX's f32 temporal phase on the float
    weights than Pallas's."""
    jp, jq, p = _block(seed=T)
    x = _bf16_np(np.random.RandomState(N).randn(2, T, N, D).astype(np.float32))
    want = _np(jfb._fused_temporal_phase_tm_impl(
        jq["temporal_norm1"], jq["temporal_attn"], jq["temporal_fc"],
        jnp.asarray(x, jnp.bfloat16), H, out_dtype=jnp.float32))
    before = dict(fb.launches)
    got = fb.temporal_phase_tm(torch.from_numpy(x).to(bf16), p["temporal"], H)
    assert fb.launches == before  # a CPU tensor: the twin, no launch
    assert got.dtype == torch.float32
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=Q8_TOL, rtol=Q8_TOL)
    xpm = x.transpose(0, 2, 1, 3).reshape(2 * N, T, D)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(
            jp["temporal_norm1"], jp["temporal_attn"], jp["temporal_fc"],
            jnp.asarray(xpm), H)).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    _no_further(got - x, want - x, oracle - x)


@pytest.mark.parametrize("T,N", [(30, 4)])
def test_spatial_mlp_q8_matches_pallas(T, N):
    """Row 2's int8 tier: the f32 carry and a bf16 CLS row -> (bf16 grid, f32
    per-frame CLS rows), against JAX ``_fused_spatial_mlp_impl`` on the
    quantized block; each no further from JAX's f32 spatial phase and MLP
    on the float weights than Pallas's."""
    jp, jq, p = _block(seed=T + 1)
    r = np.random.RandomState(N + 1)
    x1 = r.randn(2, T, N, D).astype(np.float32)
    cls = _bf16_np(r.randn(2, 1, D).astype(np.float32))
    want_g, want_c = jfb._fused_spatial_mlp_impl(
        jq["norm1"], jq["attn"], jq["norm2"], jq["mlp"],
        jnp.asarray(cls, jnp.bfloat16), jnp.asarray(x1), H)
    got_g, got_c = fb.spatial_mlp(torch.from_numpy(x1), torch.from_numpy(cls).to(bf16),
                                  p["spatial"], H)
    assert got_g.dtype == bf16 and got_c.dtype == torch.float32
    got_g, got_c, want_g, want_c = _np(got_g), _np(got_c), _np(want_g), _np(want_c)
    np.testing.assert_allclose(got_g, want_g, atol=Q8_TOL, rtol=Q8_TOL)
    np.testing.assert_allclose(got_c, want_c, atol=Q8_TOL, rtol=Q8_TOL)
    seq = np.concatenate([np.broadcast_to(cls[:, None], (2, T, 1, D)), x1], axis=2)
    with jax.default_matmul_precision("highest"):
        res = np.asarray(jtsf.attn_phase(jp["norm1"], jp["attn"],
                                         jnp.asarray(seq.reshape(2 * T, N + 1, D)), H))
        res = res.reshape(2, T, N + 1, D)
        x2 = x1 + res[:, :, 1:]
        oracle_g = np.asarray(jtsf.mlp_phase_res(jp["norm2"], jp["mlp"], jnp.asarray(x2)))
    _no_further(got_g - x1, want_g - x1, oracle_g - x1)
    _no_further(got_c, want_c, res[:, :, 0])


@pytest.mark.parametrize("T,N", [(3, 16)])
def test_divided_block_wb_q8_matches_pallas_and_oracle(T, N):
    """The whole block on the quantized weights (JAX
    ``fused_divided_block_wb`` on the quantized block, bf16 boundaries):
    the CLS row through JAX's int8 CLS-row math, both outputs bf16, within
    the bound of JAX's and no further from the f32 XLA block on the float
    weights."""
    jp, jq, p = _block(seed=T + 2)
    r = np.random.RandomState(N + 2)
    cls = _bf16_np(r.randn(2, 1, D).astype(np.float32))
    grid = _bf16_np(r.randn(2, T, N, D).astype(np.float32))
    want_c, want_g = jfb.fused_divided_block_wb(jq, jnp.asarray(cls, jnp.bfloat16),
                                                jnp.asarray(grid, jnp.bfloat16), H)
    got_c, got_g = fb.divided_block_wb(p, torch.from_numpy(cls).to(bf16),
                                       torch.from_numpy(grid).to(bf16), H)
    assert got_c.dtype == got_g.dtype == bf16
    flat = grid.transpose(0, 2, 1, 3).reshape(2, N * T, D)
    with jax.default_matmul_precision("highest"):
        oc, og = jtsf.divided_block(jp, jnp.asarray(cls), jnp.asarray(flat),
                                    2, T, 1, N, H)
    og = np.asarray(og).reshape(2, N, T, D).transpose(0, 2, 1, 3)
    for got, want, oracle, x in [(got_c, want_c, np.asarray(oc), cls),
                                 (got_g, want_g, og, grid)]:
        got, want = _np(got), _np(want)
        np.testing.assert_allclose(got, want, atol=Q8_TOL, rtol=Q8_TOL)
        _no_further(got - x, want - x, oracle - x)


def test_q8_tier_refuses_what_it_does_not_take():
    """The int8 tier writes the f32 carry (row 1) from bf16 or f32 x, and
    takes a bf16 or an f32 CLS row (row 2; an f32 one writes an f32 grid:
    rows 1qf and 2qf, tests/test_torch_int8_mixed.py); a bf16 carry out,
    mixed float and s8 weights, and a geometry the kernels refuse, raise on
    the CPU as on the card."""
    _, _, p = _block(seed=9)
    x = torch.zeros(1, 3, 4, D)
    assert fb.temporal_phase_tm(x, p["temporal"], H).dtype == torch.float32
    with pytest.raises(TypeError, match="int8 tier"):
        fb.temporal_phase_tm(x.to(bf16), p["temporal"], H, out_dtype=bf16)
    grid, cls_rows = fb.spatial_mlp(x, torch.zeros(1, 1, D), p["spatial"], H)
    assert grid.dtype == cls_rows.dtype == torch.float32
    mixed = {**p["temporal"], "proj_w": p["temporal"]["proj_w"].to(bf16)}
    with pytest.raises(TypeError, match="proj_w"):
        fb.temporal_phase_tm(x.to(bf16), mixed, H)
    with pytest.raises(TypeError, match="qkv_w"):  # the per-phase ops are float-only
        fb.temporal_phase(x.to(bf16).reshape(3, 4, D), p["temporal"], H)
    with pytest.raises(ValueError, match="head dim"):
        fb.temporal_phase_tm(x.to(bf16), p["temporal"], 16)


def test_q8_workspace_mirrors_are_the_sources_layouts():
    """The int8 tier's workspace mirrors == the layouts fused_block.cu
    carves (each buffer from a 256-byte boundary, in this order)."""
    with open(os.path.join(CSRC, "fused_block.cu")) as f:
        src = f.read()
    for block in [
            ["TemporalQ8Ws temporal_q8_ws(", "w.q = c.take<int8_t>(M * D);",
             "w.sx = c.take<float>(M);", "w.qkv = c.take<bf16>(M * 3 * D);",
             "w.a = c.take<bf16>(M * D);"],
            ["SpatialMlpQ8Ws spatial_mlp_q8_ws(", "w.q = c.take<int8_t>(M * (Dh > D ? Dh : D));",
             "w.sx = c.take<float>(M);", "w.qkv = c.take<bf16>(M * 3 * D);",
             "w.a = c.take<bf16>(M * D);", "w.hid = c.take<bf16>(M * Dh);",
             "w.q_cls = c.take<int8_t>((long)B * T * D);",
             "w.sx_cls = c.take<float>((long)B * T);",
             "w.qkv_cls = c.take<bf16>((long)B * 3 * D);",
             "w.a_cls = c.take<bf16>((long)B * T * D);", "w.x2 = c.take<float>(M * D);"]]:
        at = src.index(block[0])
        for line in block[1:]:
            at = src.index(line, at)

    def up(n):
        return -(-n // 256) * 256

    for B, T, N, Dm, Dh in [(8, 30, 196, 768, 3072), (8, 3, 196, 768, 3072),
                            (2, 3, 5, 128, 512), (1, 1, 1, 128, 128)]:
        M = B * T * N
        parts = [M * Dm, M * 4, M * 3 * Dm * 2, M * Dm * 2]
        assert fb.temporal_phase_tm_q8_ws(B, T, N, Dm) == sum(map(up, parts[:-1])) + parts[-1]
        parts = [M * max(Dm, Dh), M * 4, M * 3 * Dm * 2, M * Dm * 2, M * Dh * 2,
                 B * T * Dm, B * T * 4, B * 3 * Dm * 2, B * T * Dm * 2, M * Dm * 4]
        assert fb.spatial_mlp_q8_ws(B, T, N, Dm, Dh) == sum(map(up, parts[:-1])) + parts[-1]
