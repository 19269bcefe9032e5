"""The per-phase training ops of the port (forward twins, backward twins,
autograd Functions) against the JAX package's Pallas kernels in interpret
mode and their custom VJPs, at the JAX kernel tests' sizes
(``tests/test_fused_block.py:102-167``: B=2, T=4-5, N=6, H=2) at D=128,
the smallest width the port's wrappers take.

Tolerances:
* twin forward vs Pallas forward: atol = rtol = 5e-2, and mean|port -
  f32 oracle| <= 1.1 x mean|Pallas - oracle| + 1e-3 (the port follows the
  XLA-path numerics, the Pallas kernels clamp logits and use tanh GELU);
* twin backward vs the Pallas custom VJP, and vs ``torch.autograd.grad``
  through the plain f32 phase: per leaf max|diff| / max|reference| < 2e-2
  (the JAX package's ``_grad_compare`` bound);
* the autograd Functions' gradients equal the twin backward's exactly on
  the CPU (the Function runs the twin there);
* the kernel-vs-twin bound (``ops/twin_check.py``, which the card runs
  hold the backward kernels to) rejects planted backward faults.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check

D, H, Dh = 128, 2, 512
TOL = 5e-2
GRAD_TOL = 2e-2
GEOMS = [(4, 6), (5, 6)]  # (T, N)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lin(r, fi, fo, std=0.1):
    return {"kernel": np.asarray(r.randn(fi, fo) * std, np.float32),
            "bias": np.asarray(r.randn(fo) * 0.02, np.float32)}


def _ln(r):
    return {"scale": np.asarray(1 + 0.1 * r.randn(D), np.float32),
            "bias": np.asarray(0.05 * r.randn(D), np.float32)}


def _params(seed):
    """JAX-layout phase params (numpy, f32) with weights of std 0.1, so the
    attention is far from uniform; the port's masters from the same
    numbers."""
    r = np.random.RandomState(seed)
    return {"norm": _ln(r), "attn": {"qkv": _lin(r, D, 3 * D),
                                     "proj": _lin(r, D, D)},
            "fc": _lin(r, D, D), "mlp": {"fc1": _lin(r, D, Dh),
                                         "fc2": _lin(r, Dh, D)}}


def _masters(jp, op):
    """op's f32 master tensors in the Function's key order."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ln = [t(jp["norm"]["scale"]), t(jp["norm"]["bias"])]
    lin = lambda p: [t(p["kernel"].T), t(p["bias"])]  # noqa: E731
    if op == "temporal":
        return ln + lin(jp["attn"]["qkv"]) + lin(jp["attn"]["proj"]) + lin(jp["fc"])
    if op == "spatial":
        return ln + lin(jp["attn"]["qkv"]) + lin(jp["attn"]["proj"])
    return ln + lin(jp["mlp"]["fc1"]) + lin(jp["mlp"]["fc2"])


KEYS = {"temporal": fb.TEMPORAL_KEYS, "spatial": fb.SPATIAL_PHASE_KEYS,
        "mlp": fb.MLP_KEYS}


def _kp(jp, op):
    return fb.kernel_weights(_masters(jp, op), KEYS[op])


def _jax_tree(jp, op):
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    if op == "temporal":
        return (j(jp["norm"]), j(jp["attn"]), j(jp["fc"]))
    if op == "spatial":
        return (j(jp["norm"]), j(jp["attn"]))
    return (j(jp["norm"]), j(jp["mlp"]))


def _jax_grads_to_port(op, gtree):
    """JAX gradient pytree -> {port key: (out, in) f32 array}."""
    n = gtree[0]
    out = {KEYS[op][0]: n["scale"], KEYS[op][1]: n["bias"]}
    if op == "mlp":
        lins = [gtree[1]["fc1"], gtree[1]["fc2"]]
    else:
        lins = [gtree[1]["qkv"], gtree[1]["proj"]] + ([gtree[2]] if op == "temporal" else [])
    for k, p in zip(KEYS[op][2::2], lins):
        out[k] = np.asarray(p["kernel"]).T
    for k, p in zip(KEYS[op][3::2], lins):
        out[k] = np.asarray(p["bias"])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _bf16(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _inputs(op, T, N, seed):
    r = np.random.RandomState(seed)
    if op == "mlp":  # 2*T*N + 1 rows: ragged against every block size
        M = 2 * T * N + 1
        return {"x": _bf16(r.randn(M, D)), "do": _bf16(r.randn(M, D))}
    return {"x": _bf16(r.randn(2, T, N, D)), "cls": _bf16(r.randn(2, 1, D)),
            "dout": _bf16(r.randn(2, T, N, D)), "dco": _bf16(r.randn(2, T, D))}


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,N", GEOMS)
def test_temporal_bf16_tier_twin_matches_pallas(T, N):
    jp = _params(T)
    inp = _inputs("temporal", T, N, N)
    xj, xt = inp["x"]
    pn, pa, pfc = _jax_tree(jp, "temporal")
    want = _np(jfb._fused_temporal_phase_tm_impl(pn, pa, pfc, xj, H))
    got = fb.temporal_phase_tm(xt, _kp(jp, "temporal"), H, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    xpm = _np(xj).transpose(0, 2, 1, 3).reshape(2 * N, T, D)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jtsf.temporal_phase(pn, pa, pfc, jnp.asarray(xpm), H))
    oracle = oracle.reshape(2, N, T, D).transpose(0, 2, 1, 3)
    e_port, e_pallas = np.abs(got - oracle).mean(), np.abs(want - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


def _xla_spatial(pn, pa, cls, x, B, T, N):
    xs = x.reshape(B * T, N, D)
    cls_rep = jnp.broadcast_to(cls, (B, T, D)).reshape(B * T, 1, D)
    res = jtsf.attn_phase(pn, pa, jnp.concatenate([cls_rep, xs], axis=1), H)
    return x + res[:, 1:, :].reshape(B, T, N, D), res[:, 0, :].reshape(B, T, D)


@pytest.mark.parametrize("T,N", GEOMS)
def test_spatial_phase_twin_matches_pallas(T, N):
    jp = _params(T + 1)
    inp = _inputs("spatial", T, N, N + 1)
    (xj, xt), (cj, ct) = inp["x"], inp["cls"]
    pn, pa = _jax_tree(jp, "spatial")
    want_g, want_c = jfb._fused_spatial_phase_impl(pn, pa, cj, xj, H)
    got_g, got_c = fb.spatial_phase(xt, ct, _kp(jp, "spatial"), H)
    assert got_g.dtype == got_c.dtype == torch.bfloat16
    with jax.default_matmul_precision("highest"):
        og, oc = _xla_spatial(pn, pa, jnp.asarray(_np(cj)), jnp.asarray(_np(xj)),
                              2, T, N)
    for got, want, oracle in [(got_g, want_g, og), (got_c, want_c, oc)]:
        got, want, oracle = _np(got), _np(want), np.asarray(oracle)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        e_port, e_pallas = np.abs(got - oracle).mean(), np.abs(want - oracle).mean()
        assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


# ---------------------------------------------------------------------------
# backwards
# ---------------------------------------------------------------------------

def _port_bwd(op, jp, inp, residual=True):
    """The twin backward: (dx, [dcls], grads)."""
    kp = _kp(jp, op)
    if op == "temporal":
        dx, g = fb.temporal_phase_tm_bwd(inp["x"][1], inp["dout"][1], kp, H)
        return {"x": dx}, g
    if op == "spatial":
        dx, dcls, g = fb.spatial_phase_bwd(inp["x"][1], inp["cls"][1],
                                           inp["dout"][1], inp["dco"][1], kp, H)
        return {"x": dx, "cls": dcls}, g
    dx, g = fb.mlp_phase_bwd(inp["x"][1], inp["do"][1], kp, residual)
    return {"x": dx}, g


def _pallas_vjp(op, jp, inp, residual=True):
    tree = _jax_tree(jp, op)
    if op == "temporal":
        _, f = jax.vjp(lambda a, b, c, x: jfb.fused_temporal_phase_tm(
            a, b, c, x, H, block_n=2), *tree, inp["x"][0])
        *g, dx = f(inp["dout"][0])
        return {"x": dx}, _jax_grads_to_port(op, g)
    if op == "spatial":
        _, f = jax.vjp(lambda a, b, c, x: jfb.fused_spatial_phase(
            a, b, c, x, H, block_f=2), *tree, inp["cls"][0], inp["x"][0])
        ga, gb, dcls, dx = f((inp["dout"][0], inp["dco"][0]))
        return {"x": dx, "cls": dcls}, _jax_grads_to_port(op, (ga, gb))
    _, f = jax.vjp(lambda a, b, x: jfb.fused_mlp_phase(
        a, b, x, block_m=8, residual=residual), *tree, inp["x"][0])
    ga, gb, dx = f(inp["do"][0])
    return {"x": dx}, _jax_grads_to_port(op, (ga, gb))


OPS = [("temporal", True), ("spatial", True), ("mlp", True), ("mlp", False)]
OP_IDS = ["temporal", "spatial", "mlp_res", "mlp"]


@pytest.mark.parametrize("op,residual", OPS, ids=OP_IDS)
@pytest.mark.parametrize("T,N", GEOMS)
def test_backward_twin_matches_pallas_vjp(op, residual, T, N):
    jp = _params(2 * T + 1)
    inp = _inputs(op, T, N, 3 * N + T)
    got_in, got = _port_bwd(op, jp, inp, residual)
    want_in, want = _pallas_vjp(op, jp, inp, residual)
    for k in want_in:
        assert _rel(got_in[k], want_in[k]) < GRAD_TOL, (k, _rel(got_in[k], want_in[k]))
    for k in KEYS[op]:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel(got[k], want[k]) < GRAD_TOL, (k, _rel(got[k], want[k]))


def _f32_phase(op, masters, xs, residual=True):
    """The plain f32 phase (no bf16 rounding) for autograd."""
    p = dict(zip(KEYS[op], masters))
    hd = D // H
    if op == "mlp":
        x = xs[0]
        y = fb._ln(x, p["ln2_w"], p["ln2_b"])
        out = F.gelu(y @ p["fc1_w"].t() + p["fc1_b"]) @ p["fc2_w"].t() + p["fc2_b"]
        return (x + out,) if residual else (out,)
    if op == "temporal":
        x = xs[0]
        B, T, N, _ = x.shape
        y = fb._ln(x, p["ln_w"], p["ln_b"])
        q, k, v = (y @ p["qkv_w"].t() + p["qkv_b"]).reshape(
            B, T, N, 3, H, hd).permute(3, 0, 2, 4, 1, 5).unbind(0)
        a = torch.softmax(q @ k.transpose(-2, -1) * hd ** -0.5, -1) @ v
        a = a.permute(0, 3, 1, 2, 4).reshape(B, T, N, D)
        return (x + (a @ p["proj_w"].t() + p["proj_b"]) @ p["fc_w"].t() + p["fc_b"],)
    x, cls = xs
    B, T, N, _ = x.shape
    L = N + 1
    seq = torch.cat([cls.reshape(B, 1, 1, D).expand(B, T, 1, D), x], 2)
    y = fb._ln(seq, p["ln1_w"], p["ln1_b"])
    q, k, v = (y @ p["qkv_w"].t() + p["qkv_b"]).reshape(
        B, T, L, 3, H, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)
    a = (torch.softmax(q @ k.transpose(-2, -1) * hd ** -0.5, -1) @ v).transpose(
        2, 3).reshape(B, T, L, D)
    res = a @ p["proj_w"].t() + p["proj_b"]
    return x + res[:, :, 1:], res[:, :, 0]


def _cotangents(op, inp):
    if op == "mlp":
        return [inp["do"][1].float()]
    if op == "temporal":
        return [inp["dout"][1].float()]
    return [inp["dout"][1].float(), inp["dco"][1].float()]


@pytest.mark.parametrize("op,residual", OPS, ids=OP_IDS)
def test_backward_twin_matches_f32_autograd(op, residual):
    T, N = GEOMS[0]
    jp = _params(17)
    inp = _inputs(op, T, N, 19)
    got_in, got = _port_bwd(op, jp, inp, residual)
    masters = [m.clone().requires_grad_() for m in _masters(jp, op)]
    xs = [inp["x"][1].float().requires_grad_()]
    if op == "spatial":
        xs.append(inp["cls"][1].float().requires_grad_())
    outs = _f32_phase(op, masters, xs, residual)
    loss = sum((o * c).sum() for o, c in zip(outs, _cotangents(op, inp)))
    want = torch.autograd.grad(loss, masters + xs)
    for k, w in zip(KEYS[op], want):
        assert _rel(got[k], w) < GRAD_TOL, (k, _rel(got[k], w))
    for k, w in zip(["x", "cls"], want[len(masters):]):
        assert _rel(got_in[k], w) < GRAD_TOL, (k, _rel(got_in[k], w))


@pytest.mark.parametrize("op,residual", OPS, ids=OP_IDS)
def test_function_grads_equal_twin_backward(op, residual):
    """The autograd Function runs the twin backward on CPU tensors: its
    gradients (through autograd, with the f32 master cast) are the twin's
    exactly, and the forward is the twin forward."""
    T, N = GEOMS[1]
    jp = _params(23)
    inp = _inputs(op, T, N, 29)
    masters = [m.clone().requires_grad_() for m in _masters(jp, op)]
    x = inp["x"][1].clone().requires_grad_()
    if op == "temporal":
        out = fb.TemporalPhaseTm.apply(x, H, *masters)
        assert torch.equal(out, fb.temporal_phase_tm_plain(
            inp["x"][1], _kp(jp, op), H, torch.bfloat16))
        outs, cots, ins = [out], [inp["dout"][1]], [x]
    elif op == "spatial":
        cls = inp["cls"][1].clone().requires_grad_()
        outs = list(fb.SpatialPhase.apply(x, cls, H, *masters))
        cots, ins = [inp["dout"][1], inp["dco"][1]], [x, cls]
    else:
        outs = [fb.MlpPhase.apply(x, residual, *masters)]
        cots, ins = [inp["do"][1]], [x]
    grads = torch.autograd.grad(outs, ins + masters, cots)
    want_in, want = _port_bwd(op, jp, inp, residual)
    for k, g in zip(["x", "cls"], grads[:len(ins)]):
        assert g.dtype == inp[k][1].dtype
        assert torch.equal(g, want_in[k].to(g.dtype)), k
    for k, g, m in zip(KEYS[op], grads[len(ins):], masters):
        assert g.dtype == torch.float32 and g.shape == m.shape
        assert torch.equal(g, want[k]), k


# ---------------------------------------------------------------------------
# the kernel-vs-twin bound rejects planted backward faults
# ---------------------------------------------------------------------------

def _no_rowsum(q, k, v, da):
    """Planted fault: ds = p * dp, the rowsum(dp * p) term dropped."""
    scale = q.shape[-1] ** -0.5
    pf = fb._attention_probs(q, k).float()
    daf = da.float()
    dv = torch.matmul(pf.transpose(-2, -1), daf).to(torch.bfloat16)
    ds = (pf * torch.matmul(daf, v.float().transpose(-2, -1)) * scale).to(
        torch.bfloat16).float()
    return (torch.matmul(ds, k.float()).to(torch.bfloat16),
            torch.matmul(ds.transpose(-2, -1), q.float()).to(torch.bfloat16), dv)


def _dw_transposed(dy, x, dw=fb._dw):
    """Planted fault: square weight gradients transposed."""
    w = dw(dy, x)
    return w.t() if w.shape[0] == w.shape[1] else w


def _first_frame(t):
    """Planted fault: the CLS row's gradient taken from frame 0 only."""
    return t[:, :1, :]


FAULTS = [("_attention_bwd", _no_rowsum, "temporal", ["qkv_w", "ln_w", "x"]),
          ("_attention_bwd", _no_rowsum, "spatial", ["qkv_w", "ln1_w", "x", "cls"]),
          ("_dw", _dw_transposed, "temporal", ["proj_w", "fc_w"]),
          ("_dw", _dw_transposed, "spatial", ["proj_w"]),
          ("_sum_frames", _first_frame, "spatial", ["cls"])]


@pytest.mark.parametrize("attr,fault,op,hit", FAULTS,
                         ids=["no_rowsum-temporal", "no_rowsum-spatial",
                              "dw_t-temporal", "dw_t-spatial",
                              "dcls_frame0-spatial"])
def test_twin_bound_rejects_planted_backward_fault(monkeypatch, attr, fault, op,
                                                   hit):
    """Each fault, planted in the twin, breaks the bound the card runs hold
    the backward kernels to (per gradient: rms <= 1e-2 x rms, f32 max <=
    2e-2 x max; dx bf16 within 4 ulps of its branch) on every output it
    reaches."""
    T, N = GEOMS[0]
    jp = _params(31)
    inp = _inputs(op, T, N, 37)
    sound_in, sound = _port_bwd(op, jp, inp)
    monkeypatch.setattr(fb, attr, fault)
    bad_in, bad = _port_bwd(op, jp, inp)
    base = {"x": inp["dout"][1], "cls": None}
    for k in hit:
        if k in ("x", "cls"):
            gap = twin_check.twin_gap(bad_in[k], sound_in[k], base[k])
        else:
            gap = twin_check.twin_gap(bad[k], sound[k])
        assert twin_check.twin_failures(gap), (k, gap)
