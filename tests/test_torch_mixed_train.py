"""The trainer's mixed tier of the port (f32 activations and carries, bf16
matmul operands: ``make_train_step(route="kernels",
compute_dtype=torch.float32)``) against the JAX package's per-phase Pallas
kernels at f32 (``divided_block_fused`` on a ``use_fused=True`` config), in
interpret mode as the JAX package's own tests run them, at D = 128, H = 2.

The ops' x (and the CLS row) are rows with a large common offset and a
small spread (``twin_check.offset_rows``): there an x rounded to bf16
before a LayerNorm loses ~10 % of its spread, so a twin that rounded its
f32 input would show.

Tolerances (fixed before any run):
* row 4f's twin (``spatial_phase`` on f32 x and CLS row) vs the Pallas
  ``_fused_spatial_phase_impl`` on the same f32 inputs: atol = rtol = 5e-2
  on the grid and the CLS rows, both f32, and mean|port - XLA f32 phase| <=
  1.1 x mean|Pallas - XLA f32 phase| + 1e-3 (``test_torch_train_ops.py``'s
  forward rules);
* rows 7f, 8f and 9f's twins vs ``jax.vjp`` of ``fused_temporal_phase_tm``,
  ``fused_spatial_phase`` and ``fused_mlp_phase(residual=True)`` at f32:
  per leaf max|diff| < 2e-2 x max|JAX| (the port's backward rule), dx f32;
* the mixed train step (twins on the CPU) vs JAX's gradients of the same
  loss on a ``use_fused=True`` config at f32, on ``test_torch_train_step.py``'s
  weights and crops: per leaf max|diff| / max|JAX| < 0.15; the port's mean
  distance to the f32 (``highest``) gradients <= 1.5 x JAX's mixed step's
  + 1e-6; and no further from f32 than the port's own bf16 kernel route;
* the autograd Functions at f32 give the twin backward's gradients exactly
  on the CPU, and the ops refuse mixed dtypes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.ops import twin_check
from dino_video_summarization_transformer_tpu_torch.train import ssl

from test_torch_train_ops import (  # noqa: E402
    D, H, KEYS, _jax_grads_to_port, _jax_tree, _kp, _masters, _np, _params, _rel,
    _xla_spatial)
from test_torch_train_step import (  # noqa: E402
    KW, OUT, _crops, _jax_loss_fn, _jax_student, _port_state, to_port)

TOL = 5e-2
GRAD_TOL = 2e-2
B, T, N = 2, 4, 6
f32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(r, *shape):
    """Offset f32 rows, as numpy (JAX) and torch (port) arrays."""
    a = twin_check.offset_rows(r, shape)
    return jnp.asarray(a), torch.from_numpy(a)


def _cot(r, *shape):
    a = r.randn(*shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(op, seed):
    r = np.random.RandomState(seed)
    if op == "mlp":  # 2*T*N + 1 rows: ragged against the Pallas block size
        M = B * T * N + 1
        return {"x": _rows(r, M, D), "do": _cot(r, M, D)}
    return {"x": _rows(r, B, T, N, D), "cls": _rows(r, B, 1, D),
            "dout": _cot(r, B, T, N, D), "dco": _cot(r, B, T, D)}


# ---------------------------------------------------------------------------
# row 4f
# ---------------------------------------------------------------------------

def test_spatial_phase_f32_twin_matches_pallas():
    jp = _params(41)
    inp = _inputs("spatial", 43)
    (xj, xt), (cj, ct) = inp["x"], inp["cls"]
    pn, pa = _jax_tree(jp, "spatial")
    want_g, want_c = jfb._fused_spatial_phase_impl(pn, pa, cj, xj, H)
    assert want_g.dtype == want_c.dtype == jnp.float32
    got_g, got_c = fb.spatial_phase(xt, ct, _kp(jp, "spatial"), H)
    assert got_g.dtype == got_c.dtype == f32
    with jax.default_matmul_precision("highest"):
        og, oc = _xla_spatial(pn, pa, cj, xj, B, T, N)
    for got, want, oracle in [(got_g, want_g, og), (got_c, want_c, oc)]:
        got, want, oracle = _np(got), _np(want), np.asarray(oracle)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        e_port, e_pallas = np.abs(got - oracle).mean(), np.abs(want - oracle).mean()
        assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


# ---------------------------------------------------------------------------
# rows 7f, 8f, 9f
# ---------------------------------------------------------------------------

def _port_bwd(op, jp, inp):
    kp = _kp(jp, op)
    if op == "temporal":
        dx, g = fb.temporal_phase_tm_bwd(inp["x"][1], inp["dout"][1], kp, H)
        return {"x": dx}, g
    if op == "spatial":
        dx, dcls, g = fb.spatial_phase_bwd(inp["x"][1], inp["cls"][1], inp["dout"][1],
                                           inp["dco"][1], kp, H)
        return {"x": dx, "cls": dcls}, g
    dx, g = fb.mlp_phase_bwd(inp["x"][1], inp["do"][1], kp)
    return {"x": dx}, g


def _pallas_vjp(op, jp, inp):
    tree = _jax_tree(jp, op)
    if op == "temporal":
        _, f = jax.vjp(lambda a, b, c, x: jfb.fused_temporal_phase_tm(
            a, b, c, x, H, block_n=3), *tree, inp["x"][0])
        *g, dx = f(inp["dout"][0])
        return {"x": dx}, _jax_grads_to_port(op, g)
    if op == "spatial":
        _, f = jax.vjp(lambda a, b, c, x: jfb.fused_spatial_phase(
            a, b, c, x, H, block_f=2), *tree, inp["cls"][0], inp["x"][0])
        ga, gb, dcls, dx = f((inp["dout"][0], inp["dco"][0]))
        return {"x": dx, "cls": dcls}, _jax_grads_to_port(op, (ga, gb))
    _, f = jax.vjp(lambda a, b, x: jfb.fused_mlp_phase(
        a, b, x, block_m=16, residual=True), *tree, inp["x"][0])
    ga, gb, dx = f(inp["do"][0])
    return {"x": dx}, _jax_grads_to_port(op, (ga, gb))


@pytest.mark.parametrize("op", ["temporal", "spatial", "mlp"])
def test_backward_f32_twin_matches_pallas_vjp(op):
    jp = _params(47)
    inp = _inputs(op, 53)
    got_in, got = _port_bwd(op, jp, inp)
    want_in, want = _pallas_vjp(op, jp, inp)
    for k in want_in:
        assert got_in[k].dtype == f32 and want_in[k].dtype == jnp.float32, k
        assert _rel(got_in[k], want_in[k]) < GRAD_TOL, (k, _rel(got_in[k], want_in[k]))
    for k in KEYS[op]:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel(got[k], want[k]) < GRAD_TOL, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("op", ["temporal", "spatial", "mlp"])
def test_f32_function_grads_equal_twin_backward(op):
    """The autograd Functions on f32 x run the f32 tiers: forward f32 out
    (row 1f, 4f, 3f), gradients the twin backward's exactly (f32 dx and
    dcls, f32 weight gradients in the masters' layout)."""
    jp = _params(59)
    inp = _inputs(op, 61)
    masters = [m.clone().requires_grad_() for m in _masters(jp, op)]
    x = inp["x"][1].clone().requires_grad_()
    if op == "temporal":
        outs = [fb.TemporalPhaseTm.apply(x, H, *masters)]
        assert torch.equal(outs[0], fb.temporal_phase_tm_plain(inp["x"][1], _kp(jp, op), H))
        cots, ins = [inp["dout"][1]], [x]
    elif op == "spatial":
        cls = inp["cls"][1].clone().requires_grad_()
        outs = list(fb.SpatialPhase.apply(x, cls, H, *masters))
        cots, ins = [inp["dout"][1], inp["dco"][1]], [x, cls]
    else:
        outs = [fb.MlpPhase.apply(x, True, *masters)]
        cots, ins = [inp["do"][1]], [x]
    assert all(o.dtype == f32 for o in outs)
    grads = torch.autograd.grad(outs, ins + masters, cots)
    want_in, want = _port_bwd(op, jp, inp)
    for k, g in zip(["x", "cls"], grads[:len(ins)]):
        assert g.dtype == f32 and torch.equal(g, want_in[k]), k
    for k, g in zip(KEYS[op], grads[len(ins):]):
        assert torch.equal(g, want[k]), k


FAULTS = ["dx_bf16", "db_from_bf16", "ln_bwd_x_bf16", "cls_rows_bf16"]


@pytest.mark.parametrize("fault", FAULTS)
def test_f32_rules_reject_planted_faults(fault):
    """Each f32-tier fault that ``tools/plant_faults.sh`` plants in the
    kernels, planted here in the twins' outputs, breaks the rules the card
    holds the f32 tiers to (``twin_check``): row 7f's dx rounded to bf16 and
    row 4f's CLS rows rounded (``bf16_exact``), row 9f's db2 summed from the
    cotangent's bf16 copy (``sum_rel_max``), the LN backward reading a bf16
    copy of x (the twin rule on dx - res); the sound outputs pass them."""
    jp = _params(73)
    if fault in ("dx_bf16", "db_from_bf16"):
        op = "temporal" if fault == "dx_bf16" else "mlp"
        inp = _inputs(op, 79)
        got_in, got = _port_bwd(op, jp, inp)
        if fault == "dx_bf16":
            sound, bad = got_in["x"], got_in["x"].to(torch.bfloat16).float()
            assert not twin_check.f32_failures(sound) and twin_check.f32_failures(bad)
        else:
            do = inp["do"][1]
            sound = do.double().sum(0).float()  # the same f32 values, another order
            bad = do.to(torch.bfloat16).float().sum(0)
            assert not twin_check.f32_failures(sound, got["fc2_b"])
            assert twin_check.f32_failures(bad, got["fc2_b"])
    elif fault == "ln_bwd_x_bf16":
        r = np.random.RandomState(83)
        x = torch.from_numpy(twin_check.offset_rows(r, (48, D)))
        dy, res = torch.from_numpy(r.randn(48, D).astype(np.float32)), _rows(r, 48, D)[1]
        w = _masters(jp, "mlp")[0]
        sound = fb.layer_norm_bwd_plain(x, dy, w, res)[0]
        bad = fb.layer_norm_bwd_plain(x.to(torch.bfloat16).float(), dy, w, res)[0]
        assert twin_check.twin_failures(twin_check.twin_gap(bad, sound, res))
    else:
        inp = _inputs("spatial", 89)
        _, rows = fb.spatial_phase(inp["x"][1], inp["cls"][1], _kp(jp, "spatial"), H)
        assert not twin_check.f32_failures(rows)
        assert twin_check.f32_failures(rows.to(torch.bfloat16).float())


def test_training_ops_refuse_mixed_dtypes():
    jp = _params(67)
    r = np.random.RandomState(71)
    x32 = torch.from_numpy(r.randn(B, T, N, D).astype(np.float32))
    x16, cls32 = x32.to(torch.bfloat16), x32[:, :1, 0].clone()
    with pytest.raises(TypeError):
        fb.temporal_phase_tm_bwd(x32, x16, _kp(jp, "temporal"), H)
    with pytest.raises(TypeError):
        fb.spatial_phase(x16, cls32, _kp(jp, "spatial"), H)
    with pytest.raises(TypeError):
        fb.spatial_phase(x32, cls32, _kp(jp, "spatial"), H, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fb.mlp_phase_bwd(x32.reshape(-1, D), x16.reshape(-1, D), _kp(jp, "mlp"))
    with pytest.raises(TypeError):
        fb.layer_norm_bwd(x16.reshape(-1, D), x32.reshape(-1, D), torch.ones(D),
                          x32.reshape(-1, D))


def test_explicit_kernel_route_admits_f32_on_the_gate():
    """``"auto"`` stays bf16-only (JAX's ``should_fuse``); an explicit
    ``route="kernels"`` at f32 is the mixed tier on the same geometry gate,
    and raises outside it."""
    assert tsf.train_route(tsf.vit_base_config(), torch.float32) == "plain"
    assert tsf.train_route(tsf.vit_base_config(), torch.float32, "kernels") == "kernels"
    with pytest.raises(ValueError):
        tsf.train_route(tsf.vit_tiny_config(), torch.float32, "kernels")
    with pytest.raises(ValueError):
        tsf.train_route(tsf.vit_base_config(), torch.float16, "kernels")


# ---------------------------------------------------------------------------
# the mixed train step
# ---------------------------------------------------------------------------

def _jax_grads(jcfg, js, g, l):
    """JAX's f32 gradients of ``test_torch_train_step.py``'s loss, jitted
    (one compile; the Pallas kernels run in interpret mode inside it)."""
    fn = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg, jnp.float32), has_aux=True))
    _, grads = fn(js, js, jnp.zeros((1, OUT)), jnp.asarray(g), jnp.asarray(l), 0.04)
    return grads


def test_mixed_train_step_matches_jax_fused_f32():
    jcfg, js = _jax_student(7)
    g, l = _crops(8)
    jsj = jax.tree.map(jnp.asarray, js)
    cfg = tsf.TimeSformerConfig(**KW)
    with jax.default_matmul_precision("highest"):
        ref = to_port(_jax_grads(jcfg, jsj, g, l), cfg)
    jmixed = to_port(_jax_grads(dataclasses.replace(jcfg, use_fused=True), jsj, g, l), cfg)
    gt, lt = torch.from_numpy(g), torch.from_numpy(l)
    port = {}
    for name, cd in (("mixed", torch.float32), ("bf16", torch.bfloat16)):
        state, core, mask = _port_state(js, cfg)
        step = ssl.make_train_step(cfg, core, mask, n_local_crops=2, compute_dtype=cd,
                                   route="kernels")
        fb.reset_launches()
        _, _, port[name] = step.loss_and_grads(state, gt, lt, 0.04)
        assert not any(fb.launches.values())  # the CPU runs the twins
    e = {"port": 0.0, "jax": 0.0, "bf16": 0.0}
    for n, want in jmixed.items():
        got = port["mixed"][n].numpy()
        assert _rel(got, want) < 0.15, (n, _rel(got, want))
        scale = np.abs(ref[n]).mean() + 1e-12
        e["port"] += np.abs(got - ref[n]).mean() / scale
        e["jax"] += np.abs(want - ref[n]).mean() / scale
        e["bf16"] += np.abs(port["bf16"][n].numpy() - ref[n]).mean() / scale
    e = {k: v / len(jmixed) for k, v in e.items()}
    assert e["port"] <= 1.5 * e["jax"] + 1e-6, e
    assert e["port"] <= e["bf16"], e
