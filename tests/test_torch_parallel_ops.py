"""Tier C (the ``partial_out`` tier of rows 1, 4, 7 and 8) and the
tensor-parallel layout, against the JAX package's kernels and rules.

* The partial twins (``temporal_phase_tm`` / ``spatial_phase`` with
  ``partial_out=True``, forward, and their backwards) against JAX's
  ``fused_temporal_phase_tm`` / ``fused_spatial_phase`` at
  ``partial_out=True`` (Pallas in interpret mode) and their ``jax.vjp``,
  on head-sharded weights at tp = 2 and 4 (Dq = 128 and 64; D = 256, 4
  heads, B = 2, T = 4, N = 4): forward per output max|diff| <= 2e-2 x
  max|JAX| (one bf16 rounding of the output plus the Pallas kernels' TPU
  workarounds, +/-80 logit clamp and ones-column denominators; JAX's own
  tp_fused forward bound is 8e-3 over a whole model), gradients <= 2e-2 x
  max|JAX| per leaf (JAX ``test_tp_fused.py``'s gradient bound).
* The sum of the shards' partials plus the once-applied biases and the
  residual equals the unsharded twin (rows 1b and 4, f32 tiers of their
  branches): rms(diff) <= 1e-2 x rms(branch) and max <= 4e-2 x max|branch|
  (each shard rounds its terms to bf16 before the sum, where the
  unsharded op rounds once); the gradients of the sum equal the unsharded
  backward's by the same bounds.
* ``qkv_head_perm`` and the permutation round trip as arrays against
  JAX's; the Megatron rules (``tp.tp_spec``) leaf for leaf against JAX's
  ``tp_spec_tree`` of a whole train state; the state dict cut into shards
  and gathered back is the state dict.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.ops import fused_block as jfb
from dino_video_summarization_transformer_tpu.parallel import build_mesh as jbuild_mesh
from dino_video_summarization_transformer_tpu.parallel import tp_fused as jtpf
from dino_video_summarization_transformer_tpu.parallel.tp import tp_spec_tree
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf
from dino_video_summarization_transformer_tpu_torch.ops import fused_block as fb
from dino_video_summarization_transformer_tpu_torch.parallel import tp, tp_fused, zero

D, H, B, T, N = 256, 4, 2, 4, 4
FWD_TOL = 2e-2
GRAD_TOL = 2e-2
SUM_RMS, SUM_MAX = 1e-2, 4e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _branch_gap(got, want):
    got, want = _np(got), _np(want)
    return (float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))),
            float(np.abs(got - want).max() / np.abs(want).max()))


@pytest.fixture(scope="module")
def block():
    """A block's weights (JAX layout, numpy), bf16 rows and cotangents."""
    r = np.random.RandomState(0)

    def lin(fi, fo, std=0.1):
        return {"kernel": (r.randn(fi, fo) * std).astype(np.float32),
                "bias": (r.randn(fo) * 0.02).astype(np.float32)}

    w = {"norm": {"scale": (1 + 0.1 * r.randn(D)).astype(np.float32),
                  "bias": (0.05 * r.randn(D)).astype(np.float32)},
         "qkv": lin(D, 3 * D), "proj": lin(D, D), "fc": lin(D, D)}

    def bf(*shape):
        a = r.randn(*shape).astype(np.float32)
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)

    return {"w": w, "x": bf(B, T, N, D), "cls": bf(B, 1, D), "dout": bf(B, T, N, D),
            "dco": bf(B, T, D)}


def _shard(w, tp_size, l):
    """Shard l of the block's qkv (head-major), proj (input rows) in JAX's
    layout, and the port's f32 masters of the same numbers."""
    perm = jtpf.qkv_head_perm(D, H, tp_size)
    Dq = D // tp_size
    cols = perm[l * 3 * Dq:(l + 1) * 3 * Dq]
    qkv = {"kernel": w["qkv"]["kernel"][:, cols], "bias": w["qkv"]["bias"][cols]}
    proj = {"kernel": w["proj"]["kernel"][l * Dq:(l + 1) * Dq], "bias": np.zeros(D, np.float32)}
    fc = {"kernel": w["fc"]["kernel"], "bias": np.zeros(D, np.float32)}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    masters = {"ln_w": t(w["norm"]["scale"]), "ln_b": t(w["norm"]["bias"]),
               "qkv_w": t(qkv["kernel"].T), "qkv_b": t(qkv["bias"]),
               "proj_w": t(proj["kernel"].T), "fc_w": t(fc["kernel"].T)}
    return {"qkv": qkv, "proj": proj, "fc": fc}, masters


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _temporal_kp(m):
    return fb.kernel_weights([m[k] for k in fb.TEMPORAL_PARTIAL_KEYS], fb.TEMPORAL_PARTIAL_KEYS)


def _spatial_kp(m):
    keys = fb.SPATIAL_PARTIAL_KEYS
    src = {"ln1_w": m["ln_w"], "ln1_b": m["ln_b"], "qkv_w": m["qkv_w"], "qkv_b": m["qkv_b"],
           "proj_w": m["proj_w"]}
    return fb.kernel_weights([src[k] for k in keys], keys)


@pytest.fixture(scope="module")
def jax_partials(block):
    """JAX's partial kernels and VJPs on every shard at tp = 2 and 4."""
    w, (xj, _), (cj, _), (dj, _), (dcj, _) = (block[k] for k in ("w", "x", "cls", "dout", "dco"))
    out = {}
    pn = _j(w["norm"])
    for tp_size in (2, 4):
        for l in range(tp_size):
            js, _ = _shard(w, tp_size, l)
            pa = _j({"qkv": js["qkv"], "proj": js["proj"]})
            pfc = _j(js["fc"])
            hl = H // tp_size
            t_out, t_vjp = jax.vjp(lambda a, b, c, x: jfb.fused_temporal_phase_tm(
                a, b, c, x, hl, partial_out=True), pn, pa, pfc, xj)
            s_out, s_vjp = jax.vjp(lambda a, b, c, x: jfb.fused_spatial_phase(
                a, b, c, x, hl, partial_out=True), pn, pa, cj, xj)
            out[tp_size, l] = {"t": _np(t_out), "t_vjp": t_vjp(dj),
                               "s": [_np(o) for o in s_out], "s_vjp": s_vjp((dj, dcj))}
    return out


@pytest.mark.parametrize("tp_size", [2, 4])
def test_partial_twins_match_jax_partial_kernels(block, jax_partials, tp_size):
    """Rows 1p and 4p forward, and 7p and 8p (the VJPs), shard by shard."""
    _, xt = block["x"]
    _, ct = block["cls"]
    _, dt = block["dout"]
    _, dct = block["dco"]
    hl = H // tp_size
    for l in range(tp_size):
        ref = jax_partials[tp_size, l]
        _, m = _shard(block["w"], tp_size, l)
        kt, ks = _temporal_kp(m), _spatial_kp(m)
        got = fb.temporal_phase_tm(xt, kt, hl, partial_out=True)
        assert got.dtype == torch.bfloat16 and got.shape == xt.shape
        assert _rel(got, ref["t"]) <= FWD_TOL, (tp_size, l, _rel(got, ref["t"]))
        g, c = fb.spatial_phase(xt, ct, ks, hl, partial_out=True)
        assert _rel(g, ref["s"][0]) <= FWD_TOL and _rel(c, ref["s"][1]) <= FWD_TOL
        # row 7p against JAX's VJP
        dn, da, dfc, dx = ref["t_vjp"]
        pdx, pg = fb.temporal_phase_tm_bwd(xt, dt, kt, hl, partial_out=True)
        want = {"x": dx, "ln_w": dn["scale"], "ln_b": dn["bias"],
                "qkv_w": np.asarray(da["qkv"]["kernel"], np.float32).T,
                "qkv_b": da["qkv"]["bias"],
                "proj_w": np.asarray(da["proj"]["kernel"], np.float32).T,
                "fc_w": np.asarray(dfc["kernel"], np.float32).T}
        got = {"x": pdx, **pg}
        for k, v in want.items():
            assert _rel(got[k], v) <= GRAD_TOL, ("7p", tp_size, l, k, _rel(got[k], v))
        # row 8p
        dn, da, dcls, dx = ref["s_vjp"]
        pdx, pdcls, pg = fb.spatial_phase_bwd(xt, ct, dt, dct, ks, hl, partial_out=True)
        want = {"x": dx, "cls": dcls, "ln1_w": dn["scale"], "ln1_b": dn["bias"],
                "qkv_w": np.asarray(da["qkv"]["kernel"], np.float32).T,
                "qkv_b": da["qkv"]["bias"],
                "proj_w": np.asarray(da["proj"]["kernel"], np.float32).T}
        got = {"x": pdx, "cls": pdcls, **pg}
        for k, v in want.items():
            assert _rel(got[k], v) <= GRAD_TOL, ("8p", tp_size, l, k, _rel(got[k], v))


def _full_kp(w):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    full = [t(w["norm"]["scale"]), t(w["norm"]["bias"]), t(w["qkv"]["kernel"].T),
            t(w["qkv"]["bias"]), t(w["proj"]["kernel"].T), t(w["proj"]["bias"]),
            t(w["fc"]["kernel"].T), t(w["fc"]["bias"])]
    kt = fb.kernel_weights(full, fb.TEMPORAL_KEYS)
    ks = fb.kernel_weights(full[:6], fb.SPATIAL_PHASE_KEYS)
    return kt, ks


@pytest.mark.parametrize("tp_size", [2, 4])
def test_sum_of_partials_equals_unsharded_twin(block, tp_size):
    """Rows 1 and 4 over the shards: the f32 sum of the partials plus the
    biases (and the residual) against the unsharded twin's branch, forward
    and backward; the unsharded qkv / proj gradients are the shards' rows
    and columns, unpermuted."""
    w = block["w"]
    _, xt = block["x"]
    _, ct = block["cls"]
    _, dt = block["dout"]
    _, dct = block["dco"]
    hl, Dq = H // tp_size, D // tp_size
    kt_full, ks_full = _full_kp(w)
    want_t = fb.temporal_phase_tm(xt, kt_full, H) - xt.float()
    want_g, want_c = fb.spatial_phase(xt, ct, ks_full, H, out_dtype=torch.float32)
    want_g = want_g - xt.float()
    b_comb = torch.from_numpy(w["proj"]["bias"] @ w["fc"]["kernel"] + w["fc"]["bias"])
    bproj = torch.from_numpy(w["proj"]["bias"])
    sum_t = sum_g = sum_c = 0.0
    grads_t, grads_s = [], []
    for l in range(tp_size):
        _, m = _shard(w, tp_size, l)
        kt, ks = _temporal_kp(m), _spatial_kp(m)
        sum_t = sum_t + fb.temporal_phase_tm(xt, kt, hl, partial_out=True).float()
        g, c = fb.spatial_phase(xt, ct, ks, hl, partial_out=True)
        sum_g, sum_c = sum_g + g.float(), sum_c + c.float()
        grads_t.append(fb.temporal_phase_tm_bwd(xt, dt, kt, hl, partial_out=True))
        grads_s.append(fb.spatial_phase_bwd(xt, ct, dt, dct, ks, hl, partial_out=True))
    for got, want in [(sum_t + b_comb, want_t), (sum_g + bproj, want_g),
                      (sum_c + bproj, want_c.float())]:
        rms, mx = _branch_gap(got, want)
        assert rms <= SUM_RMS and mx <= SUM_MAX, (tp_size, rms, mx)
    # backward: dx and the replicated leaves' sums, the sharded leaves whole
    perm = tp_fused.qkv_head_perm(D, H, tp_size)
    inv = np.argsort(perm)
    dx_full, g_full = fb.temporal_phase_tm_bwd(xt, dt, kt_full, H)
    got = {"x": sum(d.float() for d, _ in grads_t),
           "ln_w": sum(g["ln_w"] for _, g in grads_t), "ln_b": sum(g["ln_b"] for _, g in grads_t),
           # + fc's gradient through b_comb = bproj @ Wfc^T + bfc, which the
           # caller's autograd adds once: colsum(dout) (x) bproj
           "fc_w": sum(g["fc_w"] for _, g in grads_t)
           + torch.outer(dt.float().reshape(-1, D).sum(0), bproj),
           "qkv_w": torch.cat([g["qkv_w"] for _, g in grads_t])[inv],
           "qkv_b": torch.cat([g["qkv_b"] for _, g in grads_t])[inv],
           "proj_w": torch.cat([g["proj_w"] for _, g in grads_t], dim=1)}
    want = {"x": dx_full.float() - dt.float(), **g_full}
    for k, v in got.items():
        rms, mx = _branch_gap(v, want[k])
        assert rms <= SUM_RMS and mx <= SUM_MAX, ("row 7", tp_size, k, rms, mx)
    dx_full, dcls_full, g_full = fb.spatial_phase_bwd(xt, ct, dt, dct, ks_full, H)
    got = {"x": sum(d.float() for d, _, _ in grads_s),
           "cls": sum(c for _, c, _ in grads_s),
           "ln1_w": sum(g["ln1_w"] for _, _, g in grads_s),
           "ln1_b": sum(g["ln1_b"] for _, _, g in grads_s),
           "qkv_w": torch.cat([g["qkv_w"] for _, _, g in grads_s])[inv],
           "qkv_b": torch.cat([g["qkv_b"] for _, _, g in grads_s])[inv],
           "proj_w": torch.cat([g["proj_w"] for _, _, g in grads_s], dim=1)}
    want = {"x": dx_full.float() - dt.float(), "cls": dcls_full, **g_full}
    for k, v in got.items():
        rms, mx = _branch_gap(v, want[k])
        assert rms <= SUM_RMS and mx <= SUM_MAX, ("row 8", tp_size, k, rms, mx)


def test_partial_functions_give_the_twin_backward():
    """The autograd Functions of the partial tier run the twins on the CPU:
    their gradients equal the backward wrappers' exactly."""
    r = np.random.RandomState(3)
    tp_size, hl, Dq = 2, H // 2, D // 2
    t = lambda *s: torch.from_numpy((0.1 * r.randn(*s)).astype(np.float32))  # noqa: E731
    masters = {"ln_w": 1 + t(D), "ln_b": t(D), "qkv_w": t(3 * Dq, D), "qkv_b": t(3 * Dq),
               "proj_w": t(D, Dq), "fc_w": t(D, D)}
    x = torch.from_numpy(r.randn(B, T, N, D).astype(np.float32)).bfloat16()
    cls = torch.from_numpy(r.randn(B, 1, D).astype(np.float32)).bfloat16()
    dout = torch.from_numpy(r.randn(B, T, N, D).astype(np.float32)).bfloat16()
    leaves = {k: v.clone().requires_grad_(True) for k, v in masters.items()}
    xg = x.clone().requires_grad_(True)
    out = fb.TemporalPhaseTmPartial.apply(xg, hl, *[leaves[k] for k in fb.TEMPORAL_PARTIAL_KEYS])
    out.backward(dout)
    dx, g = fb.temporal_phase_tm_bwd(x, dout, _temporal_kp(masters), hl, partial_out=True)
    assert torch.equal(xg.grad, dx)
    for k in fb.TEMPORAL_PARTIAL_KEYS:
        assert torch.equal(leaves[k].grad, g[k]), k
    skeys = {"ln1_w": "ln_w", "ln1_b": "ln_b", "qkv_w": "qkv_w", "qkv_b": "qkv_b",
             "proj_w": "proj_w"}
    leaves = {k: masters[v].clone().requires_grad_(True) for k, v in skeys.items()}
    xg, cg = x.clone().requires_grad_(True), cls.clone().requires_grad_(True)
    go, co = fb.SpatialPhasePartial.apply(xg, cg, hl, *[leaves[k] for k in fb.SPATIAL_PARTIAL_KEYS])
    dco = torch.from_numpy(r.randn(B, T, D).astype(np.float32)).bfloat16()
    torch.autograd.backward([go, co], [dout, dco])
    dx, dcls, g = fb.spatial_phase_bwd(x, cls, dout, dco, _spatial_kp(masters), hl,
                                       partial_out=True)
    assert torch.equal(xg.grad, dx) and torch.equal(cg.grad, dcls.bfloat16())
    for k in fb.SPATIAL_PARTIAL_KEYS:
        assert torch.equal(leaves[k].grad, g[k]), k


def test_partial_wrappers_refuse_what_the_kernels_do_not_take(block):
    _, xt = block["x"]
    _, m = _shard(block["w"], 2, 0)
    kt = _temporal_kp(m)
    with pytest.raises(ValueError, match="multiple of 64"):  # Dq = 96 over 3 heads
        bad = dict(kt, qkv_w=kt["qkv_w"][:288].contiguous(), qkv_b=kt["qkv_b"][:288].contiguous(),
                   proj_w=kt["proj_w"][:, :96].contiguous())
        fb.temporal_phase_tm(xt, bad, 3, partial_out=True)
    with pytest.raises(ValueError):  # proj's input width is not the shard's
        fb.temporal_phase_tm(xt, dict(kt, proj_w=kt["fc_w"]), 2, partial_out=True)
    with pytest.raises(ValueError, match="writes x's dtype"):
        fb.spatial_phase(xt, block["cls"][1], _spatial_kp(m), 2, out_dtype=torch.float32,
                         partial_out=True)


@pytest.mark.parametrize("tp_size", [2, 4])
def test_qkv_head_perm_matches_jax(tp_size):
    """The permutation as arrays, and the state dict's round trip: the
    port's (3D, D) rows permuted as JAX permutes its (D, 3D) columns."""
    np.testing.assert_array_equal(tp_fused.qkv_head_perm(D, H, tp_size),
                                  jtpf.qkv_head_perm(D, H, tp_size))
    cfg = jtsf.TimeSformerConfig(embed_dim=D, depth=2, num_heads=H, img_size=32,
                                 num_frames=T, num_classes=0)
    jp = jtsf.init_timesformer(jax.random.key(0), cfg)
    jperm = jax.tree.map(np.asarray, jtpf.permute_qkv_tree(jp, H, tp_size))
    pcfg = tsf.TimeSformerConfig(embed_dim=D, depth=2, num_heads=H, img_size=32,
                                 num_frames=T, num_classes=0)
    sd = {k: torch.from_numpy(v) for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, jp), pcfg).items()}
    want = convert.state_dict_from_jax_params(jperm, pcfg)
    got = tp_fused.permute_qkv_tree(sd, H, tp_size)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = tp_fused.unpermute_qkv_tree(got, H, tp_size)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_tp_rules_match_jax_leaf_for_leaf():
    """Every leaf of a whole train state (student, teacher, Adam moments):
    the port's ``tp_spec`` shards the tensor JAX's ``tp_spec_tree`` shards,
    on the same dimension: each leaf filled with its JAX shard index along
    the sharded axis, carried to the port's names by the converter, reads
    the port shard's index in every element of the port's shard."""
    cfg = jtsf.TimeSformerConfig(embed_dim=D, depth=2, num_heads=H, img_size=32,
                                 num_frames=T, num_classes=0)
    state, _, _ = jssl.init_train_state(jax.random.key(0), cfg, out_dim=128)
    mesh = jbuild_mesh(data=4, model=2)
    specs = tp_spec_tree(state, mesh)
    pcfg = tsf.TimeSformerConfig(embed_dim=D, depth=2, num_heads=H, img_size=32,
                                 num_frames=T, num_classes=0)

    def labels(leaf, spec):
        a = np.zeros(leaf.shape, np.float32)
        for ax, name in enumerate(spec):
            if name == "model":
                idx = np.arange(leaf.shape[ax]) // (leaf.shape[ax] // 2)
                a = a + idx.reshape([-1 if i == ax else 1 for i in range(leaf.ndim)])
        return a + (0.5 if "model" not in tuple(spec) else 0.0)

    n_sharded = 0
    for part in ("student", "teacher"):
        tree = jax.tree.map(labels, getattr(state, part), getattr(specs, part))
        sd = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
            tree["backbone"], pcfg).items()}
        sd.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
            tree["head"]).items()})
        for name, v in sd.items():
            dim = tp.tp_spec(name, v.shape, 2)
            if dim is None:
                assert np.all(v == 0.5), (part, name)  # replicated in JAX too
                continue
            n_sharded += 1
            for l in range(2):
                chunk = np.take(v, np.arange(l * v.shape[dim] // 2, (l + 1) * v.shape[dim] // 2),
                                axis=dim)
                assert np.all(chunk == l), (part, name, l)
    # per block: two qkv weights and biases, fc1's weight and bias, two proj
    # weights, fc2's; the head's fc1 pair, fc2, weight_v and weight_g
    assert n_sharded == 2 * (9 * 2 + 5)


def test_state_dict_shards_gather_back():
    """``convert.shard_state_dict`` / ``gather_state_dicts`` round trip on a
    flat state (student, teacher, moments) for "tp" (qkv head-major) and
    "zero1" (the moments on their first divisible dim), and ZeRO's rule."""
    r = np.random.RandomState(1)
    pcfg = tsf.TimeSformerConfig(embed_dim=D, depth=1, num_heads=H, img_size=32,
                                 num_frames=T, num_classes=0)
    model = tsf.init_timesformer(pcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = {}
    for n, p in model.named_parameters():
        flat["student.backbone." + n] = p.detach()
        flat["opt.mu.backbone." + n] = torch.from_numpy(r.randn(*p.shape).astype(np.float32))
    flat["opt.count"] = torch.tensor(3, dtype=torch.int32)
    for kind, size in (("tp", 2), ("tp", 4), ("zero1", 2), ("zero1", 4)):
        dims = convert.state_dims(flat, size, kind)
        shards = [convert.shard_state_dict(flat, i, size, kind, H) for i in range(size)]
        back = convert.gather_state_dicts(shards, dims, kind, H)
        for k, v in flat.items():
            assert torch.equal(back[k], v), (kind, size, k)
        if kind == "tp":
            qkv = "student.backbone.blocks.0.attn.qkv.weight"
            assert shards[0][qkv].shape == (3 * D // size, D)
        else:
            assert all(dims[k] is None for k in flat if not k.startswith("opt."))
    assert zero.moment_dim((3, 8), 2) == 1 and zero.moment_dim((768,), 4) == 0
    assert zero.moment_dim((), 2) is None and zero.moment_dim((3, 5), 2) is None
