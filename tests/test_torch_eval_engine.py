"""The evaluation engines against the JAX package's, at a small size (D =
128, 2 heads, depth 2, 32-px frames, patch 16, T = 8; numpy-seeded
weights crossed with ``state_dict_from_jax_params``):

* ``knn_classifier``: the same top-1 / top-5 as JAX on tie-free features,
  and on a case built with ties (k = 1, 20 classes: top-5 then holds four
  classes at probability 0, which JAX's ``top_k`` orders by index);
* ``extract_features`` and ``make_classifier_fn``: at f32 within 1e-5 of
  JAX's plain route; the bf16 kernel route (its twins here) against JAX's
  ``use_fused=True, fused_wb=True`` (Pallas interpret) at atol = rtol =
  5e-2 and no further from f32 than Pallas (mean, 1.1x + 1e-3); the K400
  path at ``bfloat16`` (the model in f32 on bf16 pixels: the kernel pair's
  f32 tier) against JAX's ``make_classifier_fn`` with ``use_fused=True`` by
  the same rule; and a test pins JAX's fault: its classifier at
  ``compute_dtype=bfloat16`` equals its f32 classifier on bf16-rounded
  pixels, and so does the port's;
* ``make_linear_probe`` and ``finetune`` at f32: after 3 steps each leaf
  within 1e-5 x max|JAX's leaf|; the same ``epoch_lr`` and schedule
  values; ``log_history`` with the same keys and losses to 1e-5. One
  exception, in ``finetune``: the key thirds of the qkv biases have a zero
  gradient in exact arithmetic (softmax is invariant to a shift common to
  all keys), so their computed gradients are float noise, which Adam
  normalizes into steps of up to the learning rate in either direction;
  those elements are held within 2 x the sum of the steps' learning rates
  of JAX's, every other element of the leaf at 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import classification as jcls
from dino_video_summarization_transformer_tpu.engine import knn as jknn
from dino_video_summarization_transformer_tpu.engine import linear as jlinear
from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.engine import classification as pcls
from dino_video_summarization_transformer_tpu_torch.engine import knn, linear
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

GEO = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, num_frames=8)
TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(num_classes=0, seed=0):
    jcfg = jtsf.TimeSformerConfig(num_classes=num_classes, **GEO)
    params = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=seed))
    if num_classes:  # a classifier head, which make_numpy_params leaves out
        r = np.random.RandomState(100 + seed)
        params["head"] = {"kernel": (0.1 * r.randn(128, num_classes)).astype(np.float32),
                          "bias": (0.1 * r.randn(num_classes)).astype(np.float32)}
    cfg = tsf.TimeSformerConfig(num_classes=num_classes, **GEO)
    return params, jcfg, cfg, convert.state_dict_from_jax_params(params, cfg)


def _model(cfg, sd, dtype=torch.float32, kernels=False):
    return tsf.build_timesformer(dataclasses.replace(cfg, use_kernels=kernels), sd,
                                 device="cpu", dtype=dtype)


class _Clips:
    def __init__(self, n, seed=0):
        self.x = np.random.RandomState(seed).randn(n, 3, 8, 32, 32).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], i


def _no_further(port, pallas, oracle):
    e_port, e_pallas = np.abs(port - oracle).mean(), np.abs(pallas - oracle).mean()
    assert e_port <= 1.1 * e_pallas + 1e-3, (e_port, e_pallas)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 10])
def test_knn_classifier_matches_jax(k):
    r = np.random.RandomState(k)
    tr, te = knn.l2_normalize(r.randn(60, 16)), knn.l2_normalize(r.randn(25, 16))
    ytr, yte = r.randint(0, 7, 60), r.randint(0, 7, 25)
    got = knn.knn_classifier(tr, ytr, te, yte, k, 0.07, num_classes=7, num_chunks=4,
                             device="cpu")
    assert got == jknn.knn_classifier(tr, ytr, te, yte, k, 0.07, num_classes=7, num_chunks=4)
    np.testing.assert_array_equal(knn.l2_normalize(te * 3), jknn.l2_normalize(te * 3))


def test_knn_classifier_ties_follow_jax():
    """k = 1 over 20 classes: one class has weight, the top-5 fills with
    four classes tied at 0, which JAX orders by index (0, 1, 2, ...). Test
    labels sit among those low indices, so top-5 counts them only in that
    order."""
    r = np.random.RandomState(0)
    tr = knn.l2_normalize(r.randn(40, 8))
    ytr = 10 + r.randint(0, 10, 40)  # neighbours' classes 10..19
    te = knn.l2_normalize(r.randn(30, 8))
    yte = r.randint(0, 4, 30)  # never the neighbour's class; 0..3 by index
    got = knn.knn_classifier(tr, ytr, te, yte, 1, 0.07, num_classes=20, device="cpu")
    want = jknn.knn_classifier(tr, ytr, te, yte, 1, 0.07, num_classes=20)
    assert got == want == (0.0, 100.0)


# ---------------------------------------------------------------------------
# frozen-backbone features and the K400 classifier
# ---------------------------------------------------------------------------

def test_extract_features_f32_matches_jax():
    params, jcfg, cfg, sd = _pair()
    ds = _Clips(5)  # batch 2: a tail batch of 1
    got = knn.extract_features(_model(cfg, sd), ds, batch_size=2, num_workers=1,
                               log_every=0)
    want = jknn.extract_features(params, jcfg, ds, batch_size=2, num_workers=1,
                                 log_every=0)
    assert got.shape == (5, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_extract_features_bf16_kernel_route_matches_pallas():
    params, jcfg, cfg, sd = _pair()
    ds = _Clips(3, seed=1)
    assert not tsf.eval_kernels(cfg, torch.bfloat16, "cpu")
    assert tsf.train_route(cfg, torch.bfloat16, "auto") == "kernels"  # the card's gate
    got = knn.extract_features(_model(cfg, sd, torch.bfloat16, kernels=True), ds,
                               batch_size=2, num_workers=1, log_every=0)
    fused = dataclasses.replace(jcfg, use_fused=True, fused_wb=True)
    want = jknn.extract_features(params, fused, ds, batch_size=2, num_workers=1,
                                 compute_dtype=jnp.bfloat16, log_every=0)
    f32 = knn.extract_features(_model(cfg, sd), ds, batch_size=3, num_workers=1, log_every=0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, f32)


def test_classifier_k400_bf16_matches_pallas_mixed_tier():
    """``--precision bfloat16``: the f32 model on the kernel pair (its f32
    tier) on bf16-rounded pixels, against JAX's classifier with
    ``use_fused=True, fused_wb=True`` at the same dtypes (Pallas interpret,
    the mixed tier)."""
    params, jcfg, cfg, sd = _pair(num_classes=6)
    pix = np.random.RandomState(2).randn(2, 8, 3, 32, 32).astype(np.float32)
    got = pcls.make_classifier_fn(_model(cfg, sd, kernels=True), torch.bfloat16)(pix).numpy()
    fused = dataclasses.replace(jcfg, use_fused=True, fused_wb=True)
    want = np.asarray(jcls.make_classifier_fn(params, fused, jnp.bfloat16)(jnp.asarray(pix)))
    f32 = pcls.make_classifier_fn(_model(cfg, sd))(pix).numpy()
    assert got.shape == (2, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _no_further(got, want, f32)


def test_classifier_pins_jax_compute_dtype_fault():
    """JAX's ``make_classifier_fn(compute_dtype=bfloat16)`` never passes the
    dtype to ``forward``: it equals the f32 classifier on bf16-rounded
    pixels, bit for bit (JAX ``engine/classification.py:59-68``). The port
    follows it, and its f32 plain route is within 1e-5 of JAX's."""
    params, jcfg, cfg, sd = _pair(num_classes=6)
    pix = np.random.RandomState(3).randn(2, 8, 3, 32, 32).astype(np.float32)
    rounded = np.array(jnp.asarray(pix, jnp.bfloat16).astype(jnp.float32))
    j_bf16 = np.asarray(jcls.make_classifier_fn(params, jcfg, jnp.bfloat16)(jnp.asarray(pix)))
    j_f32 = np.asarray(jcls.make_classifier_fn(params, jcfg)(jnp.asarray(rounded)))
    np.testing.assert_array_equal(j_bf16, j_f32)
    model = _model(cfg, sd)
    p_bf16 = pcls.make_classifier_fn(model, torch.bfloat16)(pix).numpy()
    np.testing.assert_array_equal(p_bf16, pcls.make_classifier_fn(model)(rounded).numpy())
    np.testing.assert_allclose(p_bf16, j_bf16, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the linear probe and finetuning at f32
# ---------------------------------------------------------------------------

def _leaf_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_linear_probe_matches_jax_after_three_steps():
    params, jcfg, cfg, sd = _pair()
    x = np.random.RandomState(4).randn(3, 4, 3, 8, 32, 32).astype(np.float32)
    y = np.random.RandomState(5).randint(0, 5, (3, 4))
    kw = dict(num_labels=5, lr=0.3, epochs=4, weight_decay=1e-2)
    jstate, jtrain, jeval, jlr = jlinear.make_linear_probe(params, jcfg, **kw)
    state, train, evaluate, epoch_lr = linear.make_linear_probe(_model(cfg, sd), **kw)
    state.head.load_state_dict({k: torch.tensor(v) for k, v in
                                convert.linear_head_state_dict_from_jax(
                                    jax.tree.map(np.asarray, jstate.head)).items()})
    for step in range(3):
        assert epoch_lr(step) == jlr(step)
        lr_t = epoch_lr(step)
        jstate, jloss = jtrain(jstate, jnp.asarray(x[step]), jnp.asarray(y[step]),
                               jnp.asarray(lr_t))
        state, loss = train(state, torch.from_numpy(x[step]), torch.from_numpy(y[step]), lr_t)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _leaf_close(state.head.linear.weight.detach().numpy().T, jstate.head["kernel"], "kernel")
    _leaf_close(state.head.linear.bias.detach().numpy(), jstate.head["bias"], "bias")
    _leaf_close(evaluate(state, torch.from_numpy(x[0])).numpy(),
                jeval(jstate, jnp.asarray(x[0])), "logits")


def test_warmup_schedule_matches_optax():
    import optax

    for lr, warm, total in ((5e-5, 500, 1250), (1e-3, 2, 3), (1e-3, 0, 4), (0.1, 7, 5)):
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warm),
             optax.linear_schedule(lr, 0.0, max(total - warm, 1))], [warm])
        got = pcls.warmup_linear_schedule(lr, warm, total)
        for c in range(0, total + 3):
            assert got(c) == float(want(c)), (lr, warm, total, c)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


class _Frames:
    def __init__(self, n, seed):
        r = np.random.RandomState(seed)
        self.x = r.randn(n, 8, 3, 32, 32).astype(np.float32)
        self.y = r.randint(0, 6, n)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"pixel_values": self.x[i], "label": int(self.y[i])}


def test_finetune_matches_jax_after_three_steps(tmp_path):
    """AdamW with optax's semantics at the CLI's learning rate (5e-5; a
    warmup of 2 steps, so the first step runs at learning rate 0), weight
    decay on every leaf, a per-epoch eval, and the log history's three key
    sets."""
    params, jcfg, cfg, sd = _pair(num_classes=6)
    train, val = _Frames(6, 6), _Frames(4, 7)
    kw = dict(num_epochs=1, batch_size=2, lr=5e-5, warmup_steps=2, weight_decay=0.01,
              num_workers=1, max_steps_per_epoch=3, log_every=1)
    jparams, jlog = jcls.finetune(train, val, jax.tree.map(jnp.asarray, params), jcfg,
                                  str(tmp_path / "jax"), **kw)
    model, log = pcls.finetune(train, val, _model(cfg, sd).train(), str(tmp_path / "port"),
                               **kw)
    got = convert.jax_params_from_state_dict(
        {k: v.detach() for k, v in model.state_dict().items()}, cfg)
    sched = pcls.warmup_linear_schedule(5e-5, 2, 3)
    noise_step = 2 * sum(sched(c) for c in range(3))
    for path, leaf in convert.flatten_params(got):
        want = np.asarray(jparams[path[0]] if len(path) == 1 else
                          _at(jparams, path))
        if path[-2:] == ("qkv", "bias"):  # (depth, 3D): q, k, v thirds
            key = slice(128, 256)
            assert np.abs(leaf[:, key] - want[:, key]).max() <= noise_step
            leaf, want = np.delete(leaf, key, axis=1), np.delete(want, key, axis=1)
        _leaf_close(leaf, want, "/".join(path))
    assert [sorted(e) for e in log] == [sorted(e) for e in jlog]
    assert len(log) == 5  # 3 steps, 1 eval, the summary
    for e, je in zip(log, jlog):
        for key in ("loss", "eval_loss", "train_loss", "learning_rate", "total_flos"):
            if key in je:
                assert abs(e[key] - je[key]) <= 1e-5 * max(abs(je[key]), 1e-12), (key, e, je)
        assert (e["epoch"], e["step"]) == (je["epoch"], je["step"])
    assert (tmp_path / "port" / "training_log_history.json").exists()
