"""The strided scorer's host logic and interpolation helpers, against the
JAX package's, on seeded numpy curves; no model.

* ``_lerp_rows`` / ``_catmull_rom_rows`` / ``_interp_rows`` on host
  (numpy) rows equal JAX's host form to 1e-6 and on CPU tensors JAX's
  device form (jnp arrays) to 1e-6 in f32; in bf16 the weights are rounded
  to bf16 before the mix, as JAX's ``wj.astype(rows.dtype)``: equal to
  JAX's bf16 result within one bf16 ulp of the rows' scale.
* the knot search and weights: knots reproduced (<= 1e-5), Catmull-Rom's
  end knots clamped and its tangents scaled by the uneven spans (a
  hand-computed point), the cubic beats linear on smooth curves (JAX
  tests/test_fast_scoring.py's bound, 0.35x).
* the leave-one-out error (``_loo_errs``) equal to JAX's ``_loo_errs_fn``
  to 1e-6; the knot refinement, the guarded score stride's midpoints and
  its bail equal to JAX's methods exactly, on seeded curves (the
  synthetic stand-in for JAX's reference-loss tests).
* ``_motion_energy`` on uint8 RGB, packed I420 and yuv420q frames equal to
  JAX's exactly; the motion-adaptive knots (JAX
  test_teacher_positions_motion_adaptive) equal to JAX's.
* ``resize_weights`` equal to ``jax.image.resize``'s weight matrix bit for
  bit, and the resize of the port within 1e-5 of ``jax.image.resize`` at
  f32 (which itself sits up to 1.3e-5 from a float64 contraction at 224
  -> 160).
"""

import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.engine import scoring as jscoring
from dino_video_summarization_transformer_tpu_torch.data import yuv
from dino_video_summarization_transformer_tpu_torch.engine import scoring
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import make_video


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: faster alone, and a test
    worker does not then contend for the cores the others share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curve(seed, n, D=16):
    """Smooth random feature rows at n uneven knots in [0, 47]."""
    r = np.random.RandomState(seed)
    xp = np.unique(np.concatenate([[0, 47], r.choice(np.arange(1, 47), n - 2,
                                                    replace=False)]))
    t = xp[:, None] / 47.0
    rows = (np.sin(3 * t + r.randn(1, D)) + 0.3 * r.randn(len(xp), D)).astype(np.float32)
    return xp, rows


@pytest.mark.parametrize("kind", ["linear", "catmullrom"])
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_interp_rows_match_jax_host_and_device(kind, n):
    xp, rows = _curve(n, max(n, 2))
    x = np.arange(48) if n > 1 else np.array([0, 5, 9])
    if n == 1:
        xp, rows = xp[:1], rows[:1]
    want = jscoring._interp_rows(xp, rows, x, kind)
    got = scoring._interp_rows(xp, rows, x, kind)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    dev = scoring._interp_rows(xp, torch.from_numpy(rows), x, kind)
    jdev = np.asarray(jscoring._interp_rows(xp, jnp.asarray(rows), x, kind))
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_allclose(dev.numpy(), jdev, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "catmullrom"])
def test_interp_rows_bf16_weights_rounded_first(kind):
    """bf16 rows mix with bf16 weights (JAX casts the f32 weights to the
    rows' dtype first): the port's result equals JAX's within one bf16 ulp
    of the rows' scale, and differs from mixing with f32 weights."""
    xp, rows = _curve(11, 6)
    x = np.arange(48)
    rb = torch.from_numpy(rows).to(torch.bfloat16)
    got = scoring._interp_rows(xp, rb, x, kind)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jscoring._interp_rows(xp, jnp.asarray(rows, jnp.bfloat16), x, kind)
                      .astype(jnp.float32))
    scale = float(np.abs(rows).max())
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * scale
    f32w = scoring._interp_rows(xp, rb.float(), x, kind)
    assert not torch.equal(got.float(), f32w.to(torch.bfloat16).float())


def test_lerp_rows():
    """JAX tests/test_fast_scoring.py::test_lerp_rows."""
    xp = np.array([0, 4, 10])
    rows = np.array([[0.0, 10.0], [4.0, 6.0], [10.0, 0.0]], np.float32)
    out = scoring._lerp_rows(xp, rows, np.array([0, 2, 4, 7, 10]))
    np.testing.assert_allclose(out[:, 0], [0, 2, 4, 7, 10])
    np.testing.assert_allclose(out[0], rows[0])
    np.testing.assert_allclose(out[-1], rows[-1])
    single = scoring._lerp_rows(np.array([5]), torch.from_numpy(rows[:1]),
                                np.array([0, 9]))
    np.testing.assert_allclose(single.numpy(), np.repeat(rows[:1], 2, 0))


def test_catmull_rom_rows():
    """JAX tests/test_fast_scoring.py::test_catmull_rom_rows: through every
    knot, 0.35x linear's error on a smooth curve, linear below 3 knots, the
    tensor form equal to the host form."""
    rng = np.random.RandomState(0)
    xp = np.array([0, 4, 8, 12, 15])
    rows = rng.randn(5, 7).astype(np.float32)
    np.testing.assert_allclose(scoring._catmull_rom_rows(xp, rows, xp), rows, atol=1e-5)
    x_dense = np.arange(16)

    def f(x):
        return np.stack([np.sin(x / 5.0), (x / 15.0) ** 2, np.cos(x / 7.0)], 1)

    truth = f(x_dense.astype(np.float64))
    e_cr = np.abs(scoring._catmull_rom_rows(xp, f(xp.astype(np.float64)), x_dense)
                  - truth).max()
    e_li = np.abs(scoring._lerp_rows(xp, f(xp.astype(np.float64)), x_dense) - truth).max()
    assert e_cr < 0.35 * e_li, (e_cr, e_li)
    two = scoring._interp_rows(np.array([0, 9]), rows[:2], np.array([0, 3, 9]), "catmullrom")
    np.testing.assert_allclose(two, scoring._lerp_rows(np.array([0, 9]), rows[:2],
                                                       np.array([0, 3, 9])))
    dev = scoring._catmull_rom_rows(xp, torch.from_numpy(rows), x_dense)
    np.testing.assert_allclose(dev.numpy(), scoring._catmull_rom_rows(xp, rows, x_dense),
                               atol=1e-5)


def test_catmull_rom_clamped_ends_and_uneven_tangents():
    """One point by hand on uneven knots [0, 2, 8, 9]: in the first
    interval the left tangent is one-sided (knot -1 clamped to 0), the
    right one spans 8 - 0; at 8.5 the right end is clamped (knot 4 -> 3).
    Swapping the tangent weights (cl <-> cr) moves both points."""
    xp = np.array([0.0, 2.0, 8.0, 9.0])
    y = np.array([[0.0], [1.0], [5.0], [2.0]], np.float32)

    def hermite(x, j):
        h = xp[j + 1] - xp[j]
        t = (x - xp[j]) / h
        m0 = (y[min(j + 1, 3)] - y[max(j - 1, 0)]) / (xp[min(j + 1, 3)] - xp[max(j - 1, 0)])
        m1 = (y[min(j + 2, 3)] - y[j]) / (xp[min(j + 2, 3)] - xp[j])
        return ((2 * t**3 - 3 * t**2 + 1) * y[j] + (t**3 - 2 * t**2 + t) * h * m0
                + (-2 * t**3 + 3 * t**2) * y[j + 1] + (t**3 - t**2) * h * m1)

    def swapped(x, j):  # the tangent weights cl and cr exchanged
        h = xp[j + 1] - xp[j]
        t = (x - xp[j]) / h
        jm1, jp2 = max(j - 1, 0), min(j + 2, 3)
        cl = (t**3 - 2 * t**2 + t) * h / (xp[j + 1] - xp[jm1])
        cr = (t**3 - t**2) * h / (xp[jp2] - xp[j])
        return ((2 * t**3 - 3 * t**2 + 1) * y[j] + (-2 * t**3 + 3 * t**2) * y[j + 1]
                + cr * (y[j + 1] - y[jm1]) + cl * (y[jp2] - y[j]))

    got = scoring._catmull_rom_rows(xp, y, np.array([1.0, 8.5]))
    want = np.stack([hermite(1.0, 0), hermite(8.5, 2)])
    np.testing.assert_allclose(got, want, atol=1e-6)
    wrong = np.stack([swapped(1.0, 0), swapped(8.5, 2)])
    assert np.all(np.abs(wrong - want) > 0.1), (wrong, want)


def test_loo_errs_match_jax():
    xp, rows = _curve(3, 9, D=32)
    w = scoring._loo_weights(xp)
    np.testing.assert_array_equal(w, jscoring.FrameScorer._loo_weights(None, xp))
    got = scoring._loo_errs(torch.from_numpy(rows), w).numpy()

    class _J:
        _jitted = {}

    want = np.asarray(jscoring.FrameScorer._loo_errs_fn(_J())(jnp.asarray(rows),
                                                              jnp.asarray(w)))
    assert got.shape == (len(xp) - 2,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _host(**kw):
    """A port and a JAX scorer without a model, holding only the
    attributes their host logic reads."""
    cfg = types.SimpleNamespace(score_bail=kw.pop("score_bail", 0.9),
                                wire_format=kw.pop("wire_format", "yuv420"))
    out = []
    for cls in (scoring.FrameScorer, jscoring.FrameScorer):
        sc = cls.__new__(cls)
        sc.__dict__.update(config=cfg, **kw)
        out.append(sc)
    return out


@pytest.mark.parametrize("alpha", [0.0, 0.05, 0.2, 0.5, 1e9])
def test_refine_mids_match_jax(alpha):
    r = np.random.RandomState(int(alpha * 100) % 7)
    tpos = np.append(np.arange(0, 96, 8), 95)
    errs = r.rand(len(tpos) - 2) * 0.4
    port, jax_sc = _host(teacher_refine=alpha)
    got = port._refine_mids(tpos, errs)
    want = jax_sc._refine_mids(tpos, errs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == tpos.dtype and not set(got) & set(tpos)


def _positions(T, m):
    """Every m-th frame and the last (the scored positions)."""
    pos = np.arange(0, T, m)
    return pos if pos[-1] == T - 1 else np.append(pos, T - 1)


def _loss_curve(seed, T, kind):
    """Seeded loss curves: smooth, event-spiked and noise-dominated (the
    three regimes the guard meets)."""
    r = np.random.RandomState(seed)
    t = np.arange(T) / T
    base = 5.0 + np.sin(6 * t) + 0.5 * np.cos(17 * t)
    if kind == "events":
        for c in r.choice(T, 4, replace=False):
            base[c:c + 3] += 3.0
    elif kind == "noise":
        base = base * (1 + 0.3 * r.randn(T))
    return base


@pytest.mark.parametrize("kind", ["smooth", "events", "noise"])
@pytest.mark.parametrize("m", [2, 4])
def test_score_refine_rows_match_jax(kind, m):
    """The guarded score stride's midpoints and bail (score_bail 0.9, and
    0 = no bail) equal JAX's on seeded curves."""
    T = 97
    losses = _loss_curve(m, T, kind)
    pos = _positions(T, m)
    for alpha in (0.02, 0.2):
        for bail in (0.9, 0.0):
            port, jax_sc = _host(score_refine=alpha, score_bail=bail)
            lv = losses[pos]
            np.testing.assert_array_equal(port._loss_refine_mids(pos, lv),
                                          jax_sc._loss_refine_mids(pos, lv))
            np.testing.assert_array_equal(port._score_refine_rows(pos, lv, T),
                                          jax_sc._score_refine_rows(pos, lv, T))


def test_guarded_score_stride_on_synthetic_losses():
    """The guard's accounting on the seeded curves (the synthetic stand-in
    for JAX's reference-loss test): it scores more rows than the bare
    stride and at most every frame; where it bails it scores every frame
    and the curve is exact; the guarded curve is no further from the true
    one than the bare stride's; the midpoints never touch scored rows."""
    T, m = 97, 2
    pos = _positions(T, m)
    for kind in ("smooth", "events", "noise"):
        losses = _loss_curve(5, T, kind)
        bare = np.interp(np.arange(T), pos, losses[pos])
        port, _ = _host(score_refine=0.05, score_bail=0.9)
        mids = port._score_refine_rows(pos, losses[pos], T)
        assert not set(mids) & set(pos)
        all_pos = np.sort(np.concatenate([pos, mids]))
        guarded = np.interp(np.arange(T), all_pos, losses[all_pos])
        assert len(pos) <= len(all_pos) <= T
        assert np.abs(guarded - losses).mean() <= np.abs(bare - losses).mean() + 1e-12
        if len(all_pos) == T:
            np.testing.assert_array_equal(guarded, losses)
    # noise-dominated curves flag nearly every knot: the bail scores all
    noisy = _loss_curve(5, T, "noise")
    port, _ = _host(score_refine=1e-9, score_bail=0.9)
    rows = port._score_refine_rows(pos, noisy[pos], T)
    assert len(pos) + len(rows) == T


def _frames_for(layout, vid):
    if layout == "rgb8":
        return vid
    if layout == "yuv420":
        return yuv.pack_rgb(vid)
    return yuv.pack_rgb_q(vid)


@pytest.mark.parametrize("layout", ["rgb8", "yuv420", "yuv420q"])
def test_motion_energy_matches_jax(layout):
    vid = make_video(seed=4, T=24, size=32)
    fr = _frames_for(layout, vid)
    wf = "yuv420q" if layout == "yuv420q" else "yuv420"
    got = scoring._motion_energy(fr, wf)
    np.testing.assert_array_equal(got, jscoring._motion_energy(fr, wf))
    assert got[0] == 0.0 and got.dtype == np.float64
    floats = (vid.astype(np.float32) / 255.0 - 0.45) / 0.225
    np.testing.assert_array_equal(scoring._motion_energy(floats, wf),
                                  jscoring._motion_energy(floats, wf))


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
def test_teacher_positions_motion_adaptive(alpha):
    """JAX test_teacher_positions_motion_adaptive's crafted video: static
    but for a moving bright block at frames 40..56; the port's knots equal
    JAX's; with alpha 1 only intervals around the burst are bisected."""
    T = 100
    v = np.full((T, 32, 32, 3), 30, np.uint8)
    for t in range(40, 56):
        x = (t - 40) * 2
        v[t, 8:24, x:x + 6] = 220
    pos = np.arange(T)
    port, jax_sc = _host(teacher_stride=8, teacher_adaptive=alpha)
    got = port._teacher_positions(pos, v)
    np.testing.assert_array_equal(got, jax_sc._teacher_positions(pos, v))
    uniform = np.append(np.arange(0, T, 8), T - 1)
    if alpha == 0.0:
        np.testing.assert_array_equal(got, uniform)
    elif alpha == 1.0:
        added = sorted(set(got) - set(uniform))
        assert added and all(32 <= a <= 64 for a in added), added


@pytest.mark.parametrize("size,out", [(224, 160), (48, 32), (32, 16), (30, 45)])
def test_resize_weights_and_resize_match_jax(size, out):
    from jax._src.image import scale

    w = scoring.resize_weights(size, out)
    wj = np.asarray(scale.compute_weight_mat(size, out, out / size, 0.0,
                                             scale._fill_triangle_kernel, True))
    np.testing.assert_array_equal(w, wj)
    x = np.random.RandomState(size).randn(1, 3, 2, size, size).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), x.shape[:3] + (out, out), "bilinear"))
    wt = torch.from_numpy(w)
    got = torch.matmul(wt.t(), torch.matmul(torch.from_numpy(x), wt)).numpy()
    w64 = w.astype(np.float64)
    exact = np.matmul(w64.T, np.matmul(x.astype(np.float64), w64))
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(x).max()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if size <= 48:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_student_sub_clamps_to_the_chunks():
    """JAX test_student_dispatch_batching_bit_equal's clamp."""
    port, jax_sc = _host(student_dispatch=4, chunk=8)
    assert [port._student_sub(n) for n in (100, 9, 1)] == [4, 2, 1]
    for n in (1, 9, 100):
        assert port._student_sub(n) == jax_sc._student_sub(n)
