"""The evaluation consumers' metrics, meters and logging against the JAX
package's on the same arrays (``engine/metrics.py``, ``engine/meters.py``,
``utils/logging.py``): equal results. ``get_map``'s average precision,
written in numpy in the port, against ``sklearn.metrics.
average_precision_score`` (which the JAX package calls) to 1e-12."""

import io
import logging

import numpy as np
import pytest

import conftest  # noqa: F401

from dino_video_summarization_transformer_tpu.engine import meters as jmeters
from dino_video_summarization_transformer_tpu.engine import metrics as jmetrics
from dino_video_summarization_transformer_tpu.utils import logging as jlogging
from dino_video_summarization_transformer_tpu_torch.engine import meters, metrics
from dino_video_summarization_transformer_tpu_torch.utils import logging as plogging


def _preds(seed, n=64, c=11):
    r = np.random.RandomState(seed)
    return r.randn(n, c).astype(np.float32), r.randint(0, c, n)


@pytest.mark.parametrize("fn", ["topks_correct", "topk_errors", "topk_accuracies"])
def test_topk_metrics_equal_jax(fn):
    p, y = _preds(0)
    ks = (1, 3, 5)
    assert getattr(metrics, fn)(p, y, ks) == getattr(jmetrics, fn)(p, y, ks)
    assert metrics.accuracy(p, y, (1, 5)) == jmetrics.accuracy(p, y, (1, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_map_matches_sklearn(seed):
    from sklearn.metrics import average_precision_score

    r = np.random.RandomState(seed)
    p = r.rand(50, 9)
    p[:, 2] = np.round(p[:, 2], 1)  # tied scores
    y = (r.rand(50, 9) < 0.3).astype(np.float32)
    y[:, 4] = 0  # a class with no positive is dropped
    keep = ~np.all(y == 0, axis=0)
    want = float(np.mean(average_precision_score(y[:, keep], p[:, keep], average=None)))
    got = metrics.get_map(p, y)
    assert abs(got - want) <= 1e-12
    assert abs(got - jmetrics.get_map(p, y)) <= 1e-12
    for c in np.flatnonzero(keep):
        assert abs(metrics.average_precision(y[:, c], p[:, c])
                   - average_precision_score(y[:, c], p[:, c])) <= 1e-12


@pytest.mark.parametrize("ensemble", ["sum", "max"])
def test_test_meter_equals_jax(ensemble, capsys):
    num_videos, num_clips, num_cls = 6, 3, 7
    r = np.random.RandomState(3)
    labels = r.randint(0, num_cls, num_videos)
    port = meters.TestMeter(num_videos, num_clips, num_cls, ensemble_method=ensemble)
    jax_m = jmeters.TestMeter(num_videos, num_clips, num_cls, ensemble_method=ensemble)
    order = r.permutation(num_videos * num_clips)
    for chunk in np.array_split(order[:-1], 4):  # one clip missing
        preds = r.randn(len(chunk), num_cls).astype(np.float32)
        for m in (port, jax_m):
            m.update_stats(preds, labels[chunk // num_clips], chunk)
    np.testing.assert_array_equal(port.video_preds, jax_m.video_preds)
    assert port.finalize_metrics() == jax_m.finalize_metrics()
    out = capsys.readouterr().out
    assert out.count("clip count incomplete") == 2
    with pytest.raises(AssertionError):  # a clip of video 0 under another label
        port.update_stats(np.zeros((1, num_cls), np.float32),
                          np.asarray([(labels[0] + 1) % num_cls]), np.asarray([0]))


def test_smoothed_value_and_metric_logger_equal_jax(capsys):
    vals = np.random.RandomState(4).rand(30).tolist()
    p, j = meters.SmoothedValue(window_size=7), jmeters.SmoothedValue(window_size=7)
    for v in vals:
        p.update(v, n=2)
        j.update(v, n=2)
    for attr in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert str(p) == str(j)
    p.synchronize_between_processes()  # one process: nothing to do
    assert (p.count, p.total) == (j.count, j.total)

    lines = {}
    for name, mod in (("port", meters), ("jax", jmeters)):
        ml = mod.MetricLogger(delimiter="  ")
        for i in ml.log_every(range(5), 2, "Epoch: [0]"):
            ml.update(loss=vals[i], lr=0.5)
        lines[name] = [ln.split("eta:")[0].split("Total time")[0]
                       for ln in capsys.readouterr().out.splitlines()]
        assert ml.loss.global_avg == pytest.approx(np.mean(vals[:5]))
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 4


def test_log_json_stats_equals_jax():
    stats = {"b": 1.234567891, "a": 2, "c": "x", "d": 0.1 + 0.2}
    out = {}
    for name, mod in (("port", plogging), ("jax", jlogging)):
        buf = io.StringIO()
        logger = logging.getLogger(f"dvst_test_{name}")
        logger.handlers[:] = [logging.StreamHandler(buf)]
        logger.setLevel(logging.INFO)
        mod.log_json_stats(stats, logger)
        out[name] = buf.getvalue()
    assert out["port"] == out["jax"] == (
        'json_stats: {"a": 2, "b": 1.23457, "c": "x", "d": 0.3}\n')


def test_setup_for_distributed_gates_print(capsys):
    import builtins

    saved = builtins.print
    try:
        plogging.setup_for_distributed(False)
        print("hidden")
        print("shown", force=True)
    finally:
        builtins.print = saved
    assert capsys.readouterr().out == "shown\n"
