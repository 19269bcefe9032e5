"""The captioning stage of the port against the JAX package's: the metrics
of ``engine/caption_metrics.py`` (BLEU, CIDEr, native METEOR with its stem
and synonym stages, ``meteor_score_safe``, ``bertscore_safe`` without a
model) to 1e-12, and the CLI twins ``llava_captioning --captioner stub``
and ``captioning_evaluation`` on the same fixture: the same CSV rows,
printed lines and metric JSON. The captioning CLI needs the native
decoder and is skipped where it is not built."""

import importlib.util
import json
import os

import numpy as np
import pytest

import conftest

from dino_video_summarization_transformer_tpu.engine import caption_metrics as jcm
from dino_video_summarization_transformer_tpu_torch import (captioning_evaluation,
                                                            llava_captioning)
from dino_video_summarization_transformer_tpu_torch.data import video as vio
from dino_video_summarization_transformer_tpu_torch.engine import caption_metrics as cm

PREDS = ["a dog runs in the park", "a man is cooking pasta", "two cats sleep",
         "the kids were playing football happily"]
REFS = [["a dog runs in the park", "a dog is running outside"],
        ["a man cooks pasta", "someone is cooking pasta in a pot"],
        ["cats sleeping on a sofa"],
        ["children play soccer", "the kid plays football in a field"]]


def _close(a, b):
    if a is None or b is None:
        assert a is b
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-12, atol=1e-12)
    else:
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_matches_jax(smooth):
    _close(cm.corpus_bleu(PREDS, REFS, smooth=smooth),
           jcm.corpus_bleu(PREDS, REFS, smooth=smooth))


def test_cider_matches_jax():
    refs = {f"v{i}": r for i, r in enumerate(REFS)}
    cands = {f"v{i}": [p] for i, p in enumerate(PREDS)}
    (s, per), (js, jper) = cm.cider_score(refs, cands), jcm.cider_score(refs, cands)
    _close(s, js)
    _close(per, jper)


class _Lemma:
    def __init__(self, n):
        self._n = n

    def name(self):
        return self._n


class _Synset:
    def __init__(self, names):
        self._names = names

    def lemmas(self):
        return [_Lemma(n) for n in self._names]


class _WordNet:
    """A wordnet-like corpus with a few synsets."""
    SYN = {"kids": ["child", "kid", "youngster"], "football": ["soccer", "association_football"],
           "play": ["play", "act"], "playing": ["play"], "sleep": ["sleep", "slumber"]}

    def synsets(self, word):
        return [_Synset(self.SYN[word])] if word in self.SYN else []


@pytest.mark.parametrize("stages", ["exact", "stem", "stem+syn"])
def test_meteor_matches_jax(stages):
    stem = cm._porter_stemmer() if "stem" in stages else None
    jstem = jcm._porter_stemmer() if "stem" in stages else None
    if "stem" in stages:
        assert stem is not None, "nltk's Porter stemmer"
    syn = cm.wordnet_synonym_fn(_WordNet()) if "syn" in stages else None
    jsyn = jcm.wordnet_synonym_fn(_WordNet()) if "syn" in stages else None
    for p, refs in zip(PREDS, REFS):
        for r in refs:
            _close(cm.meteor_single(p.split(), r.split(), stem=stem, synonyms=syn),
                   jcm.meteor_single(p.split(), r.split(), stem=jstem, synonyms=jsyn))
    got, method = cm.meteor_score_safe(PREDS, REFS, synonyms=syn)
    want, jmethod = jcm.meteor_score_safe(PREDS, REFS, synonyms=jsyn)
    assert method == jmethod
    _close(got, want)
    assert cm.bertscore_safe(PREDS, REFS, None) is None


def _fixture_csvs(d):
    caps = d / "captions_adaptive.csv"
    caps.write_text("".join(f'v{i}.avi "{p}</s>"\n' for i, p in enumerate(PREDS)))
    ann = d / "annotations.csv"
    ann.write_text("".join(f"v{i},{r}\n" for i, refs in enumerate(REFS) for r in refs))
    return caps, ann


def _jax_cli(name):
    """The repo root's CLI, loaded by path (its module name is the port's
    CLI's too)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(conftest.REPO_ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_captioning_evaluation_cli_matches_jax(tmp_path, capsys):
    """The same printed lines and metric JSON as the root CLI, on JAX's
    test fixture style (Video-LLaVA CSV, annotations, extension keys)."""
    caps, ann = _fixture_csvs(tmp_path)
    jce = _jax_cli("captioning_evaluation")

    class A:
        captions = str(caps)
        annotations = str(ann)
        test_split = ""
        bert_model = ""
        output_json = str(tmp_path / "jax.json")

    want = jce.main("adaptive", None, args=A())
    jout = capsys.readouterr().out
    got = captioning_evaluation.run(["--captions", str(caps), "--annotations", str(ann),
                                     "--output_json", str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    assert out == jout and "All keys match" in out
    _close({k: v for k, v in got.items() if k != "meteor_method"},
           {k: v for k, v in want.items() if k != "meteor_method"})
    assert got["meteor_method"] == want["meteor_method"]
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    assert captioning_evaluation.parse_captions_csv(str(caps)) == jce.parse_captions_csv(
        str(caps))


def test_llava_captioning_stub_cli_matches_jax(tmp_path, capsys):
    """``--captioner stub`` over adaptively selected frames: the same CSV
    rows and printed lines as the root CLI (selection, decode and the
    stub captioner), for each selection method."""
    if not vio.native_available():
        pytest.skip("native decoder not built")
    r = np.random.RandomState(0)
    losses = {}
    for i, n in enumerate((24, 17)):
        vio.write_video(str(tmp_path / f"v{i}.avi"),
                        r.randint(0, 256, (n, 48, 64, 3), np.uint8))
        losses[f"v{i}"] = r.rand(-(-n // 2)).tolist()
    (tmp_path / "test.csv").write_text("v0.avi 0\nv1.avi 1\n")
    (tmp_path / "loss.json").write_text(json.dumps(losses))
    jlc = _jax_cli("llava_captioning")
    cfg = os.path.join(conftest.REPO_ROOT, "configs/kinetics/timesformer_divst_8x32_224.yaml")
    for method in ("adaptive", "uniform"):
        def argv(out):
            return ["--cfg", cfg, "--data_path", str(tmp_path), "--loss_file",
                    str(tmp_path / "loss.json"), "--selection_method", method,
                    "--num_frames", "4", "--pre_sampling_rate", "2", "--captioner", "stub",
                    "--output_csv", str(tmp_path / out), "--opts",
                    "TEST.NUM_ENSEMBLE_VIEWS", "1"]
        jlc.main(jlc.get_args_parser().parse_args(argv(f"jax_{method}.csv")))
        jout = capsys.readouterr().out
        llava_captioning.main(argv(f"port_{method}.csv"))
        out = capsys.readouterr().out
        got = (tmp_path / f"port_{method}.csv").read_text()
        assert got == (tmp_path / f"jax_{method}.csv").read_text()
        assert got.count("\n") == 2 and 'v0.avi "a video with 4 selected frames' in got
        assert [ln for ln in out.splitlines() if ln.startswith(("1/", "2/"))] == [
            ln for ln in jout.splitlines() if ln.startswith(("1/", "2/"))]
