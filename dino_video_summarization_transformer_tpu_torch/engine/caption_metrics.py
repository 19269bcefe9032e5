"""Captioning metrics: BLEU, CIDEr, METEOR, BERTScore (counterpart of the
JAX package's ``engine/caption_metrics.py``, which holds no JAX code; ref:
captioning_evaluation.py:97-119).

The reference calls HuggingFace ``evaluate`` ("bleu", "meteor",
"bertscore") and pycocoevalcap's Cider. BLEU and CIDEr are written here
with the same published algorithms (Papineni et al. corpus BLEU; Vedantam
et al. CIDEr with tf-idf 4-gram cosine and length penalty). METEOR runs
nltk's scorer when its WordNet data is present, else the native scorer
below (exact, Porter-stem and an optional synonym stage); BERTScore needs a
local encoder checkpoint. Each degrades to a stated fallback or None
instead of failing the pipeline. nltk, ``transformers`` and numpy load
lazily, where a metric needs them.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(predictions: List[str], references: List[List[str]],
                max_order: int = 4, smooth: bool = False) -> Dict:
    """Papineni corpus BLEU — same algorithm as HF evaluate's "bleu"
    (which uses the tensorflow nmt compute_bleu)."""
    matches_by_order = [0] * max_order
    possible_by_order = [0] * max_order
    ref_length = trans_length = 0
    for pred, refs in zip(predictions, references):
        pred_tokens = pred.split()
        refs_tokens = [r.split() for r in refs]
        trans_length += len(pred_tokens)
        ref_length += min(len(r) for r in refs_tokens)
        merged_ref = Counter()
        for r in refs_tokens:
            for n in range(1, max_order + 1):
                for gram, cnt in _ngrams(r, n).items():
                    merged_ref[gram] = max(merged_ref[gram], cnt)
        for n in range(1, max_order + 1):
            overlap = {
                g: min(c, merged_ref[g])
                for g, c in _ngrams(pred_tokens, n).items() if g in merged_ref
            }
            matches_by_order[n - 1] += sum(overlap.values())
            possible_by_order[n - 1] += max(len(pred_tokens) - n + 1, 0)

    precisions = [0.0] * max_order
    for i in range(max_order):
        if smooth:
            precisions[i] = (matches_by_order[i] + 1.0) / (possible_by_order[i] + 1.0)
        elif possible_by_order[i] > 0:
            precisions[i] = matches_by_order[i] / possible_by_order[i]

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0
    ratio = trans_length / max(ref_length, 1)
    bp = 1.0 if ratio > 1.0 else math.exp(1 - 1 / ratio) if ratio > 0 else 0.0
    return {
        "bleu": geo_mean * bp,
        "precisions": precisions,
        "brevity_penalty": bp,
        "length_ratio": ratio,
        "translation_length": trans_length,
        "reference_length": ref_length,
    }


def cider_score(references: Dict[str, List[str]],
                candidates: Dict[str, List[str]],
                n: int = 4, sigma: float = 6.0):
    """CIDEr (Vedantam et al.) — pycocoevalcap Cider algorithm: per-n tf-idf
    vectors, length-penalized cosine, x10, averaged over n.
    references/candidates: {key: [sentences]} with one candidate per key."""
    import numpy as np

    keys = sorted(candidates.keys())

    def counts(sent: str, order: int) -> Counter:
        return _ngrams(sent.lower().split(), order)

    # document frequency over reference sets
    doc_freq = [defaultdict(float) for _ in range(n)]
    for k in keys:
        for order in range(n):
            grams = set()
            for ref in references[k]:
                grams |= set(counts(ref, order + 1).keys())
            for g in grams:
                doc_freq[order][g] += 1
    log_n_docs = math.log(max(len(keys), 1))

    def tfidf_vec(sent: str, order: int):
        cnt = counts(sent, order + 1)
        length = max(len(sent.lower().split()), 1)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            df = math.log(max(doc_freq[order][g], 1.0))
            w = (c / 1.0) * max(log_n_docs - df, 0.0)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), length

    scores = []
    for k in keys:
        cand = candidates[k][0]
        score_n = np.zeros(n)
        for order in range(n):
            cv, cn, cl = tfidf_vec(cand, order)
            acc = 0.0
            for ref in references[k]:
                rv, rn, rl = tfidf_vec(ref, order)
                num = sum(min(cv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in cv)
                if cn > 0 and rn > 0:
                    sim = num / (cn * rn)
                else:
                    sim = 0.0
                delta = cl - rl
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                acc += sim
            score_n[order] = acc / max(len(references[k]), 1)
        scores.append(float(np.mean(score_n) * 10.0))
    return float(np.mean(scores)), np.asarray(scores)


def _match_stage(enum_hyp: list, enum_ref: list, key) -> list:
    """One METEOR alignment stage (the nltk _match_enums greedy rule):
    scan hypothesis tokens right-to-left, take the rightmost reference
    token with the same ``key``, remove both. Returns (hyp_idx, ref_idx)
    pairs; mutates the enum lists in place."""
    matches = []
    for i in range(len(enum_hyp))[::-1]:
        ki = key(enum_hyp[i][1])
        for j in range(len(enum_ref))[::-1]:
            if ki == key(enum_ref[j][1]):
                matches.append((enum_hyp[i][0], enum_ref[j][0]))
                enum_hyp.pop(i)
                enum_ref.pop(j)
                break
    return matches


def _synonym_stage(enum_hyp: list, enum_ref: list, synonyms) -> list:
    """One METEOR wordnet-synonym alignment stage (the nltk
    ``_enum_wordnetsyn_match`` rule): scan hypothesis tokens right-to-left;
    each matches the rightmost unmatched reference token whose surface form
    is in the hypothesis token's synonym set (which always includes the
    token itself). ``synonyms`` maps a lowercase token to an iterable of
    lemma names — any synonym source plugs in (nltk wordnet, a domain
    lexicon); the ALGORITHM is nltk's, only the corpus is external."""
    matches = []
    for i in range(len(enum_hyp))[::-1]:
        w = enum_hyp[i][1]
        syns = set(synonyms(w)) | {w}
        for j in range(len(enum_ref))[::-1]:
            if enum_ref[j][1] in syns:
                matches.append((enum_hyp[i][0], enum_ref[j][0]))
                enum_hyp.pop(i)
                enum_ref.pop(j)
                break
    return matches


def wordnet_synonym_fn(wordnet):
    """Adapt an nltk-wordnet-like corpus object (``synsets(word)`` →
    synsets with ``lemmas()`` → lemmas with ``name()``) into the
    ``synonyms`` callable of :func:`meteor_single` — the exact lemma-name
    set nltk's METEOR uses (multiword "_" lemmas excluded)."""
    def synonyms(word: str):
        return {
            lemma.name()
            for synset in wordnet.synsets(word)
            for lemma in synset.lemmas()
            if "_" not in lemma.name()
        }
    return synonyms


def _count_chunks(matches: list) -> int:
    chunks = 1
    for i in range(len(matches) - 1):
        if (matches[i + 1][0] == matches[i][0] + 1
                and matches[i + 1][1] == matches[i][1] + 1):
            continue
        chunks += 1
    return chunks


def meteor_single(hypothesis: List[str], reference: List[str], stem=None,
                  synonyms=None, alpha: float = 0.9, beta: float = 3.0,
                  gamma: float = 0.5) -> float:
    """METEOR sentence score (Banerjee & Lavie) — the full nltk
    ``single_meteor_score`` algorithm: exact, stem, and synonym alignment
    stages (held to nltk stage by stage in the JAX package's
    tests). ``stem`` is a token->stem callable or
    None; ``synonyms`` is a token->lemma-name-set callable or None (this
    offline image has no wordnet corpus, so the production fallback runs
    synonym-free — a strict lower bound; any synonym source plugs in via
    :func:`wordnet_synonym_fn`)."""
    enum_hyp = list(enumerate(w.lower() for w in hypothesis))
    enum_ref = list(enumerate(w.lower() for w in reference))
    t_len, r_len = len(enum_hyp), len(enum_ref)
    matches = _match_stage(enum_hyp, enum_ref, lambda w: w)
    if stem is not None:
        matches += _match_stage(enum_hyp, enum_ref, stem)
    if synonyms is not None:
        if stem is not None:
            # nltk quirk, kept for parity: its stem stage hands the
            # synonym stage STEMMED leftovers, so synset lookups and
            # reference comparisons run on stems ("slices" -> "slice")
            enum_hyp = [(i, stem(w)) for i, w in enum_hyp]
            enum_ref = [(j, stem(w)) for j, w in enum_ref]
        matches += _synonym_stage(enum_hyp, enum_ref, synonyms)
    matches.sort(key=lambda pair: pair[0])
    m = len(matches)
    if m == 0 or t_len == 0 or r_len == 0:
        return 0.0
    precision = m / t_len
    recall = m / r_len
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    return (1.0 - gamma * frag ** beta) * fmean


def _porter_stemmer():
    try:
        from nltk.stem.porter import PorterStemmer  # pure code, no data

        return PorterStemmer().stem
    except Exception:
        return None


def meteor_score_safe(predictions: List[str], references: List[List[str]],
                      synonyms=None):
    """Mean METEOR over the corpus (ref: captioning_evaluation.py:101-103
    calls HF evaluate's "meteor", which wraps nltk). When the wordnet
    corpus is available the full nltk scorer runs; otherwise the native
    scorer above — the same algorithm, with the synonym stage driven by
    the optional ``synonyms`` callable (token -> lemma-name set, e.g.
    :func:`wordnet_synonym_fn` over any wordnet-like corpus) and skipped
    when none is given (scores are then a strict lower bound of full
    METEOR).
    Returns (score, method)."""
    try:
        import nltk
        from nltk.translate.meteor_score import meteor_score

        try:
            nltk.data.find("corpora/wordnet.zip")
        except LookupError:
            nltk.data.find("corpora/wordnet")
        scores = [
            meteor_score([r.split() for r in refs], pred.split())
            for pred, refs in zip(predictions, references)
        ]
        return sum(scores) / max(len(scores), 1), "nltk+wordnet"
    except Exception:
        pass
    stem = _porter_stemmer()
    scores = [
        max(meteor_single(pred.split(), r.split(), stem=stem,
                          synonyms=synonyms) for r in refs)
        if refs else 0.0
        for pred, refs in zip(predictions, references)
    ]
    if not scores:
        return None, "unavailable"
    stages = ("exact+stem" if stem else "exact") + ("+syn" if synonyms else "")
    return sum(scores) / len(scores), f"native {stages}"


def bertscore_safe(predictions: List[str], references: List[List[str]],
                   model_path: str | None = None):
    """BERTScore precision mean (ref: captioning_evaluation.py:98-100).
    Requires a LOCAL HF encoder checkpoint (zero-egress image); returns
    None when unavailable."""
    if not model_path:
        return None
    try:
        import numpy as np
        import torch
        from transformers import AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_path)
        model = AutoModel.from_pretrained(model_path).eval()

        def embed(sents):
            with torch.no_grad():
                enc = tok(sents, return_tensors="pt", padding=True,
                          truncation=True)
                out = model(**enc).last_hidden_state
                mask = enc["attention_mask"].unsqueeze(-1)
                return out, mask

        precisions = []
        for pred, refs in zip(predictions, references):
            p_emb, p_mask = embed([pred])
            r_emb, r_mask = embed(refs)
            p = torch.nn.functional.normalize(p_emb[0], dim=-1)
            best = -1.0
            for ri in range(r_emb.shape[0]):
                r = torch.nn.functional.normalize(
                    r_emb[ri][: int(r_mask[ri].sum())], dim=-1)
                sim = p[: int(p_mask[0].sum())] @ r.T
                prec = float(sim.max(dim=1).values.mean())
                best = max(best, prec)
            precisions.append(best)
        return float(np.mean(precisions))
    except Exception as e:  # pragma: no cover
        print(f"bertscore unavailable: {e}")
        return None
