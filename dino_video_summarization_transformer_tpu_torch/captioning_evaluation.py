"""Captioning metric evaluation CLI (ref: captioning_evaluation.py:8-124;
counterpart of the repo root's ``captioning_evaluation.py``, with the same
flags).

    python -m dino_video_summarization_transformer_tpu_torch.captioning_evaluation \\
        --captions eval_logs/captions_adaptive.csv \\
        --annotations eval_logs/annotations.csv --output_json metrics.json

Parses a generated-captions CSV (the Video-LLaVA output format, with the
reference's cleanup quirks: a trailing '</s>"', quotes stripped, four
characters of extension stripped from each key) and an annotations CSV of
ground truths, aligns them on the MSVD test split (``--test_split``, a
pickle with a ``video_name`` column, or the keys both hold) and computes
BLEU, METEOR, BERTScore (with a local ``--bert_model``) and CIDEr
(``engine/caption_metrics.py``).
"""

import argparse
import os
import pickle


def parse_captions_csv(path: str):
    """(ref: captioning_evaluation.py:24-37)."""
    captions = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            if parts and parts[-1] == '</s>"':
                parts = parts[:-1]
            if not parts or not parts[0]:
                continue
            key = parts[0][:-4]  # strip extension (ref quirk: fixed 4 chars)
            value = " ".join(parts[1:]).replace('"', "")
            value = value.replace("</s>", "").strip()
            captions[key] = [value]
    return captions


def parse_annotations_csv(path: str):
    """(ref: captioning_evaluation.py:47-59)."""
    truth = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(",")
            key = parts[0]
            value = " ".join(parts[1:])
            truth.setdefault(key, []).append(value)
    return truth


def main(selection_method="adaptive", video_tag=None, args=None):
    from .engine.caption_metrics import (bertscore_safe, cider_score, corpus_bleu,
                                         meteor_score_safe)

    captions_path = args.captions or os.path.join(
        "eval_logs", f"captions_{selection_method}.csv")
    captions_dict = parse_captions_csv(captions_path)
    truth_dict = parse_annotations_csv(args.annotations)

    cap_keys = sorted(captions_dict.keys())
    truth_keys = sorted(truth_dict.keys())
    print("All keys match" if cap_keys == truth_keys else "Keys do not match")

    if args.test_split and os.path.exists(args.test_split):
        with open(args.test_split, "rb") as f:
            data = pickle.load(f)
        test_set = list(sorted(set(data["video_name"])))
    else:
        test_set = sorted(set(cap_keys) & set(truth_dict.keys()))

    if video_tag is not None:
        test_set = [video_tag]

    predictions = [captions_dict[k][0] for k in test_set]
    references = [truth_dict[k] for k in test_set]

    bleu = corpus_bleu(predictions, references)
    meteor, meteor_method = meteor_score_safe(predictions, references)
    bert = bertscore_safe(predictions, references, args.bert_model)
    cider, _ = cider_score(
        {k: truth_dict[k] for k in test_set},
        {k: captions_dict[k] for k in test_set})

    print("BLEU", bleu)
    print("METEOR", f"{meteor} [{meteor_method}]" if meteor is not None
          else "(unavailable)")
    print("BERT", bert if bert is not None else "(no local BERT model)")
    print("CIDEr", cider)
    result = {"bleu": bleu["bleu"], "meteor": meteor,
              "meteor_method": meteor_method, "bert": bert, "cider": cider}
    if getattr(args, "output_json", ""):
        import json

        with open(args.output_json, "w") as f:
            json.dump(result, f, indent=1)
    return result


def get_args_parser():
    p = argparse.ArgumentParser("Captioning metrics")
    p.add_argument("--selection_method", default="adaptive",
                   choices=["adaptive", "uniform", "adaptive_sharp"])
    p.add_argument("--captions", default="", type=str)
    p.add_argument("--annotations", default="eval_logs/annotations.csv")
    p.add_argument("--test_split", default="", type=str,
                   help="MSVD test split pickle (video_name column)")
    p.add_argument("--bert_model", default="", type=str,
                   help="local HF encoder dir for BERTScore")
    p.add_argument("--video_tag", default=None, type=str)
    p.add_argument("--output_json", default="", type=str,
                   help="also write the metric dict to this JSON path")
    return p


def run(argv=None):
    a = get_args_parser().parse_args(argv)
    return main(a.selection_method, a.video_tag, args=a)


if __name__ == "__main__":
    run()
