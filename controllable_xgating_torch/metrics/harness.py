"""Evaluation harness: decoded ids -> tokenized text -> metric dict.

Rebuilds the reference's `eval_utils.py` / `language_eval` (SURVEY.md §2
"Eval harness"; stack §3.3 tail): candidate captions are PTB-tokenized the
same way the ground truths were during corpus prep, every scorer runs, and
the resulting metric dict drives best-checkpoint selection (train loop
keeps the best CIDEr, reference behavior).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from controllable_xgating_torch.data.tokenizer import PTBTokenizer
from controllable_xgating_torch.data.vocab import Vocab
from controllable_xgating_torch.metrics.bleu import BleuScorer
from controllable_xgating_torch.metrics.cider import CiderDScorer, CiderScorer
from controllable_xgating_torch.metrics.meteor import MeteorScorer
from controllable_xgating_torch.metrics.rouge import RougeScorer


PER_KEY_METRICS = (
    "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
    "METEOR", "ROUGE_L", "CIDEr", "CIDErD",
)


def normalize_metric_name(name: str) -> str:
    """Canonicalize a per-key metric name ('CIDEr-D' -> 'CIDErD',
    'rouge-l' -> 'ROUGE_L', ...), raising on anything language_eval's
    per-key detail will never contain — lookups with .get(name, 0.0)
    would otherwise silently read all zeros (oracle/rerank consumers)."""
    canon = {m.lower().replace("-", "").replace("_", ""): m
             for m in PER_KEY_METRICS}
    key = str(name).lower().replace("-", "").replace("_", "")
    if key not in canon:
        raise ValueError(
            f"unknown per-video metric {name!r}; choose one of "
            f"{list(PER_KEY_METRICS)}"
        )
    return canon[key]


def decode_token_array(
    vocab: Vocab, tokens: np.ndarray
) -> list[str]:
    """[B, L] int array -> list of space-joined caption strings."""
    return [vocab.decode_str(row) for row in np.asarray(tokens)]


def gts_from_label_array(
    vocab: Vocab, caps: np.ndarray, ncaps: np.ndarray, keys: Sequence[str]
) -> dict[str, list[str]]:
    """labels.npz slices -> {key: [ref strings]} for the scorers."""
    gts = {}
    for key, cap_rows, n in zip(keys, np.asarray(caps), np.asarray(ncaps)):
        gts[key] = [vocab.decode_str(row) for row in cap_rows[: int(n)]]
    return gts


def language_eval(
    gts: Mapping[str, Sequence[str]],
    res: Mapping[str, Sequence[str]],
    retokenize: bool = False,
    metrics: Sequence[str] = None,
    per_key: bool = False,
    meteor_synonyms=None,
):
    """Run the scorer suite. Inputs are {key: [caption strings]}.

    `retokenize=True` pushes both sides through the PTB tokenizer first
    (coco-caption behavior when fed raw sentences); decoded model output
    built from the training vocab is already in tokenized form.

    `metrics` selects which scorer families run (cfg.eval.metrics; default
    all). Names match the output keys: any of Bleu_4/METEOR/ROUGE_L/CIDEr/
    CIDErD — BLEU always yields all four orders when selected.

    `per_key=True` additionally returns {key: {metric: score}} (the
    reference's coco-caption `imgToEval` surface) as a second value.

    `meteor_synonyms` (path / mapping / synset groups — see
    metrics/meteor.MeteorScorer) enables METEOR's stage-3 synonym module;
    None keeps the exact+stem-only default.
    """
    if retokenize:
        tok = PTBTokenizer()
        gts = tok.tokenize_captions({k: list(v) for k, v in gts.items()})
        res = tok.tokenize_captions({k: list(v) for k, v in res.items()})

    missing = [k for k in res if k not in gts]
    if missing:
        raise KeyError(f"candidates without references: {missing[:5]}")

    if isinstance(metrics, str):  # CLI override form: "CIDEr,Bleu_4"
        metrics = [m for m in metrics.split(",") if m]
    want = None if metrics is None else {m.lower() for m in metrics}

    def on(name: str) -> bool:
        return want is None or any(name in m for m in want)

    keys = list(res.keys())
    detail: dict[str, dict[str, float]] = {k: {} for k in keys}

    def record(name: str, per: Sequence[float]) -> None:
        if per_key:
            for k, v in zip(keys, per):
                detail[k][name] = float(v)

    out: dict[str, float] = {}
    if on("bleu"):
        bleu, per = BleuScorer(4).score(gts, res)  # per is [order][key]
        for i, b in enumerate(bleu, 1):
            out[f"Bleu_{i}"] = b
            record(f"Bleu_{i}", per[i - 1])
    if on("meteor"):
        out["METEOR"], per = MeteorScorer(
            synonyms=meteor_synonyms).score(gts, res)
        record("METEOR", per)
    if on("rouge"):
        out["ROUGE_L"], per = RougeScorer().score(gts, res)
        record("ROUGE_L", per)
    if on("cider"):  # plain CIDEr ("cider" also selects CIDErD below)
        out["CIDEr"], per = CiderScorer().score(gts, res)
        record("CIDEr", per)
    if on("cider"):
        out["CIDErD"], per = CiderDScorer().score(gts, res)
        record("CIDErD", per)
    if per_key:
        return out, detail
    return out
