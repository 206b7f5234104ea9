"""Minimum-Bayes-risk (MBR) selection: reference-free consensus over a
candidate pool.

Counterpart of `controllable_xgating_tpu/infer/mbr.py`. Per video, the
served candidate is the one of highest expected utility against the pool,
U(i) = sum_j w_j * sim(h_i, h_j), with w_j the candidate's frequency in
the pool (a Monte-Carlo estimate under the model) or, for a beam pool,
its normalised posterior. No reference is consulted. The pools come from
the device paths (samples or n-best rows); the selection is host text
utility over small pools, one similarity per ordered pair of distinct
candidates, since the corpus scorers aggregate several references by max
(ROUGE-L) or a length-penalised mean (CIDEr-D), not the plain expectation.
The similarities are ROUGE-L through the native library where it is
built (`utils/native.py`, as the JAX package), else
`metrics/rouge.py::RougeScorer`, and `metrics/cider.py::CiderDScorer`, at
sentence level.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

from controllable_xgating_torch.metrics.cider import CiderDScorer, ngram_counts
from controllable_xgating_torch.metrics.rouge import RougeScorer


def _pair_sim_rouge(a: str, b: str, beta: float = 1.2) -> float:
    from controllable_xgating_torch.utils import native

    if native.available():
        return float(native.rouge_l(a, [b], beta))
    return float(RougeScorer(beta).score_single([b], a))


def _make_ciderd_sim(pools: Mapping[str, Sequence[str]]):
    """Pairwise CIDEr-D with idf over the candidate pseudo-corpus: each
    unique candidate across all pools is one document (no reference may be
    consulted at selection time). The n-gram similarities of n = 1..4, with
    CIDEr-D's tf clipping and Gaussian length penalty, are averaged
    (`CiderDScorer`'s sentence-level math, unscaled)."""
    docs = {c for pool in pools.values() for c in pool}
    scorer = CiderDScorer()
    df: dict = {}
    for d in docs:
        for n_counts in ngram_counts(d.split(), scorer.max_n):
            for ng in n_counts:
                df[ng] = df.get(ng, 0.0) + 1.0
    log_n = math.log(max(len(docs), 1))
    vec_cache: dict[str, tuple] = {}

    def vec(c: str):
        if c not in vec_cache:
            vec_cache[c] = scorer._vec(c.split(), df, log_n)
        return vec_cache[c]

    def sim(a: str, b: str) -> float:
        av, an, al = vec(a)
        bv, bn, bl = vec(b)
        return sum(
            scorer._pair_sim(av[n], an[n], al, bv[n], bn[n], bl) for n in range(scorer.max_n)
        ) / scorer.max_n

    return sim


def mbr_select(
    pools: Mapping[str, Sequence[str]],
    utility: str = "ROUGE_L",
    weights: Mapping[str, Sequence[float]] | None = None,
) -> dict:
    """{vid: [candidates]} -> {vid: (chosen caption, expected utility)}.

    `utility` is 'ROUGE_L' (pairwise LCS F-measure, in [0, 1]) or 'CIDErD'
    (sentence CIDEr-D with idf over the candidate pseudo-corpus).
    Duplicates in a pool fold into frequency weights: a candidate drawn k
    times counts k times in every candidate's expected utility, its own
    included (the Monte-Carlo MBR estimator). `weights` ({vid: [w, ...]},
    aligned with each pool) replaces the frequencies with explicit
    probability mass, the beam-pool form: duplicate strings sum their
    weights, and the weights are normalised per video."""
    if utility not in ("ROUGE_L", "CIDErD"):
        raise ValueError(f"utility must be ROUGE_L or CIDErD, got {utility!r}")
    pair_sim = _pair_sim_rouge if utility == "ROUGE_L" else _make_ciderd_sim(pools)
    # ROUGE-L(a, a) is 1 exactly; CIDEr-D's self-similarity goes through the
    # scorer for its zero-norm edge cases
    self_sim = (lambda c: 1.0) if utility == "ROUGE_L" else (lambda c: pair_sim(c, c))
    out = {}
    for vid, pool in pools.items():
        if not pool:
            raise ValueError(f"empty candidate pool for {vid!r}")
        vw = None
        if weights is not None:
            vw = list(weights[vid])
            if len(vw) != len(pool):
                raise ValueError(
                    f"weights for {vid!r} must align with its pool ({len(vw)} vs {len(pool)})")
            total = sum(vw)
            if total <= 0:
                raise ValueError(f"weights for {vid!r} must sum > 0")
            vw = [x / total for x in vw]
        counts: dict[str, float] = {}
        for i, c in enumerate(pool):
            counts[c] = counts.get(c, 0.0) + (vw[i] if vw is not None else 1.0)
        cands = list(counts)
        if len(cands) == 1:
            out[vid] = (cands[0], 1.0)
            continue
        denom = len(pool) if vw is None else 1.0
        w = [counts[c] / denom for c in cands]
        # neither similarity is symmetric (ROUGE-L's beta weighs recall,
        # CIDEr-D clips the candidate's tf by the reference's): the full
        # ordered matrix
        best_i, best_u = 0, -1.0
        for i, ci in enumerate(cands):
            u = sum(w[j] * (self_sim(ci) if i == j else pair_sim(ci, cj))
                    for j, cj in enumerate(cands))
            if u > best_u:
                best_i, best_u = i, u
        out[vid] = (cands[best_i], best_u)
    return out
