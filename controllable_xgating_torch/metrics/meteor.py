"""METEOR (Banerjee & Lavie 2005; Denkowski & Lavie 2011/2014), pure Python.

Rebuilds coco-caption's METEOR component (SURVEY.md §2 "METEOR"), which
shells out to meteor-1.5.jar over a subprocess pipe — impossible here (no
JVM). This follows the published METEOR 1.3/1.5 scoring form exactly:

    P     = sum_matches w_stage * w_word(hyp word) / sum_hyp w_word
    R     = sum_matches w_stage * w_word(ref word) / sum_ref w_word
    Fmean = P * R / (alpha * P + (1 - alpha) * R)
    frag  = chunks / matches
    Pen   = gamma * frag ** beta          <- the published penalty form
    score = (1 - Pen) * Fmean

with the METEOR 1.5 English task parameters alpha=0.85, beta=0.2,
gamma=0.6, delta=0.75 and matcher stage weights exact=1.0, stem=0.6
(Denkowski & Lavie 2014, "Meteor Universal", table of language defaults).
delta weights content words; function words get (1 - delta).

Divergences from meteor-1.5.jar, each unavoidable offline and documented
per SURVEY.md §2's "report divergence" directive:
  * the WordNet synonym stage (w=0.8) is IMPLEMENTED (module order
    exact > stem > synonym, METEOR 1.5 English module weights) behind a
    pluggable synonym table — two words synonym-match when they share a
    synset group. The WordNet DATA is unobtainable offline, so the
    default table is empty, which is bit-identical to the previous
    exact+stem behavior; drop a WordNet export in the group-per-line
    format of `load_synonym_table` and the jar's stage-3 semantics light
    up with no code change. The paraphrase-table stage (w=0.6) remains
    omitted (jar-internal download). With an empty table METEOR here is
    therefore a lower bound vs the jar.
  * Porter stemmer instead of Snowball. Measured bound (tools/
    meteor_sensitivity.py; docs/RESULTS.md round 3): disabling the stem
    stage entirely moves the fixture-corpus score by ~1e-4, so any
    stemmer disagreement is below that.
  * the function-word list is the common English core rather than the
    jar's learned list. Measured: extending it with 60 closed-class words
    moves the corpus score by ~3e-4; even deleting a random quarter of
    the list moves it by at most ~0.015.

Alignment: the jar resolves the match search with a beam over partial
alignments choosing maximum total matches, then fewest chunks. `_align`
implements the same objective as a left-to-right beam over hypothesis
positions (beam 256 — exhaustive for caption-length sentences, so the
"max matches, then min chunks" optimum is exact here; ties after chunks
prefer higher stage weight, i.e. exact over stem matches).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

from controllable_xgating_torch.metrics.stemmer import stem

# METEOR 1.5 English task parameters (Denkowski & Lavie 2014).
ALPHA = 0.85
BETA = 0.2    # fragmentation penalty exponent: Pen = GAMMA * frag**BETA
GAMMA = 0.6
DELTA = 0.75  # content-word weight; function words weigh (1 - DELTA)

# matcher module weights in module-precedence order (exact, stem, synonym)
# — METEOR 1.5 English defaults; the paraphrase module (0.6) is omitted
STAGE_WEIGHTS = (1.0, 0.6, 0.8)

# word -> frozenset of synset-group ids; two words synonym-match iff the
# sets intersect (WordNet semantics: they share a synset)
SynTable = Mapping[str, frozenset]


def build_synonym_table(groups: Iterable[Iterable[str]]) -> dict[str, frozenset]:
    """Synset groups (each an iterable of mutually synonymous words) ->
    the word -> group-id-set mapping the matcher consumes."""
    acc: dict[str, set] = {}
    for gid, group in enumerate(groups):
        for w in group:
            acc.setdefault(str(w), set()).add(gid)
    return {w: frozenset(s) for w, s in acc.items()}


def load_synonym_table(path: str) -> dict[str, frozenset]:
    """Load a synonym table: one synset group per line, words separated
    by whitespace; '#' starts a comment. A WordNet export in this format
    makes the jar's stage-3 semantics a pure data drop-in."""
    groups = []
    with open(path) as f:
        for line in f:
            words = line.split("#", 1)[0].split()
            if len(words) >= 2:
                groups.append(words)
    return build_synonym_table(groups)

_BEAM = 256

_FUNCTION_WORDS = {
    "a", "an", "the", "of", "in", "on", "at", "to", "and", "or", "is",
    "are", "was", "were", "be", "been", "am", "do", "does", "did", "has",
    "have", "had", "by", "with", "for", "it", "its", "as", "that", "this",
    "there", "from", "but", "not", "no", "so", "if", "then", "than",
}


def _align(
    hyp: list[str],
    ref: list[str],
    use_stem: bool = True,
    synonyms: Optional[SynTable] = None,
) -> list[tuple[int, int, int]]:
    """Best alignment as [(hyp_i, ref_j, stage)], stage 0=exact, 1=stem,
    2=synonym (a pair is assigned its FIRST applicable module in METEOR's
    module order, jar behavior).

    Beam search over hypothesis positions, each word either unmatched or
    matched to a compatible unused reference word. States are ranked by
    (matches desc, chunks asc, stage-weight sum desc) — the published
    METEOR alignment objective. Beam 256 is exhaustive at caption lengths.
    `use_stem=False` disables the stem stage (sensitivity analysis only —
    bounds what ANY stemmer disagreement could change).
    """
    stems_h = [stem(w) for w in hyp] if use_stem else None
    stems_r = [stem(w) for w in ref] if use_stem else None
    syn = synonyms or {}
    syn_h = [syn.get(w) for w in hyp]
    syn_r = [syn.get(w) for w in ref]
    cands: list[list[tuple[int, int]]] = []
    for i, hw in enumerate(hyp):
        row = []
        for j, rw in enumerate(ref):
            if hw == rw:
                row.append((j, 0))
            elif use_stem and stems_h[i] == stems_r[j]:
                row.append((j, 1))
            elif syn_h[i] and syn_r[j] and not syn_h[i].isdisjoint(syn_r[j]):
                row.append((j, 2))
        cands.append(row)

    # state: (used_ref frozenset, last_i, last_j) ->
    #        (matches, chunks, wsum, pairs tuple)
    states: dict[tuple, tuple] = {(frozenset(), -2, -2): (0, 0, 0.0, ())}
    for i in range(len(hyp)):
        nxt: dict[tuple, tuple] = {}

        def consider(key, val):
            old = nxt.get(key)
            if old is None or _better(val, old):
                nxt[key] = val

        for (used, li, lj), (m, ch, ws, pairs) in states.items():
            # leave hyp[i] unmatched
            consider((used, li, lj), (m, ch, ws, pairs))
            for j, stage in cands[i]:
                if j in used:
                    continue
                new_ch = ch + (0 if (i == li + 1 and j == lj + 1) else 1)
                consider(
                    (used | {j}, i, j),
                    (
                        m + 1,
                        new_ch,
                        ws + STAGE_WEIGHTS[stage],
                        pairs + ((i, j, stage),),
                    ),
                )
        ranked = sorted(nxt.items(), key=lambda kv: _rank(kv[1]), reverse=True)
        states = dict(ranked[:_BEAM])

    best = max(states.values(), key=_rank)
    return list(best[3])


def _rank(val: tuple) -> tuple:
    m, ch, ws, _ = val
    return (m, -ch, ws)


def _better(a: tuple, b: tuple) -> bool:
    return _rank(a) > _rank(b)


def _count_chunks(pairs: Sequence[tuple[int, int, int]]) -> int:
    if not pairs:
        return 0
    chunks = 1
    for (h1, r1, _), (h2, r2, _) in zip(pairs, pairs[1:]):
        if h2 != h1 + 1 or r2 != r1 + 1:
            chunks += 1
    return chunks


def _weight(word: str, function_words=None) -> float:
    fw = _FUNCTION_WORDS if function_words is None else function_words
    return (1.0 - DELTA) if word in fw else DELTA


def meteor_single(
    hyp_str: str,
    refs: Sequence[str],
    function_words=None,
    use_stem: bool = True,
    synonyms: Optional[SynTable] = None,
) -> float:
    """METEOR of one hypothesis vs its references (best ref wins — jar
    behavior when scoring captioning-style multi-reference sets).

    `synonyms` (see build_synonym_table) enables the stage-3 synonym
    module; None/empty is bit-identical to exact+stem-only scoring.
    `function_words` / `use_stem` exist ONLY for the documented
    sensitivity analysis (tools/meteor_sensitivity.py) bounding the
    divergence from the jar's learned word list and Snowball stemmer;
    scoring paths always use the defaults."""
    hyp = hyp_str.split()
    best = 0.0
    for ref_str in refs:
        ref = ref_str.split()
        if not hyp or not ref:
            continue
        pairs = _align(hyp, ref, use_stem=use_stem, synonyms=synonyms)
        if not pairs:
            continue
        m_hyp = sum(
            STAGE_WEIGHTS[s] * _weight(hyp[i], function_words)
            for i, _, s in pairs
        )
        m_ref = sum(
            STAGE_WEIGHTS[s] * _weight(ref[j], function_words)
            for _, j, s in pairs
        )
        w_hyp = sum(_weight(w, function_words) for w in hyp)
        w_ref = sum(_weight(w, function_words) for w in ref)
        p = m_hyp / w_hyp if w_hyp else 0.0
        r = m_ref / w_ref if w_ref else 0.0
        if p == 0.0 or r == 0.0:
            continue
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = _count_chunks(pairs) / len(pairs)
        penalty = GAMMA * frag**BETA
        score = (1.0 - penalty) * fmean
        best = max(best, score)
    return best


def _normalize_synonyms(synonyms) -> Optional[dict[str, frozenset]]:
    """Accept a table path, a prebuilt word->ids mapping, or an iterable
    of synset groups; return the word->ids table (None stays None)."""
    if synonyms is None:
        return None
    if isinstance(synonyms, str):
        return load_synonym_table(synonyms)
    if isinstance(synonyms, Mapping):
        return {w: frozenset(v) for w, v in synonyms.items()}
    return build_synonym_table(synonyms)


class MeteorScorer:
    """Corpus METEOR through `meteor_single`, the pure-Python scorer.

    `synonyms`: optional stage-3 synonym table — a file path (see
    load_synonym_table), a word->group-ids mapping, or an iterable of
    synset groups. Empty/None scores bit-identically to exact+stem."""

    def __init__(self, synonyms=None):
        self.synonyms = _normalize_synonyms(synonyms)

    def score(
        self,
        gts: Mapping[str, Sequence[str]],
        res: Mapping[str, Sequence[str]],
    ) -> tuple[float, list[float]]:
        per_key = []
        for key in res:
            if len(res[key]) != 1:
                raise ValueError("exactly one candidate per key expected")
            per_key.append(meteor_single(res[key][0], gts[key], synonyms=self.synonyms))
        corpus = sum(per_key) / len(per_key) if per_key else 0.0
        return corpus, per_key
