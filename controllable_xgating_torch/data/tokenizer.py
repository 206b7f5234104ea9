"""Penn-Treebank tokenizer, pure Python.

The port's own copy of the JAX package's module of the same name, without
its dispatch to the native C++ library (the port imports nothing of that
package); tests/test_torch_metrics.py holds the two equal.

Rebuilds the vendored coco-caption PTBTokenizer (SURVEY.md §2 "PTBTokenizer"),
which shells out to the Stanford CoreNLP jar — no JVM exists in this
environment, so the well-known Penn Treebank `tokenizer.sed` rules (public
domain; the same rules NLTK's TreebankWordTokenizer codifies) are implemented
directly in regex form.

Behavioral contract mirrored from coco-caption's `ptbtokenizer.py`:
  * tokenize with PTB rules, with parenthesis/bracket normalization DISABLED
    (the coco invocation passes normalizeParentheses=false), so "(" stays "(",
  * lowercase everything,
  * drop pure punctuation tokens from a fixed list.

Known divergence (documented per SURVEY.md §2): Stanford's tokenizer has a
long tail of unicode/currency normalizations that coco disables anyway; for
ASCII caption corpora (MSR-VTT/MSVD) the outputs match PTB tokenization.
"""

from __future__ import annotations

import re
from typing import Iterable

# Punctuation tokens coco-caption's PTBTokenizer removes after tokenizing.
PUNCTUATIONS = {
    "''", "'", "``", "`", "(", ")", "{", "}", "[", "]",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# --- PTB tokenizer.sed rules, in application order ---------------------------
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period (plus optional closing quotes/brackets) split off
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = [
    # coco disables -LRB- style normalization: keep the literal characters,
    # just split them into their own tokens.
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
    (re.compile(r"--"), r" -- "),
]
_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# Common English contractions split as PTB does (cannot -> can not, etc.)
_CONTRACTIONS2 = [
    re.compile(pat, re.IGNORECASE)
    for pat in (
        r"\b(can)(not)\b",
        r"\b(d)('ye)\b",
        r"\b(gim)(me)\b",
        r"\b(gon)(na)\b",
        r"\b(got)(ta)\b",
        r"\b(lem)(me)\b",
        r"\b(more)('n)\b",
        r"\b(wan)(na)(?=\s)",
    )
]
_CONTRACTIONS3 = [
    re.compile(pat, re.IGNORECASE)
    for pat in (r" ('t)(is)\b", r" ('t)(was)\b")
]


class PTBTokenizer:
    """Penn Treebank word tokenizer with coco-caption post-processing."""

    def tokenize_raw(self, text: str) -> list[str]:
        """PTB tokenization only — no lowercasing / punctuation dropping."""
        for regexp, sub in _STARTING_QUOTES:
            text = regexp.sub(sub, text)
        for regexp, sub in _PUNCTUATION:
            text = regexp.sub(sub, text)
        for regexp, sub in _PARENS_BRACKETS:
            text = regexp.sub(sub, text)
        text = " " + text + " "
        for regexp, sub in _ENDING_QUOTES:
            text = regexp.sub(sub, text)
        for regexp in _CONTRACTIONS2:
            text = regexp.sub(r" \1 \2 ", text)
        for regexp in _CONTRACTIONS3:
            text = regexp.sub(r" \1 \2 ", text)
        return text.split()

    def tokenize(self, text: str) -> list[str]:
        """coco-caption behavior: tokenize, lowercase, drop punctuation."""
        return [
            tok.lower()
            for tok in self.tokenize_raw(text)
            if tok not in PUNCTUATIONS
        ]

    def tokenize_captions(
        self, captions_per_key: dict[str, Iterable[str]]
    ) -> dict[str, list[str]]:
        """coco-caption API shape: {key: [caption, ...]} -> {key: [joined, ...]}."""
        return {
            key: [" ".join(self.tokenize(c)) for c in caps]
            for key, caps in captions_per_key.items()
        }


_DEFAULT = PTBTokenizer()


def ptb_tokenize(text: str) -> list[str]:
    return _DEFAULT.tokenize(text)
