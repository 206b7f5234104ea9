"""Vocabulary: word<->id and POS-tag<->id maps with frequency thresholding.

The port's own copy of the JAX package's module of the same name (the port
imports nothing of that package); tests/test_torch_metrics.py holds the
two equal.

Rebuilds the reference's vocab-building prepro (SURVEY.md §2 "Corpus prep"):
count words over training captions, keep words with freq >= threshold, map
the rest to <unk>. Special ids are fixed so that padded int arrays are
directly usable on device: PAD=0 lets length masks be `tokens != 0`.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, Sequence

PAD = 0
BOS = 1
EOS = 2
UNK = 3

SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    def __init__(self, words: Sequence[str]):
        """`words` excludes specials; ids are assigned after the 4 specials."""
        self.idx_to_word = list(SPECIALS) + list(words)
        self.word_to_idx = {w: i for i, w in enumerate(self.idx_to_word)}
        if len(self.word_to_idx) != len(self.idx_to_word):
            raise ValueError("duplicate words in vocabulary")

    def __len__(self) -> int:
        return len(self.idx_to_word)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_idx

    def encode(self, tokens: Iterable[str]) -> list[int]:
        return [self.word_to_idx.get(t, UNK) for t in tokens]

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> list[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS and stop_at_eos:
                break
            if i in (PAD, BOS):
                continue
            out.append(self.idx_to_word[i])
        return out

    def decode_str(self, ids: Iterable[int]) -> str:
        return " ".join(self.decode(ids))

    @classmethod
    def build(
        cls, token_seqs: Iterable[Sequence[str]], min_freq: int = 2
    ) -> "Vocab":
        counts = Counter()
        for seq in token_seqs:
            counts.update(seq)
        kept = sorted(
            (w for w, c in counts.items() if c >= min_freq and w not in SPECIALS),
            key=lambda w: (-counts[w], w),
        )
        return cls(kept)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"idx_to_word": self.idx_to_word}, f)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            data = json.load(f)
        idx_to_word = data["idx_to_word"]
        if tuple(idx_to_word[:4]) != SPECIALS:
            raise ValueError("vocab file missing special tokens header")
        return cls(idx_to_word[4:])

    def to_list(self) -> list[str]:
        return list(self.idx_to_word)

    @classmethod
    def from_list(cls, idx_to_word: list[str]) -> "Vocab":
        if tuple(idx_to_word[:4]) != SPECIALS:
            raise ValueError("vocab list missing special tokens header")
        return cls(idx_to_word[4:])


def pad_encode(
    vocab: Vocab,
    tokens: Sequence[str],
    max_len: int,
    add_bos: bool = True,
    add_eos: bool = True,
) -> list[int]:
    """Encode to a fixed-length id sequence: [BOS] toks [EOS] [PAD]*.

    Truncates tokens so BOS/EOS always fit — the on-device decoders assume
    every non-pad sequence terminates with EOS.
    """
    ids = vocab.encode(tokens)
    body = max_len - int(add_bos) - int(add_eos)
    ids = ids[:body]
    seq = ([BOS] if add_bos else []) + ids + ([EOS] if add_eos else [])
    seq += [PAD] * (max_len - len(seq))
    return seq
