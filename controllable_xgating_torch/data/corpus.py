"""Offline corpus preprocessing: captions -> vocab + POS + label arrays.

Counterpart of `controllable_xgating_tpu/data/corpus.py` (`SPLITS`,
`CorpusInfo`, `preprocess_corpus`, `load_labels`), writing the same
files (tests/test_torch_corpus.py): build a word vocab with a frequency
threshold, PTB-tokenize and lowercase every caption, POS-tag it, build the
POS vocab, and emit fixed-shape label arrays (SURVEY.md §2 "Corpus prep"):

  info.json   vocab lists, video ids and split assignment, shape metadata
  labels.npz  caps  int32 [num_videos, seqs_per_video, L]
              pos   int32 [num_videos, seqs_per_video, Lp]
              ncaps int32 [num_videos]  (real captions per video)

All arrays are statically shaped (PAD = 0); `ncaps` and the PAD masks
recover raggedness.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from controllable_xgating_torch.data.postag import PENN_TAGS, PennTagger
from controllable_xgating_torch.data.tokenizer import PTBTokenizer
from controllable_xgating_torch.data.vocab import Vocab, pad_encode

SPLITS = ("train", "val", "test")


@dataclass
class CorpusInfo:
    vocab: Vocab
    pos_vocab: Vocab
    video_ids: list[str]
    splits: dict[str, list[int]]  # split -> video indices
    max_caption_len: int
    max_pos_len: int
    seqs_per_video: int

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "vocab": self.vocab.to_list(),
                    "pos_vocab": self.pos_vocab.to_list(),
                    "video_ids": self.video_ids,
                    "splits": self.splits,
                    "max_caption_len": self.max_caption_len,
                    "max_pos_len": self.max_pos_len,
                    "seqs_per_video": self.seqs_per_video,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "CorpusInfo":
        with open(path) as f:
            d = json.load(f)
        return cls(
            vocab=Vocab.from_list(d["vocab"]),
            pos_vocab=Vocab.from_list(d["pos_vocab"]),
            video_ids=d["video_ids"],
            splits={k: list(v) for k, v in d["splits"].items()},
            max_caption_len=d["max_caption_len"],
            max_pos_len=d["max_pos_len"],
            seqs_per_video=d["seqs_per_video"],
        )


def preprocess_corpus(
    captions: Mapping[str, Sequence[str]],
    splits: Mapping[str, Sequence[str]],
    out_dir: str,
    min_word_freq: int = 2,
    max_caption_len: int = 28,
    seqs_per_video: int = 20,
    tagger=None,
    vocab: Vocab | None = None,
) -> CorpusInfo:
    """Run the full offline prep and write info.json + labels.npz.

    Args:
      captions: raw {video_id: [caption strings]} over ALL splits.
      splits: {"train"|"val"|"test": [video_id, ...]}.
      max_caption_len: fixed array length INCLUDING BOS and EOS slots.
      tagger: object with `.tag(tokens) -> tags` (default: the rule-based
        `PennTagger`; pass a trained `PerceptronTagger` for domain corpora).
        If it exposes a `.tags` tagset (the perceptron does), the POS vocab
        is built from THAT tagset instead of the closed Penn list.
      vocab: adopt this existing vocabulary (id order and all) instead of
        building one from the train captions. This is the "score new data
        with the training vocab" path: a checkpoint's embedding/projection
        rows are tied to its training corpus's word ids, so any corpus it
        is evaluated on must index words identically. Words outside the
        adopted vocab encode as UNK (exactly how unseen test words behave
        under the reference's train-built vocab).
    """
    os.makedirs(out_dir, exist_ok=True)
    tokenizer = PTBTokenizer()
    if tagger is None:
        tagger = PennTagger()

    video_ids = [vid for s in SPLITS for vid in splits.get(s, ())]
    if len(set(video_ids)) != len(video_ids):
        raise ValueError("video ids appear in more than one split")
    missing = [v for v in video_ids if v not in captions]
    if missing:
        raise ValueError(f"captions missing for videos: {missing[:5]}...")

    # Tokenize + tag everything once.
    tokenized: dict[str, list[list[str]]] = {}
    tagged: dict[str, list[list[str]]] = {}
    for vid in video_ids:
        toks = [tokenizer.tokenize(c) for c in captions[vid]]
        toks = [t for t in toks if t][:seqs_per_video]
        tokenized[vid] = toks
        tagged[vid] = [tagger.tag(t) for t in toks]

    if vocab is None:
        # Vocab from TRAIN captions only (reference behavior: test words
        # unseen).
        train_ids = set(splits.get("train", ()))
        vocab = Vocab.build(
            (t for vid in video_ids if vid in train_ids
             for t in tokenized[vid]),
            min_freq=min_word_freq,
        )
    # POS vocab: the full closed Penn tagset by default (stable across
    # corpora); a trained tagger's own tagset when it exposes one.
    custom_tagset = getattr(tagger, "tags", None)
    pos_vocab = Vocab(sorted(custom_tagset) if custom_tagset
                      else list(PENN_TAGS))

    num_videos = len(video_ids)
    caps = np.zeros((num_videos, seqs_per_video, max_caption_len), np.int32)
    pos = np.zeros((num_videos, seqs_per_video, max_caption_len), np.int32)
    ncaps = np.zeros((num_videos,), np.int32)
    for i, vid in enumerate(video_ids):
        ncaps[i] = len(tokenized[vid])
        for j, (toks, tags) in enumerate(zip(tokenized[vid], tagged[vid])):
            caps[i, j] = pad_encode(vocab, toks, max_caption_len)
            pos[i, j] = pad_encode(pos_vocab, tags, max_caption_len)

    index_of = {vid: i for i, vid in enumerate(video_ids)}
    info = CorpusInfo(
        vocab=vocab,
        pos_vocab=pos_vocab,
        video_ids=video_ids,
        splits={s: [index_of[v] for v in splits.get(s, ())] for s in SPLITS},
        max_caption_len=max_caption_len,
        max_pos_len=max_caption_len,
        seqs_per_video=seqs_per_video,
    )
    info.save(os.path.join(out_dir, "info.json"))
    np.savez(
        os.path.join(out_dir, "labels.npz"), caps=caps, pos=pos, ncaps=ncaps
    )
    return info


def load_labels(out_dir: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(out_dir, "labels.npz")) as z:
        return {k: z[k] for k in z.files}
