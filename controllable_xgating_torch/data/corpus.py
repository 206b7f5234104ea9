"""Corpus metadata and label arrays, as the JAX package's prep writes them.

Counterpart of `SPLITS`, `CorpusInfo` and `load_labels` in
`controllable_xgating_tpu/data/corpus.py`:

  info.json   vocab lists, video ids and split assignment, shape metadata
  labels.npz  caps  int32 [num_videos, seqs_per_video, L]
              pos   int32 [num_videos, seqs_per_video, Lp]
              ncaps int32 [num_videos]  (real captions per video)

Not ported: `preprocess_corpus`, which tags captions with the Penn tagger
(it comes with `cli/prepro.py`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from controllable_xgating_torch.data.vocab import Vocab

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


def load_labels(out_dir: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(out_dir, "labels.npz")) as z:
        return {k: z[k] for k in z.files}
