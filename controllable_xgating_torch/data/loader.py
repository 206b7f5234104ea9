"""Train and evaluation batches from any feature store.

Counterpart of `TrainBatchIterator` and `eval_batches` in
`controllable_xgating_tpu/data/loader.py`, without its HDF5 `FeatureStore`
import: a store is anything with `get_batch(indices) -> (app, motion)` and
`frame_mask(indices) -> mask or None`, over numpy arrays. Batches are
numpy; the train step moves them to the card. The same seed draws the
same batches as the JAX package's iterator.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class TrainBatchIterator:
    """Infinite shuffled iterator of XE train batches, K captions per video
    (`caps_per_video`, sampled without replacement where a video has at
    least K)."""

    def __init__(
        self,
        store,
        caps: np.ndarray,    # [N, S, L]
        pos: np.ndarray,     # [N, S, L]
        ncaps: np.ndarray,   # [N]
        video_indices: np.ndarray,
        batch_size: int,
        caps_per_video: int,
        seed: int = 0,
    ):
        self.store = store
        self.caps = caps
        self.pos = pos
        self.ncaps = ncaps
        self.video_indices = np.asarray(video_indices, np.int64)
        self.batch_size = batch_size
        self.caps_per_video = caps_per_video
        self.rng = np.random.default_rng(seed)
        if len(self.video_indices) == 0:
            raise ValueError("empty split")

    def __iter__(self) -> Iterator[dict]:
        while True:
            perm = self.rng.permutation(self.video_indices)
            # wrap the tail so every batch has the same size
            pad = (-len(perm)) % self.batch_size
            if pad:
                perm = np.concatenate([perm, perm[:pad]])
            for i in range(0, len(perm), self.batch_size):
                yield self._make_batch(perm[i : i + self.batch_size])

    def _make_batch(self, vids: np.ndarray) -> dict:
        app, motion = self.store.get_batch(vids)
        b, k = len(vids), self.caps_per_video
        caps = np.empty((b, k) + self.caps.shape[2:], self.caps.dtype)
        pos = np.empty_like(caps)
        for row, v in enumerate(vids):
            n = max(int(self.ncaps[v]), 1)
            sel = self.rng.choice(n, k, replace=False) if n >= k else self.rng.integers(0, n, k)
            caps[row] = self.caps[v, sel]
            pos[row] = self.pos[v, sel]
        batch = {
            "app": app,
            "motion": motion,
            "caps": caps.astype(np.int32),
            "pos": pos.astype(np.int32),
            "video_indices": vids.astype(np.int32),
        }
        mask = self.store.frame_mask(vids)
        if mask is not None:
            batch["frame_mask"] = mask
        return batch

    def steps_per_epoch(self) -> int:
        return -(-len(self.video_indices) // self.batch_size)


def eval_batches(store, video_indices: np.ndarray, batch_size: int) -> Iterator[dict]:
    """Fixed-order eval batches; the last one padded with repeats, and
    `num_valid` says how many rows are real."""
    video_indices = np.asarray(video_indices, np.int64)
    for i in range(0, len(video_indices), batch_size):
        chunk = video_indices[i : i + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - valid)])
        app, motion = store.get_batch(chunk)
        batch = {
            "app": app,
            "motion": motion,
            "video_indices": chunk.astype(np.int32),
            "num_valid": valid,
        }
        mask = store.frame_mask(chunk)
        if mask is not None:
            batch["frame_mask"] = mask
        yield batch
