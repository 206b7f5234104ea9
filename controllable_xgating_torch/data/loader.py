"""Evaluation batches from any feature store.

Counterpart of `eval_batches` in `controllable_xgating_tpu/data/loader.py`,
without its HDF5 `FeatureStore` import: a store is anything with
`get_batch(indices) -> (app, motion)` and `frame_mask(indices) -> mask or
None`, over numpy arrays.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
