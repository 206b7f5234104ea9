"""Batches of pre-extracted video features for offline captioning.

A mix's parameters (`traffic/<mix>.json`): `batch` videos a call,
`frames` per video (every frame valid), and `pool` distinct batches that
the window cycles through. Appearance and motion features are N(0, 1)
f32 draws at the configuration's widths, from the seed: the same seed
gives the same batches, and every seed the same sizes.

Pooled IRv2 and I3D features are non-negative, but under random weights,
which have learned nothing of the features, non-negative draws share a
mean that makes every video's encoding alike, and on some weight draws
every caption ends after a few words, so the work changes with the seed;
N(0, 1) keeps the videos distinct and every beam running to the last step.
"""

from __future__ import annotations

import numpy as np


def make(mix: dict, model: dict, seed: int) -> list:
    """[(app [B, T, Da], motion [B, T, Dm])] * pool, f32 host arrays."""
    rng = np.random.default_rng(seed)
    b, t = int(mix["batch"]), int(mix["frames"])
    if t != int(model["num_frames"]):
        raise ValueError(f"mix frames {t} != the configuration's num_frames {model['num_frames']}")
    return [(rng.standard_normal((b, t, int(model["app_dim"])), dtype=np.float32),
             rng.standard_normal((b, t, int(model["motion_dim"])), dtype=np.float32))
            for _ in range(int(mix["pool"]))]
