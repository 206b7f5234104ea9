"""Feature store without HDF5: per-video appearance and motion arrays.

Counterpart of `controllable_xgating_tpu/data/features.py` (`FeatureStore`,
`write_feature_file`, `_fit_frames`), on a layout numpy reads alone, so
the card's machine needs no h5py:

    <data_dir>/features/app.npy      [N, T, Da] f32
    <data_dir>/features/motion.npy   [N, T, Dm] f32
    <data_dir>/features/nframes.npy  [N] i32, optional (each video's valid
                                     frames; without it every frame is valid)

all written with `np.save`, aligned with info.json's video order. The time
axis is padded with zeros or uniformly subsampled to `num_frames`, and the
stored counts become frame masks, by the JAX store's rules.

Convert the JAX package's `features.h5` into this layout where that file
lives (the one place the port reads HDF5; h5py is imported in `main` only):

    python -m controllable_xgating_torch.data.features <data_dir>
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

FEATURES_DIR = "features"


def write_feature_dir(
    path: str,
    app: np.ndarray,
    motion: np.ndarray,
    nframes: Optional[np.ndarray] = None,
) -> None:
    """Write an aligned feature directory: app [N, T, Da], motion [N, T, Dm]
    and, optionally, `nframes` [N], each video's true number of valid
    timesteps (its tail is zero padding), with `write_feature_file`'s
    checks."""
    if app.shape[:2] != motion.shape[:2]:
        raise ValueError("app/motion must align on (num_videos, num_frames)")
    if nframes is not None:
        nframes = np.asarray(nframes, np.int32)
        if nframes.shape != (app.shape[0],):
            raise ValueError("nframes must be [num_videos]")
        if nframes.max(initial=0) > app.shape[1] or nframes.min(initial=1) < 1:
            raise ValueError("nframes values must be in [1, num_frames]")
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "app.npy"), np.asarray(app, np.float32))
    np.save(os.path.join(path, "motion.npy"), np.asarray(motion, np.float32))
    counts = os.path.join(path, "nframes.npy")
    if nframes is not None:
        np.save(counts, nframes)
    elif os.path.exists(counts):  # rewriting a directory: no stale counts
        os.remove(counts)


class FeatureStore:
    """Per-video feature arrays from a feature directory, fitted to
    `num_frames`; held in RAM (default) or read through memory maps."""

    def __init__(self, path: str, num_frames: int, in_memory: bool = True):
        self.path = path
        self.num_frames = num_frames
        mode = None if in_memory else "r"
        app = np.load(os.path.join(path, "app.npy"), mmap_mode=mode)
        motion = np.load(os.path.join(path, "motion.npy"), mmap_mode=mode)
        if app.shape[:2] != motion.shape[:2]:
            raise ValueError(f"{path}: app {app.shape} and motion {motion.shape} do not align")
        self.num_videos, t, self.app_dim = app.shape
        self.motion_dim = motion.shape[2]
        self.frame_counts: Optional[np.ndarray] = None
        counts_path = os.path.join(path, "nframes.npy")
        if os.path.exists(counts_path):
            # stored counts refer to the on-disk time axis; subsampling keeps
            # the valid frames a prefix, so the count after fitting is how
            # many subsample indices land inside the valid prefix
            counts = np.asarray(np.load(counts_path), np.int32)
            if t > num_frames:
                idx = np.linspace(0, t - 1, num_frames).round().astype(np.int64)
                counts = (idx[None, :] < counts[:, None]).sum(1).astype(np.int32)
            self.frame_counts = np.maximum(counts, 1)
        if in_memory:
            app, motion = _fit_frames(app, num_frames), _fit_frames(motion, num_frames)
        self._app, self._motion = app, motion
        self._fitted = in_memory

    def get_batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Gather features for a batch of video indices -> (app, motion)."""
        indices = np.asarray(indices)
        if self._fitted:
            return self._app[indices], self._motion[indices]
        return (_fit_frames(self._app[indices], self.num_frames),
                _fit_frames(self._motion[indices], self.num_frames))

    def frame_mask(self, indices: np.ndarray) -> Optional[np.ndarray]:
        """[B, T] 1.0/0.0 validity mask, or None if the store has no
        per-video frame counts (every frame valid)."""
        if self.frame_counts is None:
            return None
        counts = self.frame_counts[np.asarray(indices)]
        return (np.arange(self.num_frames)[None, :] < counts[:, None]).astype(np.float32)


def _fit_frames(x: np.ndarray, num_frames: int) -> np.ndarray:
    """Pad (zeros) or uniformly subsample the time axis to num_frames."""
    n, t = x.shape[:2]
    if t == num_frames:
        return np.ascontiguousarray(x, dtype=np.float32)
    if t > num_frames:
        idx = np.linspace(0, t - 1, num_frames).round().astype(np.int64)
        return np.ascontiguousarray(x[:, idx], dtype=np.float32)
    out = np.zeros((n, num_frames) + x.shape[2:], np.float32)
    out[:, :t] = x
    return out


def main(argv=None) -> None:
    """Convert `<data_dir>/features.h5` (datasets app, motion and optional
    nframes) into `<data_dir>/features/`."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("data_dir", help="corpus directory holding features.h5")
    args = p.parse_args(argv)
    import h5py  # only here: the port itself never reads HDF5

    src = os.path.join(args.data_dir, "features.h5")
    out = os.path.join(args.data_dir, FEATURES_DIR)
    with h5py.File(src, "r") as f:
        nframes = np.asarray(f["nframes"]) if "nframes" in f else None
        write_feature_dir(out, f["app"][:], f["motion"][:], nframes)
    print(f"wrote {out} from {src}")


if __name__ == "__main__":
    main()
