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

`PrefetchIterator` (with `DevicePut` as its put function on the card)
overlaps the train loop's batch assembly and host-to-device copy with the
step, as the JAX package's does; the split evaluation's batch caller
(`infer/evaluator.py::batch_caller`) puts each batch through a `DevicePut`
of its own.
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

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


# the keys the train steps take (`_BATCH_KEYS` of train/xe.py and train/scst.py)
STEP_KEYS = ("app", "motion", "caps", "pos", "frame_mask", "video_indices")


class StagedBatch:
    """A batch whose step tensors are being copied to a card on a side
    stream (`DevicePut`); `ready()` hands it to the consumer."""

    __slots__ = ("batch", "event", "copied", "device")

    def __init__(self, batch: dict, event, copied: list, device: torch.device):
        self.batch, self.event, self.copied, self.device = batch, event, copied, device

    def ready(self) -> dict:
        """The batch, safe to use on the calling thread's current stream:
        that stream waits for the copies, and the copies' memory is not
        reused before its work on them is done."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.copied:
            t.record_stream(stream)
        return self.batch


class DevicePut:
    """The put function of the train loop's prefetch and of the split
    evaluation's batch caller: a host batch -> the same dict with its
    `STEP_KEYS` (the steps' inputs) as tensors on `device`; other keys
    stay as they are.

    On a card each array is copied into a pinned host buffer and sent with
    `non_blocking=True` on a side stream of the card, and an event is
    recorded after the copies: the result is a `StagedBatch`, which
    `PrefetchIterator` readies on the consumer's side. The pinned buffers
    are kept and reused, `STAGING` sets of them in turn; a set is written
    again only after the event of its last copies has passed. There is no
    fallback: a copy that fails raises. One caller at a time (the
    prefetch's worker, or the batch caller's thread). On the CPU the
    arrays become tensors that share their memory."""

    STAGING = 2

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = None
        # per set: ({key: pinned tensor}, the event of its last copies)
        self._staging = [({}, None) for _ in range(self.STAGING)]
        self._turn = 0

    def _pinned(self, bufs: dict, key: str, src: torch.Tensor) -> torch.Tensor:
        buf = bufs.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = bufs[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        return buf.copy_(src)

    def __call__(self, batch: dict):
        keys = [k for k in STEP_KEYS if batch.get(k) is not None]
        if self.device.type != "cuda":
            return {**batch, **{k: torch.as_tensor(batch[k], device=self.device) for k in keys}}
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            bufs, last = self._staging[self._turn]
            if last is not None:
                last.synchronize()  # the set's earlier copies have left it
            out, copied = dict(batch), []
            with torch.cuda.stream(self._stream):
                for k in keys:
                    src = self._pinned(bufs, k, torch.as_tensor(batch[k]))
                    out[k] = src.to(self.device, non_blocking=True)
                    copied.append(out[k])
                event = torch.cuda.Event()
                event.record(self._stream)
            self._staging[self._turn] = (bufs, event)
            self._turn = (self._turn + 1) % self.STAGING
        return StagedBatch(out, event, copied, self.device)


def _ready(item):
    return item.ready() if isinstance(item, StagedBatch) else item


def put_now(put_fn, batch: dict) -> dict:
    """`put_fn(batch)` on the calling thread, ready to use there."""
    return _ready(put_fn(batch))


class PrefetchIterator:
    """Wrap a host batch iterator: a worker thread draws batches and puts
    them (`put_fn`, e.g. `DevicePut`) into a bounded queue of `depth`,
    so that assembly and the host-to-device copy overlap the consumer's
    step (counterpart of the JAX package's `PrefetchIterator`).

    A worker error is raised on the consumer's side. `close()` stops and
    joins the worker; it is idempotent, and a `with` block calls it.

    The number of batches drawn from the source does not depend on
    timing: when `close()` returns, the worker has drawn exactly
    `consumed + depth + 1` batches (the queue full and one more in hand,
    the JAX worker's steady state), or the source has ended. Batches
    drawn past the queue at close are dropped unput. A source that draws
    from a random stream, as `TrainBatchIterator` does, so leaves it in
    the same state after every run, the JAX loop's state: the next loop
    over the same iterator gets the JAX loop's batches."""

    def __init__(self, batches: Iterator, put_fn=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._put = put_fn or (lambda x: x)
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._drawn = self._consumed = self._target = 0
        self._closed = self._done = False
        self._thread = threading.Thread(target=self._worker, args=(iter(batches),), daemon=True)
        self._thread.start()

    @property
    def drawn(self) -> int:
        """Batches the worker has drawn from the source so far."""
        return self._drawn

    @property
    def queued(self) -> int:
        """Batches put and waiting in the queue now."""
        return self._q.qsize()

    def _worker(self, batches: Iterator) -> None:
        try:
            while not (self._stop.is_set() and self._drawn >= self._target):
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                self._drawn += 1
                if self._stop.is_set():
                    continue  # drawing up to close()'s count: nothing is put
                self._offer(self._put(batch))
        except BaseException as e:  # raised on the consumer's side
            self._err = e
        finally:
            self._offer(_SENTINEL)

    def _offer(self, item) -> None:
        """A bounded put that stays responsive to close() (after which the
        item is dropped)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Let the worker draw up to `consumed + depth + 1` batches (or
        the source's end), stop it and join it. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._target = self._consumed + self._depth + 1
        self._stop.set()
        self._drain()  # unblock a worker on a full queue
        self._thread.join()
        self._drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._closed:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._consumed += 1
        return _ready(item)


_SENTINEL = object()


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
