"""Full-scale synthetic dress rehearsal of the real-data ingest path.

Real downloads are not available offline, so this script synthesizes an
MSR-VTT-sized corpus in the release formats the reference consumes and
pushes it through the port's public pipeline:

  1. videodatainfo.json       (10k videos, 20 sentences each, MSR-VTT splits
                               6513/497/2990, vocab >= 10k words after the
                               min-freq-2 threshold)
  2. per-video feature files, one directory of `<video_id>.npy` per stream,
     variable clip lengths
  3. tools/convert_msrvtt     -> captions.json + splits.json
  4. cli/prepro               -> vocab, POS tags, labels.npz
  5. tools/pack_features      -> aligned features/ (+ nframes)
  6. cli/train --epochs 1     -> one XE epoch + greedy val eval on --device
  7. (--scst) cli/train --stage scst --epochs 1 from the XE checkpoint

and prints one JSON line per stage with wall-clock seconds and the
process's peak RSS so far (GB, `PeakRss`); the train stages' lines
also carry the kernel launches of the stage (0 on the CPU, where the
plain versions run).
Arguments it does not know are passed to both train stages as config
overrides (`--section.field value`, e.g. `--train.log_every_steps 1`).

Counterpart of the JAX package's `examples/dress_rehearsal.py`, with its
stages, seeds, synthesis and vocab-threshold assertion. One deliberate
difference: the features are synthesized as per-video `.npy` directories,
not as per-stream HDF5 files keyed by id, because the card's machine has
no h5py (`tools/pack_features` packs both). The arrays are the JAX
script's, draw for draw. The peak RSS is sampled from /proc's VmRSS
where it exists (the JAX script reads getrusage, which reports a large
parent process's peak when one starts the rehearsal). Without `--out` the
corpus goes to a temporary directory that is deleted at the end (the
full scale writes ~5 GB).

Usage:
  python -m controllable_xgating_torch.tools.dress_rehearsal              # full, on the card
  python -m controllable_xgating_torch.tools.dress_rehearsal --out /tmp/r --videos 300 \\
      --app_dim 64 --motion_dim 32 --device cpu                          # smoke
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import threading
import time

import numpy as np

from controllable_xgating_torch.data.fixtures import ACTIONS, PLACES, SUBJECTS

RARE_LEXICON = 12000  # distinct rare nouns, each guaranteed >= 2 uses


def _rss_kb(field: str = "VmRSS"):
    """A field of /proc/self/status in kB, or None where there is none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class PeakRss:
    """This process's peak resident set: the largest VmRSS that a daemon
    thread reads from /proc every `interval` s (a spike shorter than that
    can be missed). Neither getrusage's ru_maxrss nor, on some kernels,
    /proc's VmHWM starts anew at exec: both can report the peak of a large
    process that started this one. Without /proc: ru_maxrss."""

    def __init__(self, interval: float = 0.05):
        self._peak_kb = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        if _rss_kb() is not None:
            self._thread = threading.Thread(target=self._sample, args=(interval,), daemon=True)
            self._thread.start()

    def _update(self) -> None:
        kb = _rss_kb() or 0
        with self._lock:
            self._peak_kb = max(self._peak_kb, kb)

    def _sample(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self._update()

    def gb(self) -> float:
        if self._thread is None:
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        self._update()
        return self._peak_kb / 1e6

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


def _stage(name, results, rss: PeakRss, launches: bool = False):
    class _Ctx:
        def __enter__(self):
            if launches:
                from controllable_xgating_torch.ops import kernels

                kernels.reset_launch_counts()
            self.t0 = time.time()
            return self

        def __exit__(self, *exc):
            dt = time.time() - self.t0
            entry = {"stage": name, "seconds": round(dt, 2),
                     "peak_rss_gb": round(rss.gb(), 2)}
            if launches:
                from controllable_xgating_torch.ops import kernels

                entry["launches"] = kernels.launch_counts()
            results.append(entry)
            print(json.dumps(entry), flush=True)

    return _Ctx()


def synthesize_videodatainfo(path: str, num_videos: int, caps_per_video: int,
                             seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    n_train = int(num_videos * 0.6513)
    n_val = int(num_videos * 0.0497)
    videos, sentences = [], []
    rare_cursor = 0
    # effective lexicon shrinks with the corpus so every rare word still
    # appears >= 2 times at smoke-test scales
    lex = max(min(RARE_LEXICON, num_videos * caps_per_video // 2), 1)
    for i in range(num_videos):
        split = ("train" if i < n_train else
                 "validate" if i < n_train + n_val else "test")
        vid = f"video{i}"
        videos.append({"video_id": vid, "split": split, "id": i})
        subj = SUBJECTS[int(rng.integers(len(SUBJECTS)))]
        act = ACTIONS[int(rng.integers(len(ACTIONS)))]
        place = PLACES[int(rng.integers(len(PLACES)))]
        for k in range(caps_per_video):
            # cycle the rare lexicon twice so >= RARE_LEXICON words survive
            # the min-freq-2 vocab threshold; Zipf tail after that (some
            # words appear once and must be pruned to <unk> — the behavior
            # under test). Consecutive uses are paired (// 2) so both
            # occurrences of a rare word land in the SAME video: the vocab
            # is counted over the train split only.
            if rare_cursor < 2 * lex:
                widx = (rare_cursor // 2) % lex
            else:
                widx = min(int(rng.zipf(1.3)) - 1, lex - 1)
            rare_cursor += 1
            rare = f"zq{widx:05d}"  # unseen-by-grammar noun shape
            verb = act[0] if k % 2 == 0 else act[1]
            parts = [subj[k % len(subj)], verb]
            if act[2]:
                parts.append(act[2])
            parts += ["near the", rare]
            if place:
                parts.append(place)
            sentences.append({"video_id": vid, "caption": " ".join(parts),
                              "sen_id": len(sentences)})
    with open(path, "w") as f:
        json.dump({"videos": videos, "sentences": sentences}, f)


def synthesize_stream_dir(directory: str, num_videos: int, dim: int,
                          min_t: int, max_t: int, seed: int) -> None:
    """Per-video variable-length features, one `<video_id>.npy` each
    (pack_features input); the JAX script's draws. Low-rank generation
    keeps synthesis cheap at 10k x ~26 x 1536."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(64, dim)).astype(np.float32)
    for i in range(num_videos):
        t = int(rng.integers(min_t, max_t + 1))
        coeff = rng.normal(size=(t, 64)).astype(np.float32) * 0.3
        np.save(os.path.join(directory, f"video{i}.npy"), coeff @ basis)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None,
                   help="corpus directory to keep (default: a temporary one, deleted at the end)")
    p.add_argument("--videos", type=int, default=10000)
    p.add_argument("--caps_per_video", type=int, default=20)
    p.add_argument("--app_dim", type=int, default=1536)
    p.add_argument("--motion_dim", type=int, default=1024)
    p.add_argument("--num_frames", type=int, default=26)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the train stages run (default: the card; cpu only when asked)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--scst", action="store_true",
                   help="also run one SCST epoch from the XE checkpoint: exercises the "
                        "reward tables at full corpus scale")
    args, overrides = p.parse_known_args(argv)

    from controllable_xgating_torch.cli.common import die
    from controllable_xgating_torch.utils.config import parse_cli_overrides

    parse_cli_overrides(overrides)  # refuse a malformed override before any work
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            die("--device cuda: no CUDA device is available; pass --device cpu to run on the CPU")

    out = args.out or tempfile.mkdtemp(prefix="cxg_rehearsal_")
    rss = PeakRss()
    try:
        _rehearse(args, out, overrides, rss)
    finally:
        rss.close()
        if not args.out:
            shutil.rmtree(out, ignore_errors=True)


def _rehearse(args, out: str, overrides: list, rss: PeakRss) -> None:
    from controllable_xgating_torch.cli import prepro
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.tools import convert_msrvtt, pack_features

    os.makedirs(out, exist_ok=True)
    results: list = []
    vdi = os.path.join(out, "videodatainfo.json")
    app_dir = os.path.join(out, "app_stream")
    mot_dir = os.path.join(out, "motion_stream")

    with _stage("synthesize_annotations", results, rss):
        synthesize_videodatainfo(vdi, args.videos, args.caps_per_video)

    with _stage("synthesize_features", results, rss):
        synthesize_stream_dir(app_dir, args.videos, args.app_dim, 10, 40, 1)
        synthesize_stream_dir(mot_dir, args.videos, args.motion_dim, 8, 30, 2)

    caps_json = os.path.join(out, "captions.json")
    splits_json = os.path.join(out, "splits.json")
    with _stage("convert_msrvtt", results, rss):
        convert_msrvtt.main([
            "--videodatainfo", vdi,
            "--out_captions", caps_json, "--out_splits", splits_json,
        ])

    with _stage("prepro", results, rss):
        prepro.main([
            "--out", out, "--captions", caps_json,
            "--splits", splits_json, "--min_word_freq", "2",
        ])
    with open(os.path.join(out, "info.json")) as f:
        info = json.load(f)
    # rare words that lie fully inside the train split must survive the
    # min-freq-2 threshold (vocab counts train captions only)
    train_caps = int(args.videos * 0.6513) * args.caps_per_video
    expected = min(
        max(min(RARE_LEXICON, args.videos * args.caps_per_video // 2), 1),
        train_caps // 2,
    )
    if len(info["vocab"]) < 0.9 * expected:
        raise AssertionError(
            f"vocab threshold behavior broke: {len(info['vocab'])} < ~{expected}")

    with _stage("pack_features", results, rss):
        pack_features.main([
            "--info", os.path.join(out, "info.json"),
            "--app_dir", app_dir, "--motion_dir", mot_dir,
            "--out", out, "--num_frames", str(args.num_frames),
        ])

    if not args.skip_train:
        ck = os.path.join(out, "ck")
        common = ["--data_dir", out, "--checkpoint_dir", ck, "--device", args.device,
                  "--data.batch_size", str(args.batch_size),
                  "--eval.select_decode", "greedy"]
        with _stage("xe_epoch_plus_eval", results, rss, launches=True):
            cli_train.main([*common, "--stage", "joint", "--epochs", "1", *overrides])

        if args.scst:
            with _stage("scst_epoch", results, rss, launches=True):
                cli_train.main([*common, "--stage", "scst", "--epochs", "1",
                                "--init_from", os.path.join(ck, "joint"),
                                "--train.lr", "5e-5", *overrides])

    print(json.dumps({"stage": "TOTAL", "vocab_size": len(info["vocab"]),
                      "videos": args.videos,
                      "seconds": round(sum(r["seconds"] for r in results), 2),
                      "peak_rss_gb": max(r["peak_rss_gb"] for r in results)}))


if __name__ == "__main__":
    main()
