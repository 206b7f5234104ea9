"""Pack per-video feature files into the port's aligned feature directory.

The reference distributes pre-extracted features as directories of
per-video arrays (IRv2 appearance frames; I3D/C3D motion segments). The
port reads one aligned directory, `<corpus>/features/{app,motion,nframes}.npy`
(`data/features.py`: `app` [N, T, Da], `motion` [N, T, Dm] in info.json's
video order, `nframes` [N] each video's valid frames). This tool packs
either input layout:

  * a directory of `<video_id>.npy` files per stream, or
  * a single HDF5 file whose datasets are keyed by video id (h5py is
    imported only for this input).

Time axes are uniformly subsampled or zero-padded to --num_frames. A
timestep is valid where either stream has real data.

Counterpart of the JAX package's `tools/pack_features.py`, with its flags
and fitting rules; where that tool writes one `features.h5`, `--out` here
names the corpus directory, and the arrays go to `<out>/features/`. Each
video is fitted as it is read, so the raw per-video arrays are never all
held at once. Host code only.

Usage:
  python -m controllable_xgating_torch.tools.pack_features --info data/msrvtt/info.json \\
      --app_dir feats/irv2 --motion_dir feats/i3d --out data/msrvtt --num_frames 26
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from controllable_xgating_torch.data.features import FEATURES_DIR, _fit_frames, write_feature_dir


def _pack_stream(video_ids, num_frames: int, directory=None, h5file=None, key_format="{}"):
    """(fitted [N, num_frames, D] f32, raw frame counts [N]) of one stream."""
    h5 = None
    if h5file:
        import h5py  # only for an HDF5 input: the port itself reads no HDF5

        h5 = h5py.File(h5file, "r")
    out, lengths = None, np.zeros(len(video_ids), np.int64)
    try:
        for i, vid in enumerate(video_ids):
            if h5 is not None:
                arr = np.asarray(h5[key_format.format(vid)])
            else:
                arr = np.load(os.path.join(directory, f"{vid}.npy"))
            if arr.ndim == 1:
                arr = arr[None, :]
            arr = arr.astype(np.float32)
            if out is None:
                out = np.empty((len(video_ids), num_frames) + arr.shape[1:], np.float32)
            out[i] = _fit_frames(arr[None], num_frames)[0]
            lengths[i] = len(arr)
    finally:
        if h5 is not None:
            h5.close()
    return out, lengths


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--info", required=True, help="corpus info.json (video order)")
    p.add_argument("--app_dir")
    p.add_argument("--app_h5")
    p.add_argument("--motion_dir")
    p.add_argument("--motion_h5")
    p.add_argument("--out", required=True,
                   help="corpus directory: the arrays are written to <out>/features/")
    p.add_argument("--num_frames", type=int, default=26)
    args = p.parse_args(argv)

    with open(args.info) as f:
        video_ids = json.load(f)["video_ids"]

    if bool(args.app_dir) == bool(args.app_h5):
        p.error("give exactly one of --app_dir / --app_h5")
    if bool(args.motion_dir) == bool(args.motion_h5):
        p.error("give exactly one of --motion_dir / --motion_h5")

    t = args.num_frames
    app_arr, app_len = _pack_stream(video_ids, t, args.app_dir, args.app_h5)
    mot_arr, mot_len = _pack_stream(video_ids, t, args.motion_dir, args.motion_h5)
    # true valid timesteps after fitting: a stream longer than t is
    # subsampled (all t valid), a shorter one zero-padded. A timestep is
    # valid if EITHER stream has real data there: the shorter stream gives
    # zeros at its own padded steps (what the unaligned reference pipeline
    # fed), but attention and the summary never see all-pad steps.
    nframes = np.maximum(np.minimum(app_len, t), np.minimum(mot_len, t)).astype(np.int32)
    out = os.path.join(args.out, FEATURES_DIR)
    write_feature_dir(out, app_arr, mot_arr, nframes=nframes)
    print(json.dumps({
        "out": out,
        "videos": len(video_ids),
        "app_shape": list(app_arr.shape),
        "motion_shape": list(mot_arr.shape),
        "variable_length": int((nframes < t).sum()),
    }))


if __name__ == "__main__":
    main()
