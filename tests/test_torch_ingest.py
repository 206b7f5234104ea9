"""The port's ingest tools vs the JAX package's, on the CPU.

`tools/convert_msrvtt.py` (both annotation formats) and
`tools/pack_features.py` (per-video `.npy` directories and id-keyed HDF5
inputs) run on the same inputs in both packages: the JSON outputs must be
equal, and the port's `features/{app,motion,nframes}.npy` equal to the
JAX tool's `features.h5` bit for bit. The dress rehearsal
(`examples/dress_rehearsal.py`, `--skip_train`) and the port's
`tools/dress_rehearsal.py` synthesize the same corpus at smoke scale: the
port's info.json, labels and packed features must equal the JAX run's;
the port's train stages (XE, then SCST) run on it on the CPU and give
finite losses.
"""

import contextlib
import importlib.util
import io
import json
import os

import h5py
import numpy as np
import pytest

from controllable_xgating_torch.tools import convert_msrvtt as t_convert
from controllable_xgating_torch.tools import dress_rehearsal as t_rehearsal
from controllable_xgating_torch.tools import pack_features as t_pack
from tools import convert_msrvtt as j_convert
from tools import pack_features as j_pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# narrow widths for the rehearsal's train stages on the CPU (the corpus
# itself is synthesized at the tool's own smoke scale)
SMALL_TRAIN = ["--model.hidden_dim", "24", "--model.embed_dim", "16", "--model.attn_dim", "16",
               "--model.pos_embed_dim", "16", "--data.caps_per_video_train", "2",
               "--eval.max_decode_len", "12", "--train.log_every_steps", "1"]


def quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


VIDEODATAINFO = {
    "videos": [
        {"video_id": "video0", "split": "train"},
        {"video_id": "video1", "split": "validate"},
        {"video_id": "video2", "split": "test"},
        {"video_id": "video3"},  # no split: train
    ],
    "sentences": [
        {"video_id": "video0", "caption": "a man runs."},
        {"video_id": "video0", "caption": "a guy is running."},
        {"video_id": "video1", "caption": "a dog swims."},
        {"video_id": "video2", "caption": "a cat sleeps."},
        {"video_id": "video3", "caption": "two women talk"},
    ],
}
MSVD = ("vidA\ta man runs.\nvidA\ta guy jogs.\nvidB\ta dog swims.\n\n"
        "vidC a cat sleeps.\nvidD\tthe sun sets\n")


@pytest.mark.parametrize("fmt", ["videodatainfo", "msvd"])
def test_convert_matches_jax(tmp_path, fmt):
    if fmt == "videodatainfo":
        src = tmp_path / "videodatainfo.json"
        src.write_text(json.dumps(VIDEODATAINFO))
        args = ["--videodatainfo", str(src)]
    else:
        src = tmp_path / "msvd.txt"
        src.write_text(MSVD)
        args = ["--msvd_corpus", str(src), "--split_counts", "2", "1"]
    outs = {}
    for name, main in (("jax", j_convert.main), ("port", t_convert.main)):
        caps, splits = tmp_path / f"{name}_caps.json", tmp_path / f"{name}_splits.json"
        line = quiet(main, [*args, "--out_captions", str(caps), "--out_splits", str(splits)])
        outs[name] = (caps.read_text(), splits.read_text(), line)
    assert outs["port"] == outs["jax"]
    if fmt == "msvd":
        assert json.loads(outs["port"][1]) == {"train": ["vidA", "vidB"], "val": ["vidC"],
                                               "test": ["vidD"]}
    with pytest.raises(SystemExit):
        t_convert.main(["--out_captions", "c", "--out_splits", "s"])


def write_streams(tmp_path):
    """Ragged per-video streams as .npy directories and as id-keyed HDF5
    files: lengths above, at and below num_frames, and a 1-D row."""
    rng = np.random.default_rng(7)
    ids = ["v0", "v1", "v2", "v3"]
    (tmp_path / "info.json").write_text(json.dumps({"video_ids": ids}))
    lengths = {"app": [10, 3, 5, 7], "motion": [5, None, 8, 2]}  # None: 1-D
    dims = {"app": 6, "motion": 4}
    for stream in ("app", "motion"):
        d = tmp_path / stream
        d.mkdir()
        with h5py.File(tmp_path / f"{stream}.h5", "w") as f:
            for vid, n in zip(ids, lengths[stream]):
                shape = (dims[stream],) if n is None else (n, dims[stream])
                arr = rng.normal(size=shape).astype(np.float64 if vid == "v2" else np.float32)
                np.save(d / f"{vid}.npy", arr)
                f.create_dataset(vid, data=arr)
    return tmp_path / "info.json"


@pytest.mark.parametrize("source", ["dir", "h5"])
def test_pack_matches_jax(tmp_path, source):
    info = write_streams(tmp_path)
    flags = []
    for stream in ("app", "motion"):
        flags += ([f"--{stream}_dir", str(tmp_path / stream)] if source == "dir"
                  else [f"--{stream}_h5", str(tmp_path / f"{stream}.h5")])
    base = ["--info", str(info), *flags, "--num_frames", "5"]
    quiet(j_pack.main, [*base, "--out", str(tmp_path / "features.h5")])
    line = json.loads(quiet(t_pack.main, [*base, "--out", str(tmp_path / "corpus")]))
    feat = tmp_path / "corpus" / "features"
    assert line["out"] == str(feat) and line["app_shape"] == [4, 5, 6]
    assert line["motion_shape"] == [4, 5, 4] and line["variable_length"] == 1
    with h5py.File(tmp_path / "features.h5") as f:
        for key in ("app", "motion", "nframes"):
            got, want = np.load(feat / f"{key}.npy"), f[key][:]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert got.tobytes() == want.tobytes(), key
    np.testing.assert_array_equal(np.load(feat / "nframes.npy"), [5, 3, 5, 5])
    with pytest.raises(SystemExit):
        t_pack.main(["--info", str(info), "--app_dir", "a", "--app_h5", "b",
                     "--motion_dir", "m", "--out", str(tmp_path)])


def load_jax_rehearsal():
    spec = importlib.util.spec_from_file_location(
        "jax_dress_rehearsal", os.path.join(REPO, "examples", "dress_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dress_rehearsal_matches_jax_and_trains(tmp_path):
    scale = ["--videos", "300", "--app_dim", "64", "--motion_dim", "32"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    quiet(load_jax_rehearsal().main, ["--out", str(jdir), *scale, "--skip_train"])
    out = quiet(t_rehearsal.main, ["--out", str(tdir), *scale, "--device", "cpu", "--scst",
                                   *SMALL_TRAIN])
    stages = [json.loads(line) for line in out.splitlines() if line.startswith('{"stage"')]
    assert [s["stage"] for s in stages] == [
        "synthesize_annotations", "synthesize_features", "convert_msrvtt", "prepro",
        "pack_features", "xe_epoch_plus_eval", "scst_epoch", "TOTAL"]
    assert all(s["seconds"] >= 0 and s["peak_rss_gb"] > 0 for s in stages)
    # on the CPU the wrappers run their plain versions: nothing is launched
    assert not any(stages[5]["launches"].values())

    for name in ("videodatainfo.json", "captions.json", "splits.json", "info.json"):
        assert (tdir / name).read_text() == (jdir / name).read_text(), name
    tl, jl = np.load(tdir / "labels.npz"), np.load(jdir / "labels.npz")
    assert sorted(tl.files) == sorted(jl.files)
    for key in jl.files:
        np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
    with h5py.File(jdir / "features.h5") as f:
        for key in ("app", "motion", "nframes"):
            assert np.load(tdir / "features" / f"{key}.npy").tobytes() == f[key][:].tobytes(), key
    assert stages[-1]["vocab_size"] == len(json.loads((tdir / "info.json").read_text())["vocab"])

    for stage in ("joint", "scst"):
        with open(tdir / "ck" / stage / "train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
        losses = [e["loss"] for e in log if "loss" in e]
        assert losses and all(np.isfinite(losses)), stage
        assert (tdir / "ck" / stage / "best.pt").exists()


def test_dress_rehearsal_cleans_up_and_needs_a_card(tmp_path, monkeypatch):
    """Without --out the corpus goes to a temporary directory that is gone
    afterwards; --device cuda exits 1 without a card."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    quiet(t_rehearsal.main, ["--videos", "40", "--app_dim", "8", "--motion_dim", "4",
                             "--device", "cpu", "--skip_train"])
    assert os.listdir(tmp_path) == []
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            t_rehearsal.main(["--videos", "40", "--skip_train"])
        assert e.value.code == 1


def test_rehearsal_peak_rss_is_its_own(tmp_path):
    """A rehearsal started by a larger process reports its own peak RSS
    (VmRSS sampled), not the parent's that getrusage keeps across exec,
    as the JAX script's stage lines do (on the card, started from a
    larger test process, its first stage read 6.97 GB that way, and 8.75
    GB from VmHWM)."""
    import subprocess
    import sys

    ballast = np.ones(64 * 2 ** 20)  # 512 MiB, touched
    parent = t_rehearsal._rss_kb("VmHWM") / 1e6
    out = subprocess.run(
        [sys.executable, "-m", "controllable_xgating_torch.tools.dress_rehearsal",
         "--out", str(tmp_path), "--videos", "20", "--app_dim", "8", "--motion_dim", "4",
         "--device", "cpu", "--skip_train"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout
    first = json.loads(out.splitlines()[0])
    assert first["stage"] == "synthesize_annotations"
    assert ballast.sum() > 0 and parent > 0.5
    assert 0 < first["peak_rss_gb"] < parent - 0.25, (first, parent)
