"""The port's fixture corpus (`controllable_xgating_torch/data/fixtures.py`,
through `cli/prepro.py --fixtures`) against the JAX package's: info.json,
fixture_meta.json and labels.npz equal, and features/{app,motion,nframes}.npy
bit for bit equal to the datasets of the JAX `features.h5` (read with h5py
here only), for every feature map, corruption, bank seed, adopted vocab and
the joint MSR-VTT + MSVD corpus."""

import json
import os

import h5py
import numpy as np
import pytest

from controllable_xgating_tpu.cli import prepro as j_prepro
from controllable_xgating_tpu.data import fixtures as j_fixtures
from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.data import fixtures as t_fixtures
from controllable_xgating_torch.data.features import FeatureStore

SMALL = ["--fixture_frames", "6", "--fixture_app_dim", "16", "--fixture_motion_dim", "12",
         "--max_caption_len", "14", "--seqs_per_video", "4"]
CASES = {
    "linear": ["--fixture_videos", "30"],
    "entangled_corrupt": ["--fixture_videos", "30", "--fixture_feature_map", "entangled",
                          "--fixture_corrupt_prob", "0.2", "--fixture_seed", "3"],
    "syntax": ["--fixture_videos", "30", "--fixture_feature_map", "syntax",
               "--fixture_train_frac", "0.5", "--fixture_val_frac", "0.25"],
    "bank_seed": ["--fixture_videos", "24", "--fixture_feature_map", "syntax",
                  "--fixture_seed", "11", "--fixture_bank_seed", "0"],
    "joint": ["--fixture_videos", "20", "--fixture_msvd_videos", "12"],
}


def assert_same_fixture(t_dir: str, j_dir: str) -> None:
    for name in ("info.json", "fixture_meta.json"):
        if name == "fixture_meta.json" and not os.path.exists(os.path.join(j_dir, name)):
            assert not os.path.exists(os.path.join(t_dir, name))
            continue
        with open(os.path.join(t_dir, name)) as a, open(os.path.join(j_dir, name)) as b:
            assert json.load(a) == json.load(b), name
    t = np.load(os.path.join(t_dir, "labels.npz"))
    j = np.load(os.path.join(j_dir, "labels.npz"))
    assert t.files == j.files
    for k in j.files:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    assert not os.path.exists(os.path.join(t_dir, "features.h5"))
    with h5py.File(os.path.join(j_dir, "features.h5"), "r") as f:
        assert sorted(f) == ["app", "motion", "nframes"]
        for k in f:
            got = np.load(os.path.join(t_dir, "features", f"{k}.npy"))
            want = f[k][:]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("case", list(CASES))
def test_fixture_cli_equals_jax(tmp_path, capsys, case):
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    t_prepro.main(["--out", t_dir, "--fixtures", *CASES[case], *SMALL])
    j_prepro.main(["--out", j_dir, "--fixtures", *CASES[case], *SMALL])
    assert_same_fixture(t_dir, j_dir)
    t_line, j_line = (json.loads(line) for line in capsys.readouterr().out.splitlines())
    assert t_line.pop("out") == t_dir and j_line.pop("out") == j_dir and t_line == j_line


def test_vocab_from_and_fixed_frames_equal_jax(tmp_path):
    """A held-out corpus that adopts a trained corpus's vocab (the bank seed
    kept, the sampling seed changed), with every clip at full length."""
    kw = dict(num_frames=5, app_dim=10, motion_dim=6, caps_per_video=3, seqs_per_video=3,
              max_caption_len=12)
    src = str(tmp_path / "src")
    t_fixtures.make_fixture_corpus(src, num_videos=8, **kw)
    out = {}
    for name, mod in (("t", t_fixtures), ("j", j_fixtures)):
        out[name] = str(tmp_path / name)
        mod.make_fixture_corpus(out[name], num_videos=40, seed=9, bank_seed=0, variable_frames=False,
                                vocab_from=os.path.join(src, "info.json"), **kw)
    assert_same_fixture(out["t"], out["j"])
    with open(os.path.join(src, "info.json")) as a, open(os.path.join(out["t"], "info.json")) as b:
        assert json.load(a)["vocab"] == json.load(b)["vocab"]
    with open(os.path.join(src, "fixture_meta.json")) as a, \
            open(os.path.join(out["t"], "fixture_meta.json")) as b:
        assert json.load(a)["bank_fingerprint"] == json.load(b)["bank_fingerprint"]
    assert (np.load(os.path.join(out["t"], "features", "nframes.npy")) == 5).all()


def test_fixture_features_read_by_the_port(tmp_path):
    """The port's own store reads what its generator wrote: frame counts
    become masks, pad frames are zero."""
    d = str(tmp_path)
    info = t_fixtures.make_fixture_corpus(d, num_videos=12, num_frames=8, app_dim=32, motion_dim=24,
                                          caps_per_video=3, seqs_per_video=6, max_caption_len=16)
    store = FeatureStore(os.path.join(d, "features"), num_frames=8)
    assert store.num_videos == 12 and (store.app_dim, store.motion_dim) == (32, 24)
    idx = np.array([0, 5, 3])
    app, mot = store.get_batch(idx)
    assert app.shape == (3, 8, 32) and mot.shape == (3, 8, 24)
    mask = store.frame_mask(idx)
    assert ((mask == 0)[:, :, None] <= (app == 0)).all()
    assert len(info.vocab) > 8 and (np.load(os.path.join(d, "labels.npz"))["ncaps"] >= 1).all()


@pytest.mark.parametrize("argv,match", [
    (["--fixture_msvd_videos", "4", "--fixture_feature_map", "entangled"], "single-domain"),
    (["--fixture_msvd_videos", "4", "--vocab_from", "x/info.json"], "vocab_from"),
])
def test_fixture_cli_refusals(tmp_path, capsys, argv, match):
    with pytest.raises(SystemExit):
        t_prepro.main(["--out", str(tmp_path), "--fixtures", *argv, *SMALL])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("kw,match", [
    (dict(feature_map="nope"), "unknown feature_map"),
    (dict(corrupt_prob=0.1), "corrupt_prob requires"),
])
def test_fixture_bad_arguments(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        t_fixtures.make_fixture_corpus(str(tmp_path), num_videos=4, app_dim=8, motion_dim=8, **kw)


def test_constants_equal_jax():
    for name in ("SUBJECTS", "ACTIONS", "ADJECTIVES", "PLACES", "STYLE_NAMES", "N_GROUPS"):
        assert getattr(t_fixtures, name) == getattr(j_fixtures, name), name
