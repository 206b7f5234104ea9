"""The port's caption and eval CLIs, and the train CLI's SCST stage, vs
the JAX package's, on the CPU.

A fixture corpus at the widths of `tests/test_cli.py` (variable frame
counts), its features converted to the port's `features/` layout, and one
checkpoint: seeded numpy weights saved by the JAX package (orbax), then
bridged to the port as the JAX side reads it back
(`controllable_xgating_tpu.cli.common.restore_params` -> numpy ->
`bridge.from_numpy` -> the port's `CheckpointManager`, with the JAX
sidecar). Each JAX CLI run happens once per module. Captions and POS
sequences must be equal, n-best scores within 1e-4 (the CLI rounds them
to 4 decimals), metrics within rel 1e-12 (as `tests/test_torch_slice.py`
holds `evaluate_split`). The XE stages of the train CLI are held in
`tests/test_torch_cli_train.py`.
"""

import contextlib
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.cli import caption as j_caption
from controllable_xgating_tpu.cli import common as j_common
from controllable_xgating_tpu.cli import eval as j_eval
from controllable_xgating_tpu.cli import train as j_train
from controllable_xgating_tpu.data.fixtures import make_fixture_corpus
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_torch import bridge
from controllable_xgating_torch.cli import caption as t_caption
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.cli import eval as t_eval
from controllable_xgating_torch.cli import serve as t_serve
from controllable_xgating_torch.cli import train as t_train
from controllable_xgating_torch.data import features as t_features
from controllable_xgating_torch.ops.precision import compute_dtype
from controllable_xgating_torch.train import state as t_state
from test_torch_quant import numpy_params
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
SMALL = [
    "--model.hidden_dim", "20", "--model.embed_dim", "12",
    "--model.attn_dim", "12", "--model.pos_embed_dim", "12",
    "--model.num_frames", "5", "--model.dropout", "0.0",
    "--data.batch_size", "6", "--data.caps_per_video_train", "2",
    "--train.lr", "3e-3", "--train.log_every_steps", "1000",
    "--eval.max_decode_len", "12", "--eval.beam_size", "3",
]
JAX_FLAGS = ["--compile_cache", ""]  # keep the JAX CLIs' XLA cache off disk
PORT_FLAGS = ["--device", "cpu"]


def make_fixture(root: str):
    """(data_dir, JAX checkpoint dir, port checkpoint dir): the fixture
    corpus with both feature layouts, and the same weights in both
    packages' `best` slots."""
    data = os.path.join(root, "corpus")
    make_fixture_corpus(data, num_videos=18, num_frames=5, app_dim=18, motion_dim=10,
                        caps_per_video=5, seqs_per_video=5, max_caption_len=12,
                        variable_frames=True)
    t_features.main([data])
    _, cfg = j_common.parse_with_overrides(j_common.base_parser("fixture"), ["--data_dir", data, *SMALL])
    _, _, _, cfg = j_common.load_corpus(data, cfg)
    jp, _ = numpy_params(cfg, seed=31, eos_bias=0.5)  # captions of mixed lengths
    jdir, tdir = os.path.join(root, "ck_jax"), os.path.join(root, "ck_torch")
    j_state.CheckpointManager(jdir).save("best", j_state.create_train_state(jp, cfg, 1), {
        "epoch": 0, "step": 0, "best_score": 0.0, "metric": "CIDEr", "config": cfg.to_dict()})
    bridge_checkpoint(jdir, tdir, cfg)
    return data, jdir, tdir


def bridge_checkpoint(jdir: str, tdir: str, cfg, name: str = "best") -> None:
    """The JAX checkpoint `name` as the port's: its parameters through
    numpy and the bridge, its sidecar copied."""
    jparams = j_common.restore_params(jdir, cfg, name=name)
    tree = {n: np.asarray(leaf) for n, leaf in param_paths(jparams)}
    ts = t_state.create_train_state(bridge.from_numpy(tree, cfg), cfg)
    t_state.CheckpointManager(tdir).save(name, ts, j_state.CheckpointManager.load_infos(jdir, name))


def run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def first_json(out: str) -> dict:
    return json.JSONDecoder().raw_decode(out[out.index("{"):])[0]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("cli")))


# --- caption ---

CAPTION_CASES = {
    "one_id": ["--video", "video3"],
    "comma_list": ["--video", "video0,video5,video11,video16"],
    "pos_tags": ["--video", "video0,video7", "--pos_tags", "DT NN VBZ VBG NN"],
    "beam3": ["--video", "video2,video9,video14", "--beam_size", "3"],
    "nbest3": ["--video", "video4,video13", "--nbest", "3"],
}


@pytest.fixture(scope="module")
def jax_captions(fixture):
    data, jdir, _ = fixture
    return {case: json_lines(run_cli(j_caption.main, [
        "--data_dir", data, "--checkpoint_dir", jdir, *args, *SMALL, *JAX_FLAGS]))
        for case, args in CAPTION_CASES.items()}


@pytest.mark.parametrize("case", list(CAPTION_CASES))
def test_caption_cli_matches_jax(fixture, jax_captions, case):
    data, _, tdir = fixture
    got = json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, *CAPTION_CASES[case], *SMALL, *PORT_FLAGS]))
    want = jax_captions[case]
    assert len(got) == len(want) == len(CAPTION_CASES[case][1].split(","))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key != "captions":
                assert g[key] == w[key], (key, g, w)
        for gc, wc in zip(g.get("captions", []), w.get("captions", [])):
            assert gc["caption"] == wc["caption"]
            assert gc["score"] == pytest.approx(wc["score"], abs=1e-4)
    if case == "pos_tags":
        assert all(g["pos_sequence"] == "DT NN VBZ VBG NN" and g["controlled"] for g in got)
    if case == "nbest3":
        assert all(len(g["captions"]) == 3 and g["beam_size"] == 3 for g in got)


def test_caption_cli_samples_are_reproducible_by_seed(fixture):
    """--sample N draws N captions per video from a torch.Generator seeded
    with --seed (not JAX's random stream): the same seed gives the same
    captions, the JSON keys are the JAX CLI's."""
    data, _, tdir = fixture
    run = lambda seed: json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, "--video", "video1,video6",
        "--sample", "3", "--temperature", "0.8", "--seed", str(seed), *SMALL, *PORT_FLAGS]))
    a, b = run(0), run(0)
    assert a == b
    assert [o["video"] for o in a] == ["video1", "video6"]
    for o in a:
        assert o.keys() == {"video", "caption", "pos_sequence", "controlled", "sampled",
                            "temperature"}
        assert o["sampled"] and o["temperature"] == 0.8 and len(o["caption"]) == 3
        assert all(isinstance(c, str) for c in o["caption"])
    assert any(run(s) != a for s in (1, 2, 3))


# --- eval ---

EVAL_CASES = {
    "greedy": ["--beam_size", "1"],
    "beam3": ["--beam_size", "3"],
    "nbest3": ["--nbest", "3"],
}


@pytest.fixture(scope="module")
def jax_evals(fixture, tmp_path_factory):
    data, jdir, _ = fixture
    out = {}
    for case, args in EVAL_CASES.items():
        path = str(tmp_path_factory.mktemp("jax_eval") / f"{case}.json")
        printed = first_json(run_cli(j_eval.main, [
            "--data_dir", data, "--checkpoint_dir", jdir, "--out", path, *args, *SMALL,
            *JAX_FLAGS]))
        with open(path) as f:
            out[case] = (printed, json.load(f))
    return out


def close_metrics(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_cli_matches_jax(fixture, jax_evals, case, tmp_path):
    data, _, tdir = fixture
    printed = first_json(run_cli(t_eval.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, *EVAL_CASES[case], *SMALL, *PORT_FLAGS]))
    with open(os.path.join(tdir, "eval_test.json")) as f:
        written = json.load(f)
    want_printed, want = jax_evals[case]
    assert printed.keys() == want_printed.keys()
    assert written.keys() == want.keys()
    for key in ("split", "beam_size", "nbest", "oracle_metric"):
        assert written.get(key) == want.get(key)
    close_metrics(printed["metrics"], want_printed["metrics"])
    close_metrics(written["metrics"], want["metrics"])
    assert set(want["metrics"]) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    if case == "nbest3":
        close_metrics(written["oracle_metrics"], want["oracle_metrics"])
        assert written["captions"].keys() == want["captions"].keys()
        for v, hyps in want["captions"].items():
            assert [h["caption"] for h in written["captions"][v]] == [h["caption"] for h in hyps]
            np.testing.assert_allclose([h["score"] for h in written["captions"][v]],
                                       [h["score"] for h in hyps], rtol=1e-5, atol=1e-6)
    else:
        assert written["captions"] == want["captions"]


# --- device and policy ---


def test_cli_scopes_the_compute_policy(fixture):
    """A bf16 run on the CPU leaves the process's policy at f32, so later
    callers in the process (tests on this worker) are unaffected."""
    data, _, tdir = fixture
    assert compute_dtype() == torch.float32
    out = json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, "--video", "video3",
        "--compute_dtype", "bfloat16", *SMALL, *PORT_FLAGS]))
    assert len(out) == 1 and isinstance(out[0]["caption"], str)
    assert compute_dtype() == torch.float32


@pytest.mark.parametrize("main", [t_caption.main, t_eval.main, t_train.main, t_serve.main],
                         ids=["caption", "eval", "train", "serve"])
def test_cli_without_a_card_refuses_cuda(fixture, monkeypatch, capsys, main, tmp_path):
    """--device defaults to cuda; without a CUDA device the CLI exits
    non-zero with a message and does not run on the CPU."""
    data, _, tdir = fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data_dir", data, "--checkpoint_dir", tdir, *SMALL]
    if main is t_caption.main:
        argv += ["--video", "video0"]
    if main is t_train.main:
        argv[3] = str(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
    assert compute_dtype() == torch.float32


# --- --profile and --debug_nans ---


def trace_files(logdir) -> list:
    return sorted(f for f in os.listdir(logdir) if f.endswith(".pt.trace.json"))


def test_eval_cli_profile_writes_a_trace_and_keeps_the_metrics(fixture, jax_evals, tmp_path):
    """`cli.eval --profile DIR` writes one `torch.profiler` trace of the
    decode and the scoring (the JAX CLI's span) into DIR; its metrics and
    captions are the run's without the flag, and the JAX CLI's."""
    data, _, tdir = fixture
    runs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile", str(tmp_path / "prof")])):
        out = str(tmp_path / f"{name}.json")
        run_cli(t_eval.main, ["--data_dir", data, "--checkpoint_dir", tdir, "--beam_size", "3",
                              "--out", out, *extra, *SMALL, *PORT_FLAGS])
        with open(out) as f:
            runs[name] = json.load(f)
    (trace,) = trace_files(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "aten::topk"} & names, sorted(names)[:20]
    assert runs["profiled"]["metrics"] == runs["plain"]["metrics"]
    assert runs["profiled"]["captions"] == runs["plain"]["captions"]
    assert runs["plain"]["captions"] == jax_evals["beam3"][1]["captions"]
    close_metrics(runs["profiled"]["metrics"], jax_evals["beam3"][1]["metrics"])
    assert compute_dtype() == torch.float32


def test_caption_cli_profile_runs_and_says_it_writes_no_trace(fixture, jax_captions, capsys,
                                                              tmp_path):
    """`cli.caption --profile DIR` runs as the JAX CLI does, which writes
    no trace there; the port says so on stderr."""
    data, _, tdir = fixture
    got = json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, *CAPTION_CASES["one_id"],
        "--profile", str(tmp_path / "prof"), *SMALL, *PORT_FLAGS]))
    assert got == jax_captions["one_id"]
    assert "cli.caption writes no trace" in capsys.readouterr().err
    assert not (tmp_path / "prof").exists()


def plant_nan(data: str, dest: str) -> str:
    """A copy of the fixture corpus with one NaN in the appearance
    features of the first train video, in both feature layouts."""
    import shutil

    import h5py

    shutil.copytree(data, dest)
    with open(os.path.join(dest, "info.json")) as f:
        v = json.load(f)["splits"]["train"][0]
    with h5py.File(os.path.join(dest, "features.h5"), "r+") as f:
        app = f["app"][...]
        app[v, 0, 3] = np.nan
        f["app"][...] = app
    path = os.path.join(dest, t_features.FEATURES_DIR, "app.npy")
    app = np.load(path)
    app[v, 0, 3] = np.nan
    np.save(path, app)
    return dest


DEBUG_TRAIN = ["--stage", "joint", "--epochs", "2", *SMALL, "--train.log_every_steps", "1"]


@pytest.fixture(scope="module")
def debug_runs(fixture, tmp_path_factory):
    """`cli.train` of the port on the clean fixture with and without
    `--debug_nans`; on the NaN-planted copy, each package's CLI with the
    flag (the error it raised, or None) and the port's without it."""
    data, _, _ = fixture
    root = str(tmp_path_factory.mktemp("debug_nans"))
    nan = plant_nan(data, os.path.join(root, "nan_corpus"))
    raised = {}

    def run(name, main, corpus, flags):
        try:
            run_cli(main, ["--data_dir", corpus, "--checkpoint_dir", os.path.join(root, name),
                           *DEBUG_TRAIN, *flags])
            raised[name] = None
        except FloatingPointError as e:
            raised[name] = e

    run("clean", t_train.main, data, PORT_FLAGS)
    run("clean-debug", t_train.main, data, ["--debug_nans", *PORT_FLAGS])
    run("nan", t_train.main, nan, PORT_FLAGS)
    run("nan-debug", t_train.main, nan, ["--debug_nans", *PORT_FLAGS])
    run("nan-debug-jax", j_train.main, nan, ["--debug_nans", *JAX_FLAGS])
    return root, raised


def test_train_cli_debug_nans_logs_the_losses_of_the_run_without(debug_runs):
    """On the clean fixture the checks only read: every logged loss and
    metric equals the run's without the flag (f32 rtol 1e-6), and the
    checks are off again after the CLI returns."""
    from controllable_xgating_torch.ops import dispatch

    root, raised = debug_runs
    assert raised["clean"] is None and raised["clean-debug"] is None
    want, got = (read_train_log(os.path.join(root, n, "joint")) for n in ("clean", "clean-debug"))
    assert len(got) == len(want) and any("loss" in e for e in want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w.keys() - {"ts"}:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-12), k
    assert not dispatch.nan_checks_enabled() and not torch.is_anomaly_enabled()
    assert compute_dtype() == torch.float32


@pytest.mark.parametrize("run", ["nan-debug", "nan", "nan-debug-jax"])
def test_train_cli_on_a_planted_nan(debug_runs, run):
    """One NaN in a train video's features. The port's `--debug_nans`
    raises FloatingPointError naming the operator and the module that
    made the first NaN (the encoder's fusion). Without the flag the run
    completes and logs a NaN loss, as the reference does; so does the JAX
    CLI under its own `--debug_nans`, whose donated train step escapes
    `jax_debug_nans` (it logs the NaN loss at the same step)."""
    root, raised = debug_runs
    if run == "nan-debug":
        assert raised[run] is not None
        assert "models/encoder.py" in str(raised[run]) and "operator aten." in str(raised[run])
        assert not os.path.exists(os.path.join(root, run, "joint", "last.pt"))
        return
    assert raised[run] is None
    losses = [e["loss"] for e in read_train_log(os.path.join(root, run, "joint")) if "loss" in e]
    assert losses and np.isnan(losses).any()
    if run == "nan-debug-jax":
        port_log = read_train_log(os.path.join(root, "nan", "joint"))
        port = [e["loss"] for e in port_log if "loss" in e]
        assert np.isnan(port).tolist() == np.isnan(losses).tolist()


def http_json(url, payload=None):
    """(status, JSON body) of a GET, or of a POST of `payload`."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        return 200, json.loads(urllib.request.urlopen(req, timeout=120).read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("mode,dtype,devices", [
    ("greedy", "float32", 0), ("beam", "bfloat16", 0), ("greedy", "float32", 2),
], ids=["greedy-float32", "beam-bfloat16", "greedy-float32-devices2"])
def test_serve_cli_end_to_end(fixture, jax_captions, mode, dtype, devices):
    """`cli.serve.start` on port 0 on the fixture corpus: /caption by video
    id answers `cli.caption`'s caption and POS sequence under the same
    flags (beam: `--beam_size 3`, eval.beam_size's width), with user tags
    the JAX caption CLI's controlled caption; an unknown id is 400; /stats
    counts the requests. The engine serves under the compute dtype the
    CLI picked (here bf16 on the CPU when asked), while the process's
    policy is left as found. `--devices 2` serves over a mesh of two CPU
    entries: bucket 1 is dropped (2 does not divide it), bucket 2 splits
    into a row a device, and the answers are the same."""
    data, _, tdir = fixture
    flags = ["--compute_dtype", dtype, *SMALL, *PORT_FLAGS]
    want = json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, "--video", "video3",
        *(["--beam_size", "3"] if mode == "beam" else []), *flags]))[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        httpd, engine = t_serve.start([
            "--data_dir", data, "--checkpoint_dir", tdir, "--port", "0", "--mode", mode,
            "--buckets", "1,2", "--max_wait_ms", "2", *flags,
            *(["--devices", str(devices)] if devices else [])])
    assert compute_dtype() == torch.float32
    events = json_lines(buf.getvalue())
    if devices:
        assert events[:2] == [{"event": "buckets_filtered", "dropped": [1], "kept": [2]},
                              {"event": "mesh", "devices": 2}]
        events = events[2:]
    assert [e["event"] for e in events] == ["warmup", "serving"]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, resp = http_json(base + "/caption", {"video": "video3"})
        assert code == 200 and resp["controlled"] is False
        assert (resp["caption"], resp["pos_sequence"]) == (want["caption"], want["pos_sequence"])
        assert (resp["score"] is None) == (mode == "greedy")
        n = 1
        if mode == "greedy":
            tags = "DT NN VBZ VBG NN"
            code, resp = http_json(base + "/caption", {"video": "video0", "pos_tags": tags})
            assert code == 200 and resp["controlled"] is True
            assert resp["caption"] == jax_captions["pos_tags"][0]["caption"]
            assert resp["pos_sequence"] == jax_captions["pos_tags"][0]["pos_sequence"]
            n += 1
        code, resp = http_json(base + "/caption", {"video": "nope"})
        assert code == 400 and "nope" in resp["error"]
        code, stats = http_json(base + "/stats")
        assert code == 200 and stats["requests"] == n and stats["mode"] == mode
        assert stats["buckets"] == ([2] if devices else [1, 2])
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        t.join(30)
    assert not t.is_alive()
    assert compute_dtype() == torch.float32


def test_eval_cli_with_num_devices_matches_jax(fixture, tmp_path):
    """`parallel.num_devices 2` (a training config's device count): the
    port's eval decodes on its one device and writes the captions and
    metrics of the JAX eval CLI run with the same field (which shards its
    batches over two of the test's eight CPU devices)."""
    data, jdir, tdir = fixture
    args = ["--parallel.num_devices", "2", *SMALL]
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    want_printed = first_json(run_cli(j_eval.main, [
        "--data_dir", data, "--checkpoint_dir", jdir, "--out", jpath, *args, *JAX_FLAGS]))
    printed = first_json(run_cli(t_eval.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, "--out", tpath, *args, *PORT_FLAGS]))
    with open(jpath) as f:
        want = json.load(f)
    with open(tpath) as f:
        written = json.load(f)
    assert written.keys() == want.keys() and written["beam_size"] == want["beam_size"] == 3
    close_metrics(printed["metrics"], want_printed["metrics"])
    close_metrics(written["metrics"], want["metrics"])
    assert written["captions"] == want["captions"]
    assert compute_dtype() == torch.float32


def test_caption_cli_takes_num_devices(fixture, jax_captions):
    """The caption CLI never reads `parallel.num_devices`, as the JAX one."""
    data, _, tdir = fixture
    got = json_lines(run_cli(t_caption.main, [
        "--data_dir", data, "--checkpoint_dir", tdir, *CAPTION_CASES["one_id"], *SMALL,
        "--parallel.num_devices", "2", *PORT_FLAGS]))
    assert got == jax_captions["one_id"]


class _StubWriter:
    """A `SummaryWriter` that records what it is given."""

    made: list = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], False
        _StubWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


@pytest.mark.parametrize("tb", ["mirrored", "unavailable"])
def test_train_cli_tensorboard(fixture, monkeypatch, tmp_path, tb):
    """`--tensorboard LOGDIR` mirrors every numeric scalar of
    `train_log.jsonl` to a `torch.utils.tensorboard.SummaryWriter` there
    (here a stub); where that module does not import, the run logs
    "tensorboard unavailable" once and trains on, as the JAX CLI does
    without tensorflow."""
    import sys
    import types

    from controllable_xgating_torch.utils import logging as t_logging

    data, _, _ = fixture
    _StubWriter.made = []
    said = []
    logger = t_logging.get_logger()
    monkeypatch.setattr(logger, "info", lambda msg, *a: said.append(msg % a if a else msg))
    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = _StubWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", stub if tb == "mirrored" else None)
    logdir = str(tmp_path / "tb")
    run_cli(t_train.main, ["--data_dir", data, "--checkpoint_dir", str(tmp_path), "--stage",
                           "joint", "--epochs", "1", "--tensorboard", logdir, *SMALL,
                           "--train.log_every_steps", "1", *PORT_FLAGS])
    with open(tmp_path / "joint" / "train_log.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert (tmp_path / "joint" / "last.pt").exists() and any("loss" in e for e in events)
    unavailable = [m for m in said if m.startswith("tensorboard unavailable")]
    if tb == "unavailable":
        assert len(unavailable) == 1 and _StubWriter.made == []
        return
    assert unavailable == []
    (writer,) = _StubWriter.made
    want = [(k, float(v), e["step"]) for e in events for k, v in e.items()
            if k not in ("ts", "step") and isinstance(v, (int, float))]
    assert writer.logdir == logdir and writer.closed
    assert writer.scalars == want and any(k == "loss" for k, _, _ in want)
    assert compute_dtype() == torch.float32


def test_cli_does_not_take_the_compile_cache_flag(fixture, capsys):
    """The port has no compile cache: --compile_cache exits 1 with a
    message saying so, and leaves the policy as it was."""
    data, _, tdir = fixture
    with pytest.raises(SystemExit) as e:
        t_caption.main(["--data_dir", data, "--checkpoint_dir", tdir, "--video", "video0",
                        "--compile_cache", "x", *SMALL, *PORT_FLAGS])
    assert e.value.code == 1
    assert "--compile_cache has no counterpart" in capsys.readouterr().err
    assert compute_dtype() == torch.float32


def test_use_ckpt_config_adopts_the_checkpoint_architecture(fixture, jax_captions):
    """--use_ckpt_config takes the model knobs from the checkpoint's
    sidecar over the flags: a wrong --model.hidden_dim is replaced and the
    caption is the JAX CLI's; without a sidecar it is refused."""
    data, _, tdir = fixture
    args = ["--data_dir", data, "--checkpoint_dir", tdir, *CAPTION_CASES["one_id"], *SMALL,
            "--model.hidden_dim", "24", *PORT_FLAGS]
    with pytest.raises(RuntimeError, match="size mismatch"):
        run_cli(t_caption.main, args)
    assert json_lines(run_cli(t_caption.main, args + ["--use_ckpt_config"])) == \
        jax_captions["one_id"]
    with pytest.raises(FileNotFoundError, match="cannot adopt its config"):
        t_common.adopt_ckpt_model_config(tdir, t_common.load_config(), "missing")


def test_caption_and_eval_refuse_a_missing_checkpoint(fixture, tmp_path):
    data, _, _ = fixture
    for main, extra in ((t_caption.main, ["--video", "video0"]), (t_eval.main, [])):
        with pytest.raises(FileNotFoundError, match="refusing to fall back"):
            main(["--data_dir", data, "--checkpoint_dir", str(tmp_path / "none"), *extra,
                  *SMALL, *PORT_FLAGS])


# --- train --stage scst and the train.scst_start_epoch switch ---

SCST_TRAIN = ["--train.log_every_steps", "1", "--train.lr", "1e-4"]
REWARDS = ("reward_sample", "reward_greedy", "advantage")


@pytest.fixture(scope="module")
def scst_runs(fixture, tmp_path_factory):
    """`--stage scst --epochs 1` from the bridged joint checkpoint by each
    CLI, and the port's `--stage joint --epochs 2 --train.scst_start_epoch 1`."""
    data, jdir, tdir = fixture
    root = str(tmp_path_factory.mktemp("scst_cli"))
    common = ["--data_dir", data, "--stage", "scst", "--epochs", "1", *SMALL, *SCST_TRAIN]
    run_cli(j_train.main, ["--checkpoint_dir", root + "/jax", "--init_from", jdir, *common,
                           *JAX_FLAGS])
    run_cli(t_train.main, ["--checkpoint_dir", root + "/torch", "--init_from", tdir, *common,
                           *PORT_FLAGS])
    run_cli(t_train.main, ["--data_dir", data, "--checkpoint_dir", root + "/switch", "--stage",
                           "joint", "--epochs", "2", "--train.scst_start_epoch", "1", *SMALL,
                           *SCST_TRAIN, *PORT_FLAGS])
    return root


def read_train_log(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_scst_stage_matches_the_jax_cli_reward(scst_runs):
    """`--stage scst --init_from` writes `scst/best`, `scst/last` and a
    train log with the rewards at every step; the first step's greedy
    baseline reward equals the JAX CLI's (rtol 1e-5): deterministic, no
    dropout, the same first batch and weights."""
    trun, jrun = scst_runs + "/torch/scst", scst_runs + "/jax/scst"
    for name in ("best", "last"):
        assert os.path.exists(os.path.join(trun, name + ".pt"))
        assert t_state.CheckpointManager.load_infos(trun, name)["stage"] == "scst"
    tlog, jlog = read_train_log(trun), read_train_log(jrun)
    tsteps = [e for e in tlog if "loss" in e]
    jsteps = [e for e in jlog if "loss" in e]
    assert [e["step"] for e in tsteps] == [e["step"] for e in jsteps] == [1, 2]
    for e in tsteps:
        assert set(REWARDS) | {"loss", "grad_norm"} <= e.keys()
        assert all(np.isfinite(e[k]) for k in REWARDS)
    assert tsteps[0]["reward_greedy"] == pytest.approx(jsteps[0]["reward_greedy"], rel=1e-5)
    assert tsteps[0]["reward_greedy"] > 0
    assert any("val_CIDEr" in e for e in tlog)
    assert compute_dtype() == torch.float32


def test_train_scst_start_epoch_switches_to_scst(scst_runs):
    """`train.scst_start_epoch 1 --epochs 2`: one XE epoch, then SCST on
    the same state (the step count carries on); `last` says stage scst."""
    run = scst_runs + "/switch/joint"
    assert t_state.CheckpointManager.load_infos(run, "last")["stage"] == "scst"
    steps = [e for e in read_train_log(run) if "loss" in e]
    assert [e["step"] for e in steps] == [1, 2, 3, 4]
    assert all("cap_loss" in e for e in steps[:2]) and all("reward_greedy" in e for e in steps[2:])
    assert torch.load(os.path.join(run, "last.pt"), weights_only=True)["step"] == 4
