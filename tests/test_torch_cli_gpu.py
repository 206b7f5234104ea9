"""The port's entry points on the card, through `main(argv)` as users run them.

Marked `gpu`: every test skips without a CUDA device. The CLIs (bf16, the
kernels on, their defaults) run on a corpus the port's own writers make at
MSR-VTT width (128 train, 64 val and 256 test videos, half padded in time,
a 10000-word vocabulary, 31 Penn tags): train, SCST from it, eval (beam 5
equal to the library path, n-best, an ensemble, diverse beam) and caption
(greedy, `--pos_tags`, `--sample`, `--nbest`, and once from the shell);
the host runtime under them (the native metric library equal to the
Python paths, `--profile` traces that count the run's launches,
`--debug_nans`); the train CLI in a process group over NCCL; config 5 on
its joint corpus; and the port's own user path (`cli.prepro --fixtures`
at the flagship recipe's 600 videos, POS then caption training, eval and
score) with checks on the weights it trained. Each CLI run counts its
kernel launches (set to 0 before, read after) and must leave the
process's compute policy as it found it. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_gpu.py
"""

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from controllable_xgating_torch.cli import caption as cli_caption
from controllable_xgating_torch.cli import eval as cli_eval
from controllable_xgating_torch.cli import train as cli_train
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.precision import compute_dtype, precision
from test_torch_msrvtt_gpu import AGREE_MIN, MAX_LEN, POS_VOCAB, T, VOCAB, draw_captions, draw_videos

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "msrvtt.json")
SPLITS = {"train": 128, "val": 64, "test": 256}
PENN = ("CC CD DT EX FW IN JJ JJR JJS MD NN NNS NNP NNPS PDT POS PRP PRP$ RB RBR RBS RP TO UH VB "
        "VBD VBG VBN VBP VBZ WDT").split()  # + 4 specials = POS_VOCAB
TAGS = "DT NN VBZ VBG NN"
PATH = ("xgate", "pos_lstm", "attn_lstm")
K5 = ("xent_fwd", "xent_bwd")
HOST_REL = 1e-9  # native vs Python metrics (tests/test_native_text.py's bar)


def run_cli(main, argv, want=(), absent=()):
    """`main(argv)` with its stdout kept and its launches counted ->
    (stdout, launches). Every kernel of `want` must launch and none of
    `absent`; the process's compute policy must be as it was."""
    before = compute_dtype()
    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(a) for a in argv])
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    assert all(got[n] for n in want) and not any(got[n] for n in absent), (argv, got)
    assert compute_dtype() == before
    return buf.getvalue(), got


def all_finite(values) -> bool:
    values = list(values)
    return bool(values) and all(math.isfinite(v) for v in values)


def read_log(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def write_corpus(root, seed=2):
    """info.json, labels.npz and features/ as the CLIs read them, written
    with the port's writers (no HDF5), SPLITS videos from `draw_videos`."""
    from controllable_xgating_torch.data.corpus import CorpusInfo
    from controllable_xgating_torch.data.features import write_feature_dir
    from controllable_xgating_torch.data.vocab import Vocab
    from controllable_xgating_torch.utils.config import load_config

    m = load_config(CONFIG).model
    n, s = sum(SPLITS.values()), 20
    app, mot, counts, caps, pos, ncaps = draw_videos(np.random.default_rng(seed), n, s, m.app_dim,
                                                     m.motion_dim)
    live = np.arange(T)[None, :, None] < counts[:, None, None]
    write_feature_dir(os.path.join(root, "features"), app * live, mot * live, counts)
    np.savez(os.path.join(root, "labels.npz"), caps=caps, pos=pos, ncaps=ncaps.astype(np.int32))
    splits, start = {}, 0
    for name, size in SPLITS.items():
        splits[name], start = list(range(start, start + size)), start + size
    assert len(PENN) + 4 == POS_VOCAB
    CorpusInfo(vocab=Vocab([f"w{i}" for i in range(VOCAB - 4)]), pos_vocab=Vocab(PENN),
               video_ids=[f"video{i}" for i in range(n)], splits=splits, max_caption_len=MAX_LEN,
               max_pos_len=MAX_LEN, seqs_per_video=s).save(os.path.join(root, "info.json"))


class Corpus:
    """The CLI corpus and the checkpoints trained on it: joint XE for one
    epoch (2 steps, then a greedy eval of the val split), SCST from it."""

    def __init__(self, root):
        self.root, self.data, self.evals = root, os.path.join(root, "corpus"), 0
        write_corpus(self.data)
        self.base = ["--data_dir", self.data, "--config", CONFIG]
        ck = os.path.join(root, "ck")
        self.joint, self.scst = os.path.join(ck, "joint"), os.path.join(ck, "scst")
        steps = ["--checkpoint_dir", ck, "--epochs", "1", "--train.log_every_steps", "1"]
        self.launches = {
            "train": run_cli(cli_train.main, self.base + steps + ["--stage", "joint"])[1],
            "scst": run_cli(cli_train.main, self.base + steps + ["--stage", "scst", "--init_from",
                                                                   self.joint])[1]}

    def eval(self, *argv, want=PATH + ("topk_tail",), absent=()):
        """cli.eval on the test split -> (its JSON output, launches)."""
        self.evals += 1
        out = os.path.join(self.root, f"eval_{self.evals}.json")
        _, got = run_cli(cli_eval.main, self.base + ["--split", "test", "--out", out, *argv],
                         want, absent)
        with open(out) as f:
            return json.load(f), got


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return Corpus(str(tmp_path_factory.mktemp("cli")))


@pytest.fixture(scope="module")
def beam5(corpus):
    """cli.eval --beam_size 5 of the joint checkpoint -> (output, launches)."""
    return corpus.eval("--checkpoint_dir", corpus.joint, "--beam_size", "5")


def test_train_cli(corpus):
    """Joint XE for one epoch: 2 steps logged, a best checkpoint, K5 once a
    step, K1-K3 in the val eval, no K4, finite losses and metrics."""
    got, log = corpus.launches["train"], read_log(corpus.joint)
    steps = [e for e in log if "loss" in e]
    val = [v for e in log for k, v in e.items() if k.startswith("val_")]
    assert len(steps) == 2 and os.path.exists(os.path.join(corpus.joint, "best.pt"))
    assert got["xent_fwd"] == got["xent_bwd"] == 2 and all(got[n] for n in PATH), got
    assert not got["topk_tail"], got
    assert all_finite(val + [v for e in steps for k, v in e.items() if k != "ts"])


def test_train_scst_cli(corpus):
    """SCST for one epoch from the joint checkpoint: 2 steps logged with
    their rewards, a best checkpoint, K3 28 times in each step's baseline,
    K1-K3 in the val eval, no K4 or K5."""
    got = corpus.launches["scst"]
    steps = [e for e in read_log(corpus.scst) if "loss" in e]
    assert len(steps) == 2 and all("reward_greedy" in e for e in steps)
    assert os.path.exists(os.path.join(corpus.scst, "best.pt"))
    assert all(got[n] for n in PATH) and got["attn_lstm"] >= 2 * MAX_LEN, got
    assert not any(got[n] for n in K5 + ("topk_tail",)), got
    keys = ("loss", "grad_norm", "reward_sample", "reward_greedy", "advantage")
    assert all_finite(e[k] for e in steps for k in keys if k in e)


def test_eval_cli_equals_the_library_path(corpus, beam5):
    """cli.eval --beam_size 5 over the 256 test videos: K1-K4 launched,
    finite metrics, and the captions and metrics of `evaluate_split` with
    `make_beam_caption_fn(5, ...)` on the same checkpoint."""
    from controllable_xgating_torch.cli.common import load_corpus, restore_params
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import evaluate_split
    from controllable_xgating_torch.utils.config import load_config

    res, _ = beam5
    assert len(res["captions"]) == SPLITS["test"] and all_finite(res["metrics"].values())
    cfg = load_config(CONFIG)
    with precision(cfg.model.dtype):
        info, labels, store, c = load_corpus(corpus.data, cfg)
        fn = make_beam_caption_fn(5, c.model.max_pos_len, c.eval.max_decode_len,
                                  length_penalty=c.eval.length_penalty, block_unk=c.eval.block_unk)
        metrics, caps = evaluate_split(restore_params(corpus.joint, c, "cuda"), store, labels, info,
                                       split="test", batch_size=c.data.batch_size,
                                       max_len=c.eval.max_decode_len,
                                       max_pos_len=c.model.max_pos_len, caption_fn=fn,
                                       metrics=c.eval.metrics)
    assert res["captions"] == caps and res["metrics"] == metrics


def test_eval_cli_nbest(corpus):
    res, _ = corpus.eval("--checkpoint_dir", corpus.joint, "--nbest", "5")
    assert res["beam_size"] == 5 and all(len(c) == 5 for c in res["captions"].values())
    assert all_finite([*res["metrics"].values(), *res["oracle_metrics"].values()])


def test_eval_cli_ensemble_and_diverse_beam(corpus):
    """`--ensemble` of the XE and SCST checkpoints (K1 once per member a
    batch, K3 in pairs) and `--beam_size 6 --eval.diversity_groups 3`:
    K1-K3, no K4, finite metrics."""
    res, got = corpus.eval("--ensemble", corpus.joint, corpus.scst, absent=("topk_tail",), want=PATH)
    batches = -(-SPLITS["test"] // 64)
    assert res["ensemble"] == [corpus.joint, corpus.scst] and len(res["captions"]) == SPLITS["test"]
    assert got["xgate"] == 2 * batches and got["attn_lstm"] % 2 == 0, got
    assert all_finite(res["metrics"].values())
    res, _ = corpus.eval("--checkpoint_dir", corpus.joint, "--beam_size", "6",
                         "--eval.diversity_groups", "3", absent=("topk_tail",), want=PATH)
    assert all_finite(res["metrics"].values())


def test_caption_cli(corpus):
    """Eight test videos: greedy (K1-K3), `--pos_tags` (the sequence
    given, no K2), `--sample 3 --seed 0` twice (equal), `--nbest 10`
    (wider than K4's k <= 8: no K4; finite scores); then greedy once from
    the shell, with the in-process run's captions."""
    lines = lambda out: [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    cap = corpus.base + ["--checkpoint_dir", corpus.joint, "--video",
                         ",".join(f"video{i}" for i in range(128, 136))]
    greedy = lines(run_cli(cli_caption.main, cap, PATH, ("topk_tail",))[0])
    tags = lines(run_cli(cli_caption.main, cap + ["--pos_tags", TAGS], ("xgate", "attn_lstm"),
                         ("pos_lstm", "topk_tail"))[0])
    sample = [run_cli(cli_caption.main, cap + ["--sample", "3", "--seed", "0"], PATH)[0]
              for _ in range(2)]
    nbest = lines(run_cli(cli_caption.main, cap + ["--nbest", "10"], PATH, ("topk_tail",))[0])
    assert all(len(x) == 8 for x in (greedy, tags, lines(sample[0]), nbest))
    assert all(x["pos_sequence"] == TAGS and x["controlled"] for x in tags)
    assert sample[0] == sample[1] and all(len(x["caption"]) == 3 for x in lines(sample[0]))
    assert all(len(x["captions"]) == 10 and all_finite(c["score"] for c in x["captions"])
               for x in nbest)
    shell = subprocess.run([sys.executable, "-m", "controllable_xgating_torch.cli.caption", *cap],
                           cwd=REPO, capture_output=True, text=True, timeout=300)
    assert shell.returncode == 0, shell.stderr[-2000:]
    assert lines(shell.stdout) == greedy


def python_paths(mp):
    """The native library out of reach: every entry point of
    `utils/native.py` returns None, so the Python paths run."""
    from controllable_xgating_torch.utils import native

    mp.setattr(native, "_LIB", None)
    mp.setattr(native, "_TRIED", True)


def test_native_metrics_equal_the_python_paths(corpus, monkeypatch):
    """The native library builds on the card's host; cli.eval beam 5 with
    the metrics native and in Python gives the same captions and metrics
    within rel 1e-9; on that eval's captions and references the tokens and
    stems are equal and METEOR (with and without a synonym table) and
    ROUGE-L within rel 1e-9."""
    from controllable_xgating_torch.data.tokenizer import PTBTokenizer
    from controllable_xgating_torch.infer import evaluator
    from controllable_xgating_torch.metrics.meteor import MeteorScorer
    from controllable_xgating_torch.metrics.rouge import RougeScorer
    from controllable_xgating_torch.metrics.stemmer import stem
    from controllable_xgating_torch.utils import native

    assert native.available(), native.library_path()
    captured, language_eval = {}, evaluator.language_eval

    def spy(gts, res, **kw):
        captured.update(gts=gts, res=res)
        return language_eval(gts, res, **kw)

    monkeypatch.setattr(evaluator, "language_eval", spy)
    args = ("--checkpoint_dir", corpus.joint, "--beam_size", "5")
    native_res, _ = corpus.eval(*args)
    with monkeypatch.context() as mp:
        python_paths(mp)
        python_res, _ = corpus.eval(*args)
    assert native_res["captions"] == python_res["captions"]
    for k, v in native_res["metrics"].items():
        assert math.isclose(python_res["metrics"][k], v, rel_tol=HOST_REL, abs_tol=1e-12), k
    gts, res = captured["gts"], captured["res"]
    texts = [c for caps in gts.values() for c in caps] + [c[0] for c in res.values()]
    tok = PTBTokenizer()
    assert all(native.ptb_tokenize(s) == tok.tokenize_python(s) for s in texts)
    words = sorted({w for s in texts for w in s.split()})
    assert all(native.porter_stem(w) == stem(w) for w in words)
    synonyms = [(words[2 * i], words[2 * i + 1]) for i in range(min(200, len(words) // 2))]
    for make in (lambda nat: MeteorScorer(use_native=nat),
                 lambda nat: MeteorScorer(use_native=nat, synonyms=synonyms),
                 lambda nat: RougeScorer()):
        a, per_a = make(True).score(gts, res)
        with monkeypatch.context() as mp:
            python_paths(mp)
            b, per_b = make(False).score(gts, res)
        assert math.isclose(a, b, rel_tol=HOST_REL, abs_tol=1e-12)
        np.testing.assert_allclose(per_a, per_b, rtol=HOST_REL, atol=1e-12)


def test_native_df_table_equals_numpy(corpus):
    """The SCST reward's df table at MSR-VTT's caption scale (10000 videos
    x 20 captions, df over 6513): the native builder equals the numpy build
    bit for bit."""
    from controllable_xgating_torch.ops import cider_device as cd
    from controllable_xgating_torch.utils import native

    caps, _ = draw_captions(np.random.default_rng(4), 10000, 20)
    ncaps, vids = np.full(10000, 20, np.int32), list(range(6513))
    h1, h2, df_native = native.build_df(caps, ncaps, vids)
    keys, df = cd._df_table(caps, ncaps, vids)
    assert np.array_equal((h1.astype(np.uint64) << np.uint64(32)) | h2, keys)
    assert np.array_equal(df_native.view(np.uint32), df.view(np.uint32))


def trace_launches(logdir) -> dict:
    """{wrapper: launches its kernels' device events account for} of the
    one `torch.profiler` trace in `logdir`."""
    from controllable_xgating_torch.utils.profiling import kernel_event_launches

    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return kernel_event_launches(e.get("name", "") for e in events if e.get("cat") == "kernel")


def test_train_profile_trace_counts_the_launches(corpus, tmp_path):
    _, got = run_cli(cli_train.main, corpus.base + [
        "--checkpoint_dir", tmp_path / "ck", "--stage", "joint", "--epochs", "1",
        "--profile", tmp_path / "prof"], K5)
    seen = trace_launches(tmp_path / "prof")
    assert all(seen.get(n) == got[n] for n in K5), (seen, got)


def test_eval_profile_trace_counts_the_launches(corpus, beam5, tmp_path):
    """cli.eval --profile: the trace's kernel events count the run's
    launches plus the graph captures' warm-ups (which the counters leave
    out), and the captions and metrics are the unprofiled run's."""
    from controllable_xgating_torch.infer import graphs

    graphs.WARMUP_LAUNCHES.clear()
    res, got = corpus.eval("--checkpoint_dir", corpus.joint, "--beam_size", "5",
                           "--profile", tmp_path / "prof")
    warmup = dict(graphs.WARMUP_LAUNCHES)
    assert res["captions"] == beam5[0]["captions"] and res["metrics"] == beam5[0]["metrics"]
    seen = trace_launches(tmp_path / "prof")
    for n in PATH + ("topk_tail",):
        assert seen.get(n) == got[n] + warmup.get(n, 0), (n, seen, got, warmup)


def test_debug_nans(corpus, tmp_path):
    """cli.train --debug_nans (f32) logs the values of the run without it
    within rel 1e-6 and leaves the checks off; on a copy of the corpus with
    one NaN in a train video's features it raises FloatingPointError (the
    checks off after it), and without the flag that run completes."""
    from controllable_xgating_torch.ops import dispatch

    f32 = ["--compute_dtype", "float32", "--train.log_every_steps", "1", "--stage", "joint",
           "--epochs", "1"]
    for name, extra in (("plain", []), ("debug", ["--debug_nans"])):
        run_cli(cli_train.main, corpus.base + f32 + ["--checkpoint_dir", tmp_path / name, *extra], K5)
    want, got = (read_log(tmp_path / n / "joint") for n in ("plain", "debug"))
    assert [g.keys() for g in got] == [w.keys() for w in want]
    assert all(math.isclose(g[k], w[k], rel_tol=1e-6) for g, w in zip(got, want) for k in w
               if isinstance(w[k], float) and k != "ts")
    assert not dispatch.nan_checks_enabled() and not torch.is_anomaly_enabled()
    nan_data = tmp_path / "corpus_nan"
    shutil.copytree(corpus.data, nan_data)
    app = np.load(nan_data / "features" / "app.npy")
    app[0, 0, 3] = np.nan  # video 0: the first train video
    np.save(nan_data / "features" / "app.npy", app)
    argv = ["--data_dir", nan_data, "--config", CONFIG, *f32]
    with pytest.raises(FloatingPointError):
        cli_train.main([str(a) for a in argv + ["--checkpoint_dir", tmp_path / "nan_debug",
                                                "--debug_nans"]])
    assert not dispatch.nan_checks_enabled() and not torch.is_anomaly_enabled()
    cli_train.main([str(a) for a in argv + ["--checkpoint_dir", tmp_path / "nan"]])


def train_processes(corpus, root, runs: dict) -> dict:
    """cli.train (joint, one epoch, f32) as processes, one per entry of
    `runs` {name: (arguments, environment)}, all at once -> {name: (its
    output, its `last` checkpoint, its logged steps)}."""
    cmd = [sys.executable, "-m", "controllable_xgating_torch.cli.train", *corpus.base,
           "--stage", "joint", "--epochs", "1", "--compute_dtype", "float32",
           "--train.log_every_steps", "1"]
    env = dict(os.environ, PYTHONPATH=REPO, CUBLAS_WORKSPACE_CONFIG=":4096:8", CXG_TIMEOUT_S="300")
    procs = {name: subprocess.Popen(cmd + ["--checkpoint_dir", os.path.join(root, name), *args],
                                    env=dict(env, **extra), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for name, (args, extra) in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = {}
    for name, p in procs.items():
        assert p.returncode == 0, outs[name][-2000:]
        run = os.path.join(root, name, "joint")
        got[name] = (outs[name], torch.load(os.path.join(run, "last.pt"), map_location="cpu",
                                            weights_only=True),
                     [e for e in read_log(run) if "loss" in e])
    return got


def test_train_cli_over_nccl_at_world_size_one_equals_no_group(corpus, tmp_path):
    """cli.train as one process of a group of one over NCCL (the CXG_*
    variables) and without a group: the `last` parameters bit for bit
    under f32 (an all-reduce of one rank changes nothing)."""
    from controllable_xgating_torch.parallel.distributed import free_port

    got = train_processes(corpus, str(tmp_path), {
        "nccl1": ([], {"CXG_COORDINATOR": f"127.0.0.1:{free_port()}", "CXG_NUM_PROCESSES": "1",
                       "CXG_PROCESS_ID": "0"}),
        "alone": (["--parallel.num_devices", "1"], {})})
    (out, a, _), (alone, b, _) = got["nccl1"], got["alone"]
    assert "over nccl" in out and "data-parallel over 1 devices on 1 processes" in out, out[-2000:]
    assert "joined process group" not in alone
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in b["params"])


def test_train_cli_over_cards_equals_one_device(corpus, tmp_path):
    """`--parallel.num_devices n` (2, or 4 on four cards; NCCL) against one
    device: the logged losses within rtol 1e-5, and Adam's first moments
    of all parameters within a relative norm of 1e-5."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two cards, this machine has {cards}")
    n = 4 if cards >= 4 else 2
    got = train_processes(corpus, str(tmp_path), {
        "cards": (["--parallel.num_devices", str(n)], {}),
        "alone": (["--parallel.num_devices", "1"], {})})
    (out, a, la), (_, b, lb) = got["cards"], got["alone"]
    assert f"data-parallel over {n} devices on {n} processes" in out, out[-2000:]
    assert len(la) == len(lb) > 0
    assert all(abs(x["loss"] - y["loss"]) <= 1e-5 * abs(y["loss"]) for x, y in zip(la, lb))
    moments = lambda ck: torch.cat([v["exp_avg"].flatten() for _, v in
                                    sorted(ck["opt_state"]["state"].items())])
    assert (moments(a) - moments(b)).norm() <= 1e-5 * moments(b).norm()


def test_config5_on_the_joint_corpus(tmp_path):
    """Config 5: `make_joint_fixture_corpus` at MSR-VTT width (600 + 300
    videos), cli.train --model.decoder_hidden_mult 2 for one epoch
    (prefetched, bf16; K1-K3 in the val eval, no K4, no K5 at its 81
    words) whose loss falls, then cli.eval --beam_size 5: every test
    caption, K1 once a batch, K2-K4 launched, finite metrics."""
    from controllable_xgating_torch.data.fixtures import make_joint_fixture_corpus

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    data, ck = tmp_path / "corpus", tmp_path / "ck"
    info = make_joint_fixture_corpus(str(data))
    base = ["--data_dir", data, "--config", CONFIG, "--compute_dtype", "bfloat16",
            "--model.decoder_hidden_mult", "2", "--parallel.num_devices", "1",
            "--train.log_every_steps", "1", "--eval.max_decode_len", "20"]
    run_cli(cli_train.main, ["--checkpoint_dir", ck, "--stage", "joint", "--epochs", "1", *base],
            PATH, ("topk_tail",) + K5)
    losses = [e["loss"] for e in read_log(ck / "joint") if "loss" in e]
    assert losses and math.isfinite(losses[-1]) and losses[-1] < losses[0], losses
    _, got = run_cli(cli_eval.main, ["--checkpoint_dir", ck / "joint", "--beam_size", "5",
                                     "--out", tmp_path / "eval.json", *base], PATH + ("topk_tail",))
    res = json.loads((tmp_path / "eval.json").read_text())
    n_test = len(info.splits["test"])
    assert len(res["captions"]) == n_test and got["xgate"] == -(-n_test // 64), got
    assert all_finite(res["metrics"].values())


# the port's own user path (examples/full_pipeline.sh): the flagship
# recipe's corpus and widths, its 8 + 40 epochs cut to 4 + 16
STUDY_PREPRO = ["--fixtures", "--fixture_videos", "600", "--fixture_frames", "26",
                "--fixture_app_dim", "1536", "--fixture_motion_dim", "1024",
                "--max_caption_len", "20", "--seqs_per_video", "8"]
STUDY_COMMON = ["--compute_dtype", "bfloat16", "--model.hidden_dim", "512",
                "--model.embed_dim", "512", "--model.attn_dim", "512",
                "--model.pos_embed_dim", "512", "--model.num_frames", "26",
                "--data.batch_size", "64", "--data.caps_per_video_train", "4",
                "--train.lr_decay_every_epochs", "40", "--train.log_every_steps", "1",
                "--eval.max_decode_len", "20"]
STUDY_STAGES = (("pos", 4, "1e-3"), ("caption", 16, "2e-3"))
STUDY_TAGS = "DT NN VBZ VBG IN DT NN"


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The corpus made by `cli.prepro --fixtures`, the POS stage then the
    caption stage trained from it (bf16; the val evals launch K1-K3, not
    K5: the corpus's 81 words are under its V >= 2048 gate), and cli.eval
    --beam_size 5 of the test split."""
    from controllable_xgating_torch.cli import prepro as cli_prepro

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    root = str(tmp_path_factory.mktemp("study"))
    data, ck = os.path.join(root, "corpus"), os.path.join(root, "ck")
    made, prepro = run_cli(cli_prepro.main, ["--out", data, *STUDY_PREPRO])
    common, init, losses = ["--data_dir", data, *STUDY_COMMON], [], {}
    for stage, epochs, lr in STUDY_STAGES:
        run_cli(cli_train.main, ["--checkpoint_dir", ck, "--stage", stage, "--epochs", epochs,
                                 *init, "--train.lr", lr, *common], PATH, ("topk_tail",) + K5)
        by_epoch = {}
        for e in read_log(os.path.join(ck, stage)):
            if "loss" in e:
                by_epoch.setdefault(e["epoch"], []).append(e["loss"])
        losses[stage] = [float(np.mean(v)) for _, v in sorted(by_epoch.items())]
        init = ["--init_from", os.path.join(ck, stage)]
    best, out = os.path.join(ck, "caption"), os.path.join(root, "eval_test.json")
    run_cli(cli_eval.main, ["--checkpoint_dir", best, "--split", "test", "--beam_size", "5",
                            "--out", out, *common], PATH + ("topk_tail",))
    with open(out) as f:
        res = json.load(f)
    return dict(root=root, data=data, best=best, eval_json=out, eval=res, losses=losses,
                prepro_launches=prepro, splits=json.loads(made.strip().splitlines()[-1])["splits"])


def test_study_trains_and_captions(study):
    """The corpus is made with no launch; each stage's mean loss falls from
    its first epoch to its last; the eval captions every test video with
    finite metrics."""
    assert not any(study["prepro_launches"].values())
    for stage, losses in study["losses"].items():
        assert math.isfinite(losses[-1]) and losses[-1] < losses[0], (stage, losses)
    res = study["eval"]
    assert len(res["captions"]) == study["splits"]["test"] and all_finite(res["metrics"].values())


def study_inputs(study):
    """(cfg, trained checkpoint dir, app, motion, mask, a template's tags)
    of the test split on the card."""
    from controllable_xgating_torch.cli.common import load_corpus
    from controllable_xgating_torch.data.vocab import pad_encode
    from controllable_xgating_torch.utils.config import load_config

    cfg = load_config(None, {k[2:]: v for k, v in zip(STUDY_COMMON[::2], STUDY_COMMON[1::2])
                             if "." in k})
    info, _, store, cfg = load_corpus(study["data"], cfg)
    idx = np.asarray(info.splits["test"])
    app, mot = (torch.as_tensor(x, device="cuda") for x in store.get_batch(idx))
    mask = torch.as_tensor(store.frame_mask(idx), device="cuda")
    tags = torch.as_tensor(np.array([pad_encode(info.pos_vocab, STUDY_TAGS.split(),
                                                cfg.model.max_pos_len)] * len(idx)), device="cuda")
    return cfg, app, mot, mask, tags


def test_study_kernels_match_the_plain_path_on_trained_weights(study):
    """Under f32 on the trained checkpoint: beam 5 and greedy, free and
    under a template, the kernel path's captions equal the plain path's on
    >= 98% of the test videos; the beam-5 call through
    `utils/debug.py::kernel_plain_diff` (kernels and graphs against the
    plain eager path) has equal tokens and floats within rtol 1e-4, atol
    1e-5."""
    from controllable_xgating_torch.cli.common import restore_params
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.utils.debug import kernel_plain_diff

    cfg, app, mot, mask, tmpl = study_inputs(study)
    steps, pos_len = cfg.eval.max_decode_len, cfg.model.max_pos_len

    def decode(p, beam, fused=None, tags=None):
        with torch.inference_mode():
            ctx, summary, _ = encode_for_inference(p, app, mot, mask, pos_tags=tags,
                                                   max_pos_len=pos_len, fused=fused, early_stop=True)
            if beam:
                return beam_search(p.decoder, ctx, summary, 5, steps, fused=fused, early_stop=True)
            return greedy_decode(p.decoder, ctx, summary, steps, fused=fused, early_stop=True)

    with precision("float32"):
        params = restore_params(study["best"], cfg, "cuda")
        for beam in (True, False):
            for tags in (None, tmpl):
                a, b = (decode(params, beam, f, tags) for f in (True, False))
                a, b = (a[0], b[0]) if beam else (a, b)
                assert (a == b).all(1).float().mean().item() >= AGREE_MIN, (beam, tags is None)
        kernel_plain_diff(lambda p: decode(p, True), params, rtol=1e-4, atol=1e-5)


def test_study_early_exit_graphed_equals_eager_on_trained_weights(study):
    """Under bf16 on the trained checkpoint, whose captions end at mixed
    steps: beam 5 and greedy through the kernels with early stop, the
    decode loops replayed as CUDA graphs (which replay up to two chunks
    past the one where every caption ended) give the eager loops' tokens
    (`set_decode_graphs(False)`), on the capturing call and on a
    replay."""
    from controllable_xgating_torch.cli.common import restore_params
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs

    cfg, app, mot, mask, _ = study_inputs(study)
    steps = cfg.eval.max_decode_len

    def decode(p, beam, graphed):
        set_decode_graphs(None if graphed else False)
        try:
            with torch.inference_mode():
                ctx, summary, _ = encode_for_inference(p, app, mot, mask,
                                                       max_pos_len=cfg.model.max_pos_len,
                                                       fused=True, early_stop=True)
                if beam:
                    out = beam_search(p.decoder, ctx, summary, 5, steps, fused=True,
                                      early_stop=True)[0]
                else:
                    out = greedy_decode(p.decoder, ctx, summary, steps, fused=True,
                                        early_stop=True)
            torch.cuda.synchronize()
        finally:
            set_decode_graphs(None)
        return out

    with precision("bfloat16"):
        params = restore_params(study["best"], cfg, "cuda")
        for beam in (True, False):
            want = decode(params, beam, False)
            for call in ("capture", "replay"):
                assert torch.equal(decode(params, beam, True), want), (beam, call)


def test_study_score_cli(study, tmp_path):
    """cli.score --per_video --bootstrap 200 on the eval's captions: every
    test video scored, no kernel launched, the eval's metrics."""
    from controllable_xgating_torch.cli import score as cli_score

    per_video = tmp_path / "per_video.json"
    text, got = run_cli(cli_score.main, ["--candidates", study["eval_json"], "--data_dir",
                                         study["data"], "--split", "test", "--per_video", per_video,
                                         "--bootstrap", "200"])
    scored, n_test = json.loads(text), study["splits"]["test"]
    assert scored["n_scored"] == n_test and len(json.loads(per_video.read_text())) == n_test
    assert not any(got.values())
    for m, v in scored["metrics"].items():
        if m in study["eval"]["metrics"]:
            assert math.isclose(v, study["eval"]["metrics"][m], rel_tol=1e-9), m
