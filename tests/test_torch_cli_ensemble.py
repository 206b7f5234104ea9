"""The port's `--ensemble` and `eval.diversity_groups` in `cli.eval` and
`cli.caption`, and its `tools/rerank.py` and `tools/mbr_eval.py`, vs the
JAX package's, on the CPU.

The fixture corpus and checkpoint of `tests/test_torch_cli.py`, plus two
more members saved by the JAX package and bridged to the port: one of the
same architecture (other seeded weights) and one of another (concat
fusion, no psi guidance, hidden 16). Captions and POS sequences must be
equal, metrics within rel 1e-6, n-best scores within 1e-4 (the caption CLI
prints them at 4 decimals); the tools' weights, selections and metrics as
stated at each test.
"""

import json
import os

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.cli import caption as j_caption
from controllable_xgating_tpu.cli import common as j_common
from controllable_xgating_tpu.cli import eval as j_eval
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_torch.cli import caption as t_caption
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.cli import eval as t_eval
from controllable_xgating_torch.ops.precision import compute_dtype
from controllable_xgating_torch.tools import mbr_eval as t_mbr_eval
from controllable_xgating_torch.tools import rerank as t_rerank
from test_torch_cli import (
    JAX_FLAGS,
    PORT_FLAGS,
    SMALL,
    bridge_checkpoint,
    first_json,
    json_lines,
    make_fixture,
    run_cli,
)
from test_torch_quant import numpy_params
from tools import mbr_eval as j_mbr_eval
from tools import rerank as j_rerank

torch.set_num_threads(1)
ALT = ["--model.fusion", "concat", "--model.pos_guidance", "false", "--model.hidden_dim", "16"]
TAGS = "DT NN VBZ VBG NN"


def add_member(data: str, root: str, tag: str, seed: int, extra=()) -> tuple:
    """Another member with seeded weights, saved by the JAX package under
    its own model config and bridged to the port: (JAX dir, port dir)."""
    _, cfg = j_common.parse_with_overrides(
        j_common.base_parser("fixture"), ["--data_dir", data, *SMALL, *extra])
    _, _, _, cfg = j_common.load_corpus(data, cfg)
    jp, _ = numpy_params(cfg, seed=seed, eos_bias=0.5)
    jdir, tdir = os.path.join(root, f"ck_jax_{tag}"), os.path.join(root, f"ck_torch_{tag}")
    j_state.CheckpointManager(jdir).save("best", j_state.create_train_state(jp, cfg, 1), {
        "epoch": 0, "step": 0, "best_score": 0.0, "metric": "CIDEr", "config": cfg.to_dict()})
    bridge_checkpoint(jdir, tdir, cfg)
    return jdir, tdir


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_ens"))
    data, ja, ta = make_fixture(root)
    jb, tb = add_member(data, root, "b", 32)
    jc, tc = add_member(data, root, "alt", 33, ALT)
    return {"data": data, "jax": {"a": ja, "b": jb, "alt": jc},
            "port": {"a": ta, "b": tb, "alt": tc}}


def members(fx, side: str, names) -> list:
    return [fx[side][n] for n in names]


# --- eval ---

EVAL_CASES = {
    "ensemble": (["a", "b"], []),
    "ensemble_nbest": (["a", "b"], ["--nbest", "3"]),
    "ensemble_hetero": (["a", "alt"], ["--beam_size", "3"]),
    "ensemble_diverse": (["a", "b"], ["--beam_size", "4", "--eval.diversity_groups", "2"]),
    "diverse": (None, ["--beam_size", "4", "--eval.diversity_groups", "2",
                       "--eval.diversity_penalty", "0.7"]),
}


def eval_argv(fx, side, case, out):
    names, extra = EVAL_CASES[case]
    ens = ["--ensemble", *members(fx, side, names)] if names else \
        ["--checkpoint_dir", fx[side]["a"]]
    flags = JAX_FLAGS if side == "jax" else PORT_FLAGS
    return ["--data_dir", fx["data"], *ens, *extra, *SMALL, *flags] + (
        ["--out", out] if out else [])


def close_metrics(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_cli_matches_jax(fx, case, tmp_path):
    want_path = str(tmp_path / "jax.json")
    want_printed = first_json(run_cli(j_eval.main, eval_argv(fx, "jax", case, want_path)))
    printed = first_json(run_cli(t_eval.main, eval_argv(fx, "port", case, None)))
    names = EVAL_CASES[case][0]
    # an ensemble's result goes next to its first member
    got_path = os.path.join(fx["port"]["a"],
                            "eval_test_ensemble.json" if names else "eval_test.json")
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    os.remove(got_path)
    assert printed.keys() == want_printed.keys() and got.keys() == want.keys()
    for key in ("split", "beam_size", "nbest", "oracle_metric"):
        assert got.get(key) == want.get(key)
    if names:
        assert got["ensemble"] == members(fx, "port", names)
    close_metrics(printed["metrics"], want_printed["metrics"])
    close_metrics(got["metrics"], want["metrics"])
    if "nbest" in want:
        close_metrics(got["oracle_metrics"], want["oracle_metrics"])
        for v, hyps in want["captions"].items():
            assert [h["caption"] for h in got["captions"][v]] == [h["caption"] for h in hyps]
            np.testing.assert_allclose([h["score"] for h in got["captions"][v]],
                                       [h["score"] for h in hyps], rtol=1e-5, atol=1e-6)
    else:
        assert got["captions"] == want["captions"]


# --- caption ---

CAPTION_CASES = {
    "ensemble_greedy": (["a", "b"], ["--video", "video0,video5,video11"]),
    "ensemble_pos_tags": (["a", "b"], ["--video", "video0,video7", "--pos_tags", TAGS]),
    "ensemble_nbest": (["a", "b"], ["--video", "video4,video13", "--nbest", "3"]),
    "ensemble_hetero_beam": (["a", "alt"], ["--video", "video2,video9", "--beam_size", "3"]),
    "diverse_nbest": (None, ["--video", "video3,video16", "--nbest", "4",
                             "--eval.diversity_groups", "2"]),
}


@pytest.mark.parametrize("case", list(CAPTION_CASES))
def test_caption_cli_matches_jax(fx, case):
    names, extra = CAPTION_CASES[case]

    def argv(side):
        ens = ["--ensemble", *members(fx, side, names)] if names else \
            ["--checkpoint_dir", fx[side]["a"]]
        return ["--data_dir", fx["data"], *ens, *extra, *SMALL,
                *(JAX_FLAGS if side == "jax" else PORT_FLAGS)]

    want = json_lines(run_cli(j_caption.main, argv("jax")))
    got = json_lines(run_cli(t_caption.main, argv("port")))
    assert len(got) == len(want) == len(extra[1].split(","))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key != "captions":
                assert g[key] == w[key], (key, g, w)
        for gc, wc in zip(g.get("captions", []), w.get("captions", [])):
            assert gc["caption"] == wc["caption"]
            assert gc["score"] == pytest.approx(wc["score"], abs=1e-4)
    if names:
        assert all(g["ensemble"] == 2 for g in got)
    if case == "ensemble_pos_tags":
        assert all(g["pos_sequence"] == TAGS and g["controlled"] for g in got)


# --- refusals ---


def test_vocab_mismatch_is_refused(fx, capsys, tmp_path):
    """A member whose sidecar names another vocab exits 1 before restoring."""
    import shutil

    other = str(tmp_path / "other")
    shutil.copytree(fx["port"]["b"], other)
    infos = os.path.join(other, "best.infos.json")
    with open(infos) as f:
        sidecar = json.load(f)
    sidecar["config"]["model"]["vocab_size"] += 7
    with open(infos, "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(SystemExit) as e:
        t_eval.main(["--data_dir", fx["data"], "--ensemble", fx["port"]["a"], other, *SMALL,
                     *PORT_FLAGS])
    assert e.value.code == 1 and "members must share the corpus" in capsys.readouterr().err


@pytest.mark.parametrize("cli,names,extra,message", [
    ("eval", ["a"], [], "at least two checkpoints"),
    ("caption", ["a"], ["--video", "video0"], "at least two checkpoints"),
    ("caption", ["a", "b"], ["--video", "video0", "--sample", "2"], "deterministic decoding only"),
], ids=["eval-one-member", "caption-one-member", "caption-sample"])
def test_cli_refuses_an_ensemble_it_cannot_decode(fx, capsys, cli, names, extra, message):
    main = {"eval": t_eval.main, "caption": t_caption.main}[cli]
    with pytest.raises(SystemExit) as e:
        main(["--data_dir", fx["data"], "--ensemble", *members(fx, "port", names), *extra,
              *SMALL, *PORT_FLAGS])
    assert e.value.code == 1 and message in capsys.readouterr().err
    assert compute_dtype() == torch.float32


def test_hetero_members_restore_under_their_own_configs(fx):
    """Members of two architectures come back as a tuple, each under its
    own saved model config; the run adopts the first member's."""
    args, cfg = t_common.parse_with_overrides(
        t_common.base_parser("x"), ["--data_dir", fx["data"], *SMALL])
    args.ensemble = [fx["port"]["a"], fx["port"]["alt"]]
    cfg = t_common.adopt_run_config(args, cfg)
    _, _, _, cfg = t_common.load_corpus(fx["data"], cfg)
    params, n = t_common.restore_ensemble_params(args.ensemble, cfg, "cpu")
    assert n == 2 and isinstance(params, tuple)
    assert params[0].encoder.xgate.mode == "xgate" and params[0].decoder.use_psi
    assert params[1].encoder.xgate.mode == "concat" and not params[1].decoder.use_psi
    assert params[1].decoder.w_out.shape[0] == 16 and cfg.model.hidden_dim == 20


@pytest.mark.parametrize("spec,want", [
    ("ck", ("ck", "best")),
    ("ck:last", ("ck", "last")),
    ("runs/a/ck:ep3", ("runs/a/ck", "ep3")),
    ("runs/2026:aug/ck1", ("runs/2026:aug/ck1", "best")),
    ("runs/2026:aug/ck1:last", ("runs/2026:aug/ck1", "last")),
    ("ck:", ("ck", "best")),
])
def test_split_ckpt_spec(spec, want):
    assert t_common.split_ckpt_spec(spec) == want == j_common.split_ckpt_spec(spec)


# --- the tools ---


def test_rerank_matches_the_jax_tool(fx, tmp_path):
    """Decode, rescore under another checkpoint, tune on val, apply on
    test: the same features' names, weights (the same seeded search over
    the same table), oracle tables and metrics."""
    def run(main, side, extra):
        out = str(tmp_path / f"{side}.json")
        run_cli(main, ["--data_dir", fx["data"], "--checkpoint_dir", fx[side]["a"],
                       "--rescore", fx[side]["b"], "--nbest", "3", "--trials", "300",
                       "--out", out, *extra, "--data.batch_size", "4"])
        with open(out) as f:
            return json.load(f)

    want = run(j_rerank.main, "jax", ["--platform", "cpu"])
    got = run(t_rerank.main, "port", ["--device", "cpu"])
    assert got.keys() == want.keys()
    for key in ("nbest", "beam_size", "tune_split", "tune_metric", "eval_split",
                "picked_nonzero_rank"):
        assert got[key] == want[key], key
    assert len(got["features"]) == len(want["features"]) == 4
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=1e-12)
    np.testing.assert_allclose(got["feature_mean"], want["feature_mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["feature_std"], want["feature_std"], rtol=1e-5, atol=1e-6)
    assert got["tune_rank0"] == pytest.approx(want["tune_rank0"], rel=1e-9)
    assert got["tune_reranked"] == pytest.approx(want["tune_reranked"], rel=1e-9)
    for key in ("metrics_rank0", "metrics_reranked", "metrics_oracle"):
        close_metrics(got[key], want[key])
    assert compute_dtype() == torch.float32


@pytest.mark.parametrize("extra", [
    ["--pool", "beam", "--samples", "4"],
    ["--pool", "beam", "--samples", "4", "--beam_weighting", "uniform", "--utility", "CIDErD"],
    ["--pool", "beam", "--samples", "4", "--diversity_groups", "2"],
], ids=["beam_posterior_rouge", "beam_uniform_cider", "diverse_beam"])
def test_mbr_eval_beam_pool_matches_the_jax_tool(fx, tmp_path, extra):
    def run(main, side, flags):
        out = str(tmp_path / f"{side}.json")
        run_cli(main, ["--data_dir", fx["data"], "--checkpoint_dir", fx[side]["a"],
                       "--out", out, *extra, *flags])
        with open(out) as f:
            return json.load(f)

    want = run(j_mbr_eval.main, "jax", ["--platform", "cpu"])
    got = run(t_mbr_eval.main, "port", ["--device", "cpu"])
    assert got.keys() == want.keys()
    assert got["captions"] == want["captions"]
    for key in ("split", "samples", "utility", "pool", "beam_weighting", "picked_greedy_frac"):
        assert got[key] == want[key], key
    close_metrics(got["metrics_greedy"], want["metrics_greedy"])
    close_metrics(got["metrics_mbr"], want["metrics_mbr"])


def test_mbr_eval_sample_pool_is_reproducible_by_seed(fx, tmp_path):
    """Sample pools come from a torch.Generator (not JAX's random stream):
    the same seed gives the same selection, and every chosen caption is
    one of the pool's."""
    def run(seed):
        out = str(tmp_path / f"s{seed}.json")
        printed = first_json(run_cli(t_mbr_eval.main, [
            "--data_dir", fx["data"], "--checkpoint_dir", fx["port"]["a"], "--samples", "5",
            "--include_greedy", "--seed", str(seed), "--out", out, "--device", "cpu"]))
        with open(out) as f:
            return printed, json.load(f)

    (p0, a), (_, b) = run(0), run(0)
    assert a == b and p0["pool"] == "sample" and p0["include_greedy"]
    assert all(np.isfinite(v) for v in p0["metrics_mbr"].values())
