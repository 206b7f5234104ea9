"""The port's checkpoint tools vs the JAX package's, on the CPU.

One fixture corpus (both feature layouts) and JAX checkpoint slots holding
seeded numpy weights (orbax, as the JAX tools write them):

- `tools/import_torch_checkpoint.py`: the template the JAX tool prints,
  line for line; a `.pth` imported under a mapping (one entry transposed)
  equal bit for bit to the JAX tool's `import_params` on the same file and
  mapping, also with `--allow_missing` (the imported paths); every error
  path with the JAX tool's exception and message; the pickle refusal.
- `convert_jax_checkpoint.py` (repo root): a JAX slot -> the port's `.pt`
  slot, parameters bit for bit, the sidecar copied, and the port's
  caption CLI on it gives the JAX caption CLI's captions on the slot.
- `tools/average_checkpoints.py`: the port's average of two converted
  slots against the JAX tool's average of the JAX slots (rtol 1e-7; the
  arithmetic is the same, member by member in float32), the sidecar's keys
  and values, and the refusals.
- `tools/psi_diversity.py` on a converted slot: the JAX tool's distinct
  counts and top sequences on the JAX slot.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import convert_jax_checkpoint
from controllable_xgating_tpu.cli import caption as j_caption
from controllable_xgating_tpu.cli import common as j_common
from controllable_xgating_tpu.data.fixtures import make_fixture_corpus
from controllable_xgating_tpu.models.captioner import init_captioner as j_init
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_torch import bridge
from controllable_xgating_torch.cli import caption as t_caption
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.data import features as t_features
from controllable_xgating_torch.tools import average_checkpoints as t_avg
from controllable_xgating_torch.tools import import_torch_checkpoint as t_imp
from controllable_xgating_torch.tools import psi_diversity as t_psi
from controllable_xgating_torch.train import state as t_state
from controllable_xgating_torch.utils.config import load_config as t_load_config
from test_torch_quant import numpy_params
from tools import average_checkpoints as j_avg
from tools import import_torch_checkpoint as j_imp
from tools import psi_diversity as j_psi

import jax

torch.set_num_threads(1)
SMALL = ["--model.hidden_dim", "20", "--model.embed_dim", "12", "--model.attn_dim", "12",
         "--model.pos_embed_dim", "12", "--model.num_frames", "5", "--model.dropout", "0.0",
         "--data.batch_size", "6", "--eval.max_decode_len", "12"]
VIDEOS = "video0,video5,video11,video16"


def run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def jax_tree(ckpt_dir: str, cfg, name: str = "best") -> dict:
    return {n: np.asarray(leaf)
            for n, leaf in j_imp.param_paths(j_common.restore_params(ckpt_dir, cfg, name=name))}


def port_tree(ckpt_dir: str, cfg, name: str = "best") -> dict:
    return bridge.to_numpy(t_common.restore_params(ckpt_dir, cfg, "cpu", name=name))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, data dir, JAX config, port config, JAX slots {seed: dir})."""
    root = str(tmp_path_factory.mktemp("ckpt_tools"))
    data = os.path.join(root, "corpus")
    make_fixture_corpus(data, num_videos=18, num_frames=5, app_dim=18, motion_dim=10,
                        caps_per_video=5, seqs_per_video=5, max_caption_len=12,
                        variable_frames=True)
    t_features.main([data])
    _, jcfg = j_common.parse_with_overrides(j_common.base_parser("t"), ["--data_dir", data, *SMALL])
    _, _, _, jcfg = j_common.load_corpus(data, jcfg)
    _, tcfg = t_common.parse_with_overrides(t_common.base_parser("t"), ["--data_dir", data, *SMALL])
    _, _, _, tcfg = t_common.load_corpus(data, tcfg)
    slots = {}
    for seed in (31, 32):
        jp, _ = numpy_params(jcfg, seed=seed, eos_bias=0.5)
        slots[seed] = os.path.join(root, f"jax_{seed}")
        j_state.CheckpointManager(slots[seed]).save("best", j_state.create_train_state(jp, jcfg, 1), {
            "epoch": seed - 30, "step": 7, "best_score": 0.25, "metric": "CIDEr",
            "config": jcfg.to_dict()})
    return root, data, jcfg, tcfg, slots


# --- import ---

def make_pth(paths: dict, tmp_path):
    """A reference-style .pth holding other values than any init, with one
    2-D entry stored transposed (torch Linear layout), and its mapping."""
    rng = np.random.default_rng(5)
    sd, mapping = {}, {}
    transposed = next(p for p, s in paths.items() if len(s) == 2)
    for p, shape in paths.items():
        arr = rng.normal(size=shape).astype(np.float32)
        key = "ref." + p
        if p == transposed:
            sd[key] = torch.tensor(arr.T.copy())
            mapping[p] = {"key": key, "transform": "transpose"}
        else:
            sd[key] = torch.tensor(arr)
            mapping[p] = key
    pth = str(tmp_path / "model-best.pth")
    torch.save({"state_dict": sd}, pth)
    return pth, sd, mapping


def test_dump_template_is_the_jax_tools(corpus):
    _, data, _, _, _ = corpus
    got = run_cli(t_imp.main, ["--data_dir", data, "--dump_template", *SMALL])
    want = run_cli(j_imp.main, ["--data_dir", data, "--dump_template", *SMALL])
    assert got == want and len(got.splitlines()) == 42


@pytest.mark.parametrize("partial", [False, True], ids=["full", "allow_missing"])
def test_import_matches_jax(corpus, tmp_path, partial):
    _, data, jcfg, tcfg, _ = corpus
    template = j_init(jax.random.PRNGKey(0), jcfg.model)
    paths = {n: tuple(leaf.shape) for n, leaf in j_imp.param_paths(template)}
    pth, sd, mapping = make_pth(paths, tmp_path)
    if partial:  # the encoder alone
        mapping = {k: v for k, v in mapping.items() if k.startswith("encoder.")}
    with open(tmp_path / "mapping.json", "w") as f:
        json.dump(mapping, f)
    out = str(tmp_path / "imported")
    line = json.loads(run_cli(t_imp.main, [
        "--data_dir", data, "--pth", pth, "--mapping", str(tmp_path / "mapping.json"),
        "--out", out, *SMALL, *(["--allow_missing"] if partial else [])]))
    jparams, jrep = j_imp.import_params(template, j_imp.load_state_dict(pth), mapping,
                                        allow_missing=partial)
    assert line["imported"] == len(jrep["imported"]) == len(mapping)
    assert line["kept_initialized"] == len(jrep["kept_initialized"]) == len(paths) - len(mapping)
    want = {n: np.asarray(leaf) for n, leaf in j_imp.param_paths(jparams)}
    got = port_tree(out, tcfg)
    for p in jrep["imported"]:
        assert got[p].dtype == want[p].dtype and got[p].tobytes() == want[p].tobytes(), p
    infos = t_state.CheckpointManager.load_infos(out, "best")
    assert infos.keys() == {"imported_from", "epoch", "step", "best_score", "config"}
    assert infos["epoch"] == -1 and infos["best_score"] is None
    assert infos["config"]["model"]["vocab_size"] == tcfg.model.vocab_size
    if not partial:  # the slot drives a CLI of the port
        caps = json_lines(run_cli(t_caption.main, ["--data_dir", data, "--checkpoint_dir", out,
                                                   "--video", "video2", "--device", "cpu",
                                                   *SMALL]))
        assert isinstance(caps[0]["caption"], str)


def error_cases(names, shape):
    """(label, state_dict, mapping, allow_missing) of each import error."""
    sq = torch.tensor(np.zeros((3, 3), np.float32))
    wrong = (3, 3) if shape != (3, 3) else (4, 4)
    return {
        "unknown_path": ({}, {"not.a.path": "x"}, False),
        "missing_key": ({}, {names[0]: "missing_key"}, True),
        "shape": ({"k": torch.zeros(wrong)}, {names[0]: "k"}, True),
        "transform": ({"k": sq}, {names[0]: {"key": "k", "transform": "flip"}}, True),
        "unmapped": ({"k": sq}, {}, False),
    }


@pytest.mark.parametrize("case", ["unknown_path", "missing_key", "shape", "transform",
                                  "unmapped"])
def test_import_errors_match_jax(corpus, case):
    _, _, jcfg, tcfg, _ = corpus
    template = j_init(jax.random.PRNGKey(0), jcfg.model)
    flat = j_imp.param_paths(template)
    sd, mapping, allow = error_cases([n for n, _ in flat], tuple(flat[0][1].shape))[case]
    with pytest.raises(Exception) as want:
        j_imp.import_params(template, sd, mapping, allow_missing=allow)
    with pytest.raises(Exception) as got:
        t_imp.import_params(t_common.init_captioner(tcfg, seed=0, device="cpu"), sd, mapping,
                            allow_missing=allow)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_import_keeps_unmapped_parameters(corpus):
    _, _, _, tcfg, _ = corpus
    template = t_common.init_captioner(tcfg, seed=0, device="cpu")
    before = bridge.to_numpy(template)
    params, rep = t_imp.import_params(template, {}, {}, allow_missing=True)
    assert rep["imported"] == [] and len(rep["kept_initialized"]) == len(before)
    after = bridge.to_numpy(params)
    assert all(np.array_equal(before[n], after[n]) for n in before)


def test_pickle_code_is_rejected_without_optin(tmp_path):
    pth = str(tmp_path / "wrapped.pth")
    # a pickled function reference: benign here, but exactly the shape of
    # object whose unpickling can execute arbitrary code
    torch.save({"state_dict": {"w": torch.zeros(2)}, "infos": os.getcwd}, pth)
    with pytest.raises(ValueError, match="unsafe_pickle"):
        t_imp.load_state_dict(pth)
    assert set(t_imp.load_state_dict(pth, unsafe_pickle=True)) == {"w"}
    for wrapper in ("state_dict", "model", "model_state_dict"):
        plain = str(tmp_path / f"{wrapper}.pth")
        torch.save({wrapper: {"w": torch.ones(3), "n": 3}}, plain)
        assert set(t_imp.load_state_dict(plain)) == {"w"}
    torch.save([torch.ones(1)], str(tmp_path / "list.pth"))
    with pytest.raises(ValueError, match="not a state_dict"):
        t_imp.load_state_dict(str(tmp_path / "list.pth"))


def test_import_needs_its_inputs(corpus, tmp_path):
    _, data, _, _, _ = corpus
    with pytest.raises(SystemExit):
        t_imp.main(["--data_dir", data, "--pth", "x.pth", *SMALL])


# --- JAX slot -> port slot ---

@pytest.fixture(scope="module")
def converted(corpus):
    root, _, _, _, slots = corpus
    out = {}
    for seed, jdir in slots.items():
        out[seed] = os.path.join(root, f"port_{seed}")
        line = json.loads(run_cli(convert_jax_checkpoint.main,
                                  ["--checkpoint_dir", jdir, "--out", out[seed]]))
        assert line["name"] == "best" and line["epoch"] == seed - 30
    return out


def test_converter_carries_parameters_and_sidecar(corpus, converted):
    _, _, jcfg, tcfg, slots = corpus
    for seed, jdir in slots.items():
        want, got = jax_tree(jdir, jcfg), port_tree(converted[seed], tcfg)
        assert set(got) == set(want)
        for p in want:
            assert got[p].tobytes() == want[p].tobytes(), p
        assert (t_state.CheckpointManager.load_infos(converted[seed], "best")
                == j_state.CheckpointManager.load_infos(jdir, "best"))
    with pytest.raises(FileNotFoundError):
        convert_jax_checkpoint.convert(slots[31], str(corpus[0] + "/nowhere"), name="last")


def test_converted_slot_captions_like_the_jax_cli(corpus, converted):
    _, data, _, _, slots = corpus
    for args in (["--video", VIDEOS], ["--video", VIDEOS, "--beam_size", "3"]):
        want = json_lines(run_cli(j_caption.main, ["--data_dir", data, "--checkpoint_dir",
                                                   slots[31], *args, *SMALL,
                                                   "--compile_cache", ""]))
        got = json_lines(run_cli(t_caption.main, ["--data_dir", data, "--checkpoint_dir",
                                                  converted[31], *args, *SMALL,
                                                  "--device", "cpu"]))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert (g["video"], g["caption"], g["pos_sequence"]) == (
                w["video"], w["caption"], w["pos_sequence"])


# --- average ---

@pytest.mark.parametrize("weights", [None, "1,3"], ids=["equal", "weighted"])
def test_average_matches_jax(corpus, converted, tmp_path, weights):
    _, data, jcfg, tcfg, slots = corpus
    extra = ["--weights", weights] if weights else []
    jout, tout = str(tmp_path / "jax_soup"), str(tmp_path / "port_soup")
    # no --model.* flags: both adopt the first member's architecture
    jline = json.loads(run_cli(j_avg.main, ["--data_dir", data, "--inputs", slots[31],
                                            f"{slots[32]}:best", "--out", jout, *extra]))
    tline = json.loads(run_cli(t_avg.main, ["--data_dir", data, "--inputs", converted[31],
                                            f"{converted[32]}:best", "--out", tout, *extra]))
    assert tline["weights"] == jline["weights"] == ([0.25, 0.75] if weights else [0.5, 0.5])
    assert tline["n_inputs"] == jline["n_inputs"] == 2
    want, got = jax_tree(jout, jcfg), port_tree(tout, tcfg)
    a = port_tree(converted[31], tcfg)
    assert any(not np.array_equal(a[p], want[p]) for p in want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-7, atol=0, err_msg=p)
    ji = j_state.CheckpointManager.load_infos(jout, "best")
    ti = t_state.CheckpointManager.load_infos(tout, "best")
    assert ti.keys() == ji.keys()
    for key in ("weights", "epoch", "step", "best_score"):
        assert ti[key] == ji[key], key
    strip = lambda srcs: [{k: v for k, v in s.items() if k != "dir"} for s in srcs]
    assert strip(ti["averaged_from"]) == strip(ji["averaged_from"])
    assert ti["config"]["model"] == ji["config"]["model"]
    # a fresh optimizer state at step 0
    blob = torch.load(os.path.join(tout, "best.pt"), weights_only=True)
    assert blob["step"] == 0 and not blob["opt_state"]["state"]


def test_average_refusals(corpus, converted, tmp_path):
    _, data, _, tcfg, _ = corpus
    a, b = converted[31], converted[32]
    out = str(tmp_path / "soup")
    for argv in (["--inputs", a], ["--inputs", a, b, "--weights", "1,2,3"]):
        with pytest.raises(SystemExit):
            t_avg.main(["--data_dir", data, *argv, "--out", out])
    with pytest.raises(FileNotFoundError, match="no checkpoint named 'last'"):
        t_avg.main(["--data_dir", data, "--inputs", a, f"{b}:last", "--out", out])
    with pytest.raises(ValueError, match="weights must be positive"):
        t_avg.average_params([{"w": np.ones(2, np.float32)}] * 2, [1.0, -1.0])
    # a member of another architecture fails the restore's check
    cfg = tcfg.replace_flat({"model.fusion": "concat"})
    concat = str(tmp_path / "concat")
    t_state.CheckpointManager(concat).save(
        "best", t_state.create_train_state(t_common.init_captioner(cfg, seed=1, device="cpu"),
                                           cfg), {"epoch": 0, "config": cfg.to_dict()})
    with pytest.raises(ValueError, match="model.fusion"):
        t_avg.main(["--data_dir", data, "--inputs", a, concat, "--out", out])


def test_param_paths_follow_the_jax_tree(corpus):
    """`bridge.param_paths` lists the port's parameters in the order of
    the JAX tool's `param_paths`, with and without the backward LSTM."""
    _, _, jcfg, _, _ = corpus
    for bidir in (True, False):
        cfg = jcfg.replace_flat({"model.encoder_bidirectional": bidir})
        want = [n for n, _ in j_imp.param_paths(j_init(jax.random.PRNGKey(0), cfg.model))]
        tcfg = t_load_config(None, {k: v for k, v in
                                    [(f"model.{f}", getattr(cfg.model, f))
                                     for f in ("hidden_dim", "embed_dim", "attn_dim",
                                               "pos_embed_dim", "vocab_size", "pos_vocab_size",
                                               "app_dim", "motion_dim",
                                               "encoder_bidirectional")]})
        got = [n for n, _ in bridge.param_paths(t_common.init_captioner(tcfg, seed=0,
                                                                        device="cpu"))]
        assert got == want


# --- psi diversity on a converted slot ---

@pytest.mark.parametrize("split,limit", [("test", "128"), ("train", "5")])
def test_psi_diversity_matches_jax(corpus, converted, split, limit):
    _, data, _, _, slots = corpus
    args = ["--data_dir", data, "--split", split, "--limit", limit, "--top", "4"]
    want = json.loads(run_cli(j_psi.main, ["--checkpoint_dir", slots[32], *args,
                                           "--platform", "cpu"]))
    got = json.loads(run_cli(t_psi.main, ["--checkpoint_dir", converted[32], *args,
                                          "--device", "cpu"]))
    assert got.pop("checkpoint") == converted[32]
    want.pop("checkpoint")
    assert got == want and got["videos"] > 0
