"""The port's data parallelism (`controllable_xgating_torch/parallel/`)
against the JAX package's, on the CPU.

Train steps: the ranks are processes of one gloo group on localhost,
started by `parallel/distributed.py::launch` (spawned, a collective
timeout of 60 s, and the launch's own deadline), each running
`parallel/dryrun.py::train_steps` on its rows of the same global batches;
every run of the module goes through one launch
(`test_torch_distributed.py::rank_train_runs`, a module without JAX, so
that the ranks start fast). The batch's first half
(rank 0's rows) holds captions of 2-3 words and its second half (rank
1's) captions of 7-9, so that a mean of per-rank means would show.
Against the JAX package's `make_parallel_train_step` over `make_mesh(2)`
on the same numpy weights: the loss within rtol 1e-5, the updated
parameters within rtol 2e-4, atol 1e-6 (`tests/test_parallel.py`'s bar),
SCST's `reward_greedy` within rtol 1e-4 (its bar). Against the port's
own one-device step (accumulation, label smoothing, dropout 0.5: every
row gets the one-device step's mask): rtol 1e-5, atol 1e-6.

Decoding over a `Mesh` of `[cpu] * 2` (or 4): `evaluate_split` and
`evaluate_split_nbest` equal the unsharded call and the JAX package's mesh
call exactly (captions, n-best lists; metrics rel 1e-12); n-best scores
within rtol 1e-5, atol 1e-6 (a block of one row is a GEMM of one row,
which sums in another order on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.ops import cider_device as j_cd
from controllable_xgating_tpu.parallel import mesh as j_mesh
from controllable_xgating_tpu.train import scst as j_scst
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_tpu.train import xe as j_xe
from controllable_xgating_tpu.utils.config import Config as JConfig
from controllable_xgating_torch import bridge
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.parallel import distributed, dryrun
from controllable_xgating_torch.parallel import mesh as t_mesh
from controllable_xgating_torch.utils.config import Config
from test_torch_distributed import rank_train_runs
from test_torch_quant import numpy_params
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
B, K, L, T, N_VIDEOS = 8, 2, 12, 5, 16
FLAT = {
    "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
    "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
    "model.vocab_size": 40, "model.pos_vocab_size": 12, "model.num_frames": T,
    "model.max_caption_len": L, "model.max_pos_len": L, "model.dropout": 0.0,
    "data.batch_size": B, "data.caps_per_video_train": K, "train.lr": 1e-3,
    "eval.max_decode_len": L,
}
JAX_TOL = dict(rtol=2e-4, atol=1e-6)
PORT_TOL = dict(rtol=1e-5, atol=1e-6)
SPE = 10  # steps per epoch of both packages' schedules
STAGES = ("joint", "caption", "pos")
PORT_CASES = {  # the port's 2-rank step against its 1-rank step
    "accum2-smooth-dropout": {"train.accum_steps": 2, "train.label_smoothing": 0.1,
                              "model.dropout": 0.5},
    "dropout": {"model.dropout": 0.5},
    "accum2": {"train.accum_steps": 2},
}


def seqs(rng, vocab, lengths):
    """[B, K, L] rows BOS, words, EOS, PAD*, row i with lengths[i] words."""
    x = np.zeros((B, K, L), np.int32)
    for i, (lo, hi) in enumerate(lengths):
        for j in range(K):
            n = int(rng.integers(lo, hi + 1))
            x[i, j, 0], x[i, j, n + 1] = 1, 2
            x[i, j, 1:n + 1] = rng.integers(4, vocab, n)
    return x


def make_batch(seed: int) -> dict:
    """Rank 0's rows (the first half) short, rank 1's long; one video with
    padded frames on each side."""
    rng = np.random.default_rng(seed)
    lengths = [(2, 3)] * (B // 2) + [(7, 9)] * (B // 2)
    mask = np.ones((B, T), np.float32)
    mask[1, 3:] = 0
    mask[6, 2:] = 0
    return {
        "app": rng.standard_normal((B, T, 12)).astype(np.float32),
        "motion": rng.standard_normal((B, T, 10)).astype(np.float32),
        "caps": seqs(rng, 40, lengths), "pos": seqs(rng, 12, lengths), "frame_mask": mask,
        "video_indices": rng.permutation(N_VIDEOS)[:B].astype(np.int32),
    }


def reference_corpus(seed: int = 7):
    """SCST's references: [N_VIDEOS, 4, L] captions, 2-4 per video; df
    over the first 12 videos."""
    rng = np.random.default_rng(seed)
    caps = np.zeros((N_VIDEOS, 4, L), np.int32)
    ncaps = rng.integers(2, 5, N_VIDEOS).astype(np.int32)
    for v in range(N_VIDEOS):
        for j in range(ncaps[v]):
            n = int(rng.integers(3, L - 2))
            caps[v, j, 0], caps[v, j, n + 1] = 1, 2
            caps[v, j, 1:n + 1] = rng.integers(4, 40, n)
    return caps, ncaps, list(range(12))


def jax_params_tree(params) -> dict:
    return {n: np.asarray(x) for n, x in param_paths(params)}


def jax_dp_step(jcfg, jp, batch, stage="joint", tables=None):
    """One step of the JAX package's `make_parallel_train_step` over
    `make_mesh(2)` -> (metrics as floats, updated parameters as numpy)."""
    mesh = j_mesh.make_mesh(2)
    tx = j_state.make_optimizer(jcfg, SPE, stage=stage)
    state = j_state.create_train_state(jp, jcfg, SPE)
    if tables is None:
        raw = j_xe.make_xe_train_step(tx, jcfg, stage=stage, jit_compile=False)
        step = j_mesh.make_parallel_train_step(raw, mesh, donate=False)
    else:
        raw = j_scst.make_scst_train_step(tx, jcfg, tables, jit_compile=False)
        step = j_mesh.make_parallel_train_step(raw, mesh, donate=False, const_args=(tables,))
    out, m = step(state, j_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return {k: float(v) for k, v in m.items()}, jax_params_tree(out.params)


@pytest.fixture(scope="module")
def env():
    jcfg, cfg = JConfig().replace_flat(FLAT), Config().replace_flat(FLAT)
    jp, tp = numpy_params(jcfg, seed=3, eos_bias=0.5)
    tree = bridge.to_numpy(tp)
    b1, b2 = make_batch(1), make_batch(2)
    refs = reference_corpus()
    xe_keys = ("app", "motion", "caps", "pos", "frame_mask")
    scst_keys = ("app", "motion", "frame_mask", "video_indices")
    xe1 = {k: b1[k] for k in xe_keys}
    sc1 = {k: b1[k] for k in scst_keys}
    cases = {f"xe-{s}": dict(params_tree=tree, cfg=cfg, batches=[xe1], stage=s) for s in STAGES}
    for name, flat in PORT_CASES.items():
        cases[name] = dict(params_tree=tree, cfg=cfg.replace_flat(flat),
                           batches=[xe1, {k: b2[k] for k in xe_keys}])
    cases["six-steps"] = dict(params_tree=tree, cfg=cfg, batches=[xe1] * 6)
    for paired in (True, False):
        c = cfg.replace_flat({"train.scst_paired_rollout": paired})
        cases[f"scst-{paired}"] = dict(params_tree=tree, cfg=c, batches=[sc1], scst=refs)
    names = list(cases)
    outs = distributed.launch(rank_train_runs, 2, ([cases[n] for n in names],),
                              device_type="cpu", timeout=60)
    ranks = [dict(zip(names, o)) for o in outs]
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "tree": tree, "batch": b1, "xe1": xe1,
            "sc1": sc1, "refs": refs, "cases": cases, "ranks": ranks}


def close_params(got: dict, want: dict, tol) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **tol, err_msg=name)


# ------------------------------------------------------------------ mesh


def test_mesh_creation():
    cpu = torch.device("cpu")
    mesh = t_mesh.make_mesh(devices=[cpu] * 4)
    assert mesh.size == 4 and mesh.axis == "data" and mesh.devices == (cpu,) * 4
    assert t_mesh.make_mesh(2, axis="dp", devices=["cpu"] * 4).devices == (cpu, cpu)
    with pytest.raises(ValueError, match="need 1000 devices, have 4"):
        t_mesh.make_mesh(1000, devices=[cpu] * 4)


def test_mesh_of_the_cards_refuses_what_is_not_there(monkeypatch):
    """By default the mesh takes the visible cards; none here."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        t_mesh.make_mesh(2)


def test_shard_batch_layout():
    mesh = t_mesh.make_mesh(devices=["cpu"] * 4)
    batch = {"x": np.arange(16).reshape(8, 2), "none": None}
    blocks = t_mesh.shard_batch(batch, mesh)
    assert len(blocks) == 4
    for i, b in enumerate(blocks):
        assert b["none"] is None
        np.testing.assert_array_equal(b["x"].numpy(), np.arange(4 * i, 4 * i + 4).reshape(2, 2))
    with pytest.raises(ValueError, match="not divisible by the 4-device mesh"):
        t_mesh.shard_rows(6, mesh)


def test_replicate_makes_one_copy_per_distinct_device(env):
    params = bridge.from_numpy(env["tree"], env["cfg"])
    reps = t_mesh.replicate(params, t_mesh.make_mesh(devices=["cpu"] * 3))
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is params
    members = t_mesh.replicate((params, params), t_mesh.make_mesh(devices=["cpu"] * 2))
    assert members[torch.device("cpu")] == (params, params)


def test_process_helpers_without_a_process_group():
    assert not torch.distributed.is_initialized() and distributed.process_count() == 1
    assert distributed.is_primary() and not distributed.is_multiprocess()
    assert distributed.process_slice(6) == slice(0, 6)
    batch = {"a": np.arange(4), "b": None}
    assert distributed.shard_process_local_batch(batch)["a"].tolist() == [0, 1, 2, 3]
    assert distributed.broadcast_flag(True) is True
    distributed.assert_same_across_processes((torch.ones(2), 3), "state")  # no peers: no-op


# ------------------------------------------------------------ train steps


@pytest.mark.parametrize("stage", STAGES)
def test_dp_xe_step_matches_jax_mesh_step(env, stage):
    """The 2-rank gloo step against the JAX package's 2-device mesh step:
    the loss and every updated parameter, on both ranks."""
    want_m, want_p = jax_dp_step(env["jcfg"], env["jp"], env["xe1"], stage)
    for rank in env["ranks"]:
        got = rank[f"xe-{stage}"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], want_m["loss"], rtol=1e-5)
        for k in ("cap_loss", "pos_loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][0][k], want_m[k], rtol=1e-5, atol=1e-7)
        close_params(got["params"], want_p, JAX_TOL)


def test_ranks_hold_the_same_state_bit_for_bit(env):
    r0, r1 = env["ranks"]
    for name in env["cases"]:
        assert r0[name]["metrics"] == r1[name]["metrics"], name
        for p in r0[name]["params"]:
            np.testing.assert_array_equal(r0[name]["params"][p], r1[name]["params"][p])


def test_per_rank_means_would_differ(env):
    """The batch's halves differ in caption length, so the mean of the two
    ranks' mean losses is not the global mean (what the step must not
    compute): the test data can tell the two apart."""
    caps = env["xe1"]["caps"][..., 1:]
    n0, n1 = (caps[:B // 2] != 0).sum(), (caps[B // 2:] != 0).sum()
    assert n1 > 2 * n0


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_dp_xe_steps_match_the_one_rank_steps(env, case):
    """Two steps, two ranks against one: accumulation over micro-batches of
    each rank's rows, label smoothing, and dropout 0.5, whose masks are the
    global batch's rows on every rank."""
    c = env["cases"][case]
    want = dryrun.train_steps(**c)
    for rank in env["ranks"]:
        got = rank[case]
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], **PORT_TOL, err_msg=k)
        close_params(got["params"], want["params"], PORT_TOL)


def test_dp_four_ranks_match_the_one_rank_steps(env):
    """Four ranks of two rows each (accumulation over micro-batches of one
    row, dropout 0.5) against the one-device step."""
    c = env["cases"]["accum2-smooth-dropout"]
    want = dryrun.train_steps(**c)
    for got in distributed.launch(rank_train_runs, 4, ([c],), device_type="cpu", timeout=60):
        for g, w in zip(got[0]["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], **PORT_TOL)
        close_params(got[0]["params"], want["params"], PORT_TOL)


def test_dp_six_steps_lower_the_loss(env):
    losses = [m["loss"] for m in env["ranks"][0]["six-steps"]["metrics"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "separate"])
def test_dp_scst_reward_greedy_matches_jax(env, paired):
    """SCST over two ranks: the greedy baseline's mean reward over the
    global batch is JAX's DP step's (the samples come from each rank's own
    stream, ROADMAP C, so only the greedy reward is comparable); the loss
    is finite and the same on both ranks."""
    caps, ncaps, df = env["refs"]
    jcfg = env["jcfg"].replace_flat({"train.scst_paired_rollout": paired})
    tables = j_cd.build_reward_tables(caps, ncaps, df)
    want, _ = jax_dp_step(jcfg, env["jp"], env["sc1"], tables=tables)
    for rank in env["ranks"]:
        got = rank[f"scst-{paired}"]["metrics"][0]
        np.testing.assert_allclose(got["reward_greedy"], want["reward_greedy"], rtol=1e-4)
        assert np.isfinite(got["loss"])


def test_scst_rank_streams_differ_and_advance_the_shared_generator_alike():
    from controllable_xgating_torch.train.scst import rank_generator

    g0, g1 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = rank_generator(g0, 0), rank_generator(g1, 1)
    assert torch.equal(g0.get_state(), g1.get_state())
    assert not torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))


def test_dryrun_one_xe_step_over_two_ranks():
    loss = dryrun.dryrun(2, "cpu")
    assert np.isfinite(loss) and loss > 0


# ----------------------------------------------------------------- decode


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from controllable_xgating_tpu.data.corpus import load_labels
    from controllable_xgating_tpu.data.features import FeatureStore
    from controllable_xgating_tpu.data.fixtures import make_fixture_corpus

    out = str(tmp_path_factory.mktemp("dp_corpus"))
    info = make_fixture_corpus(
        out, num_videos=18, num_frames=5, app_dim=12, motion_dim=10, caps_per_video=3,
        seqs_per_video=4, max_caption_len=10, seed=4,
    )
    cfg = JConfig().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 12, "model.pos_embed_dim": 12,
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.num_frames": 5,
    })
    jp, tp = numpy_params(cfg, seed=13)
    return info, load_labels(out), FeatureStore(out + "/features.h5", num_frames=5), jp, tp


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("decoder", ["greedy", "beam5"])
def test_evaluate_split_over_a_mesh_equals_unsharded_and_jax(corpus, decoder, n_dev):
    info, labels, store, jp, tp = corpus
    kw = dict(split="val", batch_size=4, max_len=10, max_pos_len=10)  # padded last batch
    j_fn = t_fn = None
    if decoder == "beam5":
        j_fn = j_beam.make_beam_caption_fn(5, 10, 10)
        t_fn = t_beam.make_beam_caption_fn(5, 10, 10)
    mesh = t_mesh.make_mesh(devices=["cpu"] * n_dev)
    tm, tc = t_eval.evaluate_split(tp, store, labels, info, caption_fn=t_fn, mesh=mesh, **kw)
    um, uc = t_eval.evaluate_split(tp, store, labels, info, caption_fn=t_fn, **kw)
    jm, jc = j_eval.evaluate_split(jp, store, labels, info, caption_fn=j_fn,
                                   mesh=j_mesh.make_mesh(n_dev), **kw)
    assert tc == uc == jc and tm == um
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("n_dev", [2, 4])
def test_evaluate_split_nbest_over_a_mesh_equals_unsharded_and_jax(corpus, n_dev):
    info, labels, store, jp, tp = corpus
    kw = dict(split="val", batch_size=4)
    t_fn = t_beam.make_beam_caption_fn(3, 10, 10, return_all=True)
    j_fn = j_beam.make_beam_caption_fn(3, 10, 10, return_all=True)
    mesh = t_mesh.make_mesh(devices=["cpu"] * n_dev)
    tb, to, tl = t_eval.evaluate_split_nbest(tp, store, labels, info, t_fn, 3, mesh=mesh, **kw)
    ub, uo, ul = t_eval.evaluate_split_nbest(tp, store, labels, info, t_fn, 3, **kw)
    jb, jo, jl = j_eval.evaluate_split_nbest(jp, store, labels, info, j_fn, 3,
                                             mesh=j_mesh.make_mesh(n_dev), **kw)
    captions = lambda lists: {v: [c for c, _ in l] for v, l in lists.items()}
    assert captions(tl) == captions(ul) == captions(jl) and (tb, to) == (ub, uo)
    # scores: a CPU GEMM of 1 row sums in another order than one of 4
    for v in jl:
        np.testing.assert_allclose([s for _, s in tl[v]], [s for _, s in ul[v]], **PORT_TOL)
        np.testing.assert_allclose([s for _, s in tl[v]], [s for _, s in jl[v]], **PORT_TOL)
    for k in jb:
        assert tb[k] == pytest.approx(jb[k], rel=1e-12, abs=1e-12), k
        assert to[k] == pytest.approx(jo[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("nbest", [False, True], ids=["evaluate_split", "nbest"])
def test_mesh_eval_refuses_an_indivisible_batch(corpus, nbest):
    info, labels, store, _, tp = corpus
    mesh = t_mesh.make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="batch_size 3 not divisible by the 2-device mesh"):
        if nbest:
            t_eval.evaluate_split_nbest(tp, store, labels, info,
                                        t_beam.make_beam_caption_fn(3, 10, 10, return_all=True),
                                        2, split="val", batch_size=3, mesh=mesh)
        else:
            t_eval.evaluate_split(tp, store, labels, info, split="val", batch_size=3,
                                  max_len=10, max_pos_len=10, mesh=mesh)
