"""BASELINE.json config 5 (a 2x hidden-dim decoder on the joint MSVD +
MSR-VTT corpus, data-parallel) and the C3D widths (`configs/msvd_c3d.json`:
4096-d motion) through the port, against the JAX package, on the CPU.

The counterparts of `tests/test_config5_scaled.py:23` and `:71` (the JAX
ones are `slow`; these run at small widths) and of
`tests/test_c3d_widths.py:61` and `:78`:
  * `make_joint_fixture_corpus` writes the JAX package's corpus (info,
    labels bit for bit, features bit for bit);
  * with `model.decoder_hidden_mult` 2, the port's data-parallel XE step
    over 2 gloo ranks (`parallel/dryrun.py::train_steps`, prefetched with
    the per-rank put) against JAX's `make_parallel_train_step` over
    `make_mesh(2)`: losses rtol 1e-5, parameters rtol 2e-4, atol 1e-6
    (`tests/test_torch_parallel.py`'s bar); `evaluate_split` with beam 5
    gives JAX's captions and metrics (rel 1e-12), beam's n-best tokens
    equal and scores within rtol 1e-5, atol 1e-6;
  * the XGating fusion at a C3D aspect (48, 256, 32) against the Pallas
    kernel in interpret mode (atol 2e-6, the JAX test's bar), and the
    port's prepro -> train -> eval at 4096-d motion, whose captions JAX's
    `evaluate_split` on the same (bridged) `best` gives too.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data import fixtures as j_fixtures
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.parallel import mesh as j_mesh
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_tpu.train import xe as j_xe
from controllable_xgating_tpu.utils.config import Config as JConfig
from controllable_xgating_torch import bridge
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.cli import eval as t_eval_cli
from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.cli import train as t_train
from controllable_xgating_torch.data import fixtures as t_fixtures
from controllable_xgating_torch.data.corpus import CorpusInfo, load_labels
from controllable_xgating_torch.data.features import FeatureStore
from controllable_xgating_torch.data.loader import TrainBatchIterator
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.parallel import distributed
from controllable_xgating_torch.utils.config import Config
from test_torch_distributed import rank_train_runs
from test_torch_fixtures import assert_same_fixture
from test_torch_quant import numpy_params
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
JOINT = dict(num_msrvtt=20, num_msvd=12, num_frames=9, app_dim=16, motion_dim=10, caps_msrvtt=3,
             caps_msvd=6, seqs_per_video=4, max_caption_len=12, seed=3)
B, K, L = 8, 2, 12
JAX_TOL = dict(rtol=2e-4, atol=1e-6)
SPE = 10  # steps per epoch of both packages' schedules


# ------------------------------------------------------------ config 5


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    """The joint corpus by each package, the 2x-decoder config and weights
    for both, and two global batches of the port's loader."""
    root = tmp_path_factory.mktemp("joint")
    t_dir, j_dir = str(root / "t"), str(root / "j")
    info = t_fixtures.make_joint_fixture_corpus(t_dir, **JOINT)
    j_fixtures.make_joint_fixture_corpus(j_dir, **JOINT)
    labels = load_labels(t_dir)
    store = FeatureStore(os.path.join(t_dir, "features"), num_frames=JOINT["num_frames"])
    flat = {
        "model.app_dim": 16, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 12, "model.pos_embed_dim": 12,
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.num_frames": JOINT["num_frames"], "model.max_caption_len": L,
        "model.max_pos_len": L, "model.dropout": 0.0, "model.decoder_hidden_mult": 2,
        "data.batch_size": B, "data.caps_per_video_train": K,
        "eval.max_decode_len": L,
    }
    jcfg, cfg = JConfig().replace_flat(flat), Config().replace_flat(flat)
    jp, tp = numpy_params(jcfg, seed=5, eos_bias=0.5)
    it = iter(TrainBatchIterator(store, labels["caps"], labels["pos"], labels["ncaps"],
                                 np.asarray(info.splits["train"]), B, K, seed=0))
    batches = [next(it) for _ in range(2)]
    return dict(t_dir=t_dir, j_dir=j_dir, info=info, labels=labels, store=store, jcfg=jcfg,
                cfg=cfg, jp=jp, tp=tp, batches=batches)


def test_joint_fixture_corpus_equals_jax(joint):
    """`tests/test_config5_scaled.py:23`: the two domains (MSR-VTT's fixed
    clips, MSVD's variable ones with more references) in every split, one
    vocab, and the JAX package's files."""
    assert_same_fixture(joint["t_dir"], joint["j_dir"])
    info, store, labels = joint["info"], joint["store"], joint["labels"]
    jinfo = CorpusInfo.load(os.path.join(joint["j_dir"], "info.json"))
    assert (info.video_ids, info.splits) == (jinfo.video_ids, jinfo.splits)
    idx = {v: i for i, v in enumerate(info.video_ids)}
    msrvtt = [idx[v] for v in info.video_ids if v.startswith("video")]
    msvd = [idx[v] for v in info.video_ids if v.startswith("msvd")]
    assert len(msrvtt) == 20 and len(msvd) == 12
    assert (store.frame_counts[msrvtt] == 9).all() and 3 <= store.frame_counts[msvd].min() < 9
    for vids in info.splits.values():
        names = [info.video_ids[i] for i in vids]
        assert any(n.startswith("video") for n in names) and any(n.startswith("msvd") for n in names)
    assert labels["ncaps"][msvd].mean() > labels["ncaps"][msrvtt].mean()
    b = joint["batches"][0]
    assert b["app"].shape == (B, 9, 16) and b["frame_mask"].shape == (B, 9)
    assert (b["frame_mask"].sum(1) >= 3).all()


def jax_mesh_steps(jcfg, jp, batches) -> tuple[list, dict]:
    """JAX's `make_parallel_train_step` over `make_mesh(2)`, one step per
    batch -> (losses, updated parameters as numpy)."""
    mesh = j_mesh.make_mesh(2)
    tx = j_state.make_optimizer(jcfg, SPE, stage="joint")
    state = j_state.create_train_state(jp, jcfg, SPE)
    step = j_mesh.make_parallel_train_step(
        j_xe.make_xe_train_step(tx, jcfg, stage="joint", jit_compile=False), mesh, donate=False)
    losses = []
    for b in batches:
        state, m = step(state, j_mesh.shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh))
        losses.append(float(m["loss"]))
    return losses, {n: np.asarray(x) for n, x in param_paths(state.params)}


def test_dp_xe_steps_with_the_2x_decoder_match_jax_mesh_steps(joint):
    """Two XE steps on the joint corpus as two gloo ranks against the JAX
    mesh step, on both ranks; the decoder is twice the encoder's width.
    At lr 1e-4, as `tests/test_torch_cli_train.py`: Adam moves a parameter
    by lr * g / (|g| + eps), so where a gradient is of the order of eps
    the sum order's difference becomes a share of lr (at lr 1e-3 one
    weight of this batch falls outside rtol 2e-4 after one step, and
    JAX's own mesh and one-device steps differ there too)."""
    assert joint["tp"].decoder.init_h.shape[1] == 2 * 16
    cfg, jcfg = (c.replace_flat({"train.lr": 1e-4}) for c in (joint["cfg"], joint["jcfg"]))
    case = dict(params_tree=bridge.to_numpy(joint["tp"]), cfg=cfg, batches=joint["batches"],
                stage="joint")
    outs = distributed.launch(rank_train_runs, 2, ([case],), device_type="cpu", timeout=60)
    want_losses, want_params = jax_mesh_steps(jcfg, joint["jp"], joint["batches"])
    for (got,) in outs:
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want_losses, rtol=1e-5)
        assert sorted(got["params"]) == sorted(want_params)
        for name, want in want_params.items():
            np.testing.assert_allclose(got["params"][name], want, **JAX_TOL, err_msg=name)


def test_evaluate_split_with_the_2x_decoder_matches_jax(joint):
    kw = dict(split="val", batch_size=3, max_len=L, max_pos_len=L)  # a padded last batch
    jm, jc = j_eval.evaluate_split(joint["jp"], joint["store"], joint["labels"], joint["info"],
                                   caption_fn=j_beam.make_beam_caption_fn(5, L, L), **kw)
    tm, tc = t_eval.evaluate_split(joint["tp"], joint["store"], joint["labels"], joint["info"],
                                   caption_fn=t_beam.make_beam_caption_fn(5, L, L), **kw)
    assert tc == jc and len(tc) == len(joint["info"].splits["val"])
    assert set(tm) == set(jm) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "CIDErD"}
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-12, abs=1e-12), k


def test_beam_scores_with_the_2x_decoder_match_jax(joint):
    b = joint["batches"][0]
    args = (b["app"], b["motion"], b["frame_mask"])
    jout = j_beam.make_beam_caption_fn(5, L, L, return_all=True)(joint["jp"], *args)
    tout = t_beam.make_beam_caption_fn(5, L, L, return_all=True)(
        joint["tp"], *map(torch.from_numpy, args))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-6)
    assert tout[0].shape == (B, 5, L)


# ------------------------------------------------------------ C3D widths


def test_xgate_at_a_c3d_aspect_matches_the_pallas_kernel():
    """`tests/test_c3d_widths.py:61`: motion much wider than appearance;
    the port's fusion (the kernel wrapper, whose CPU version is the plain
    one) against the Pallas kernel in interpret mode."""
    from controllable_xgating_tpu.ops.pallas.xgate import xgate_fuse_pallas
    from controllable_xgating_tpu.ops.xgate import init_xgate
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel
    from controllable_xgating_torch.ops.xgate import XGateWeights, xgate_fuse

    da, dm, h = 48, 256, 32
    jw = init_xgate(jax.random.PRNGKey(1), da, dm, h)
    names = ("wa", "ba", "wm", "bm", "uga", "bga", "ugm", "bgm", "wf", "bf")
    tw = XGateWeights(*(torch.from_numpy(np.array(getattr(jw, n))) for n in names))
    rng = np.random.default_rng(1)
    xa = rng.normal(size=(4, 5, da)).astype(np.float32)
    xm = rng.normal(size=(4, 5, dm)).astype(np.float32)
    want = np.asarray(xgate_fuse_pallas(jw, xa, xm, interpret=True))
    for fn in (xgate_fuse_kernel, xgate_fuse):
        got = fn(tw, torch.from_numpy(xa), torch.from_numpy(xm)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6)


C3D_SMALL = [
    "--model.hidden_dim", "24", "--model.embed_dim", "16", "--model.attn_dim", "16",
    "--model.pos_embed_dim", "16", "--model.num_frames", "5", "--model.dropout", "0.0",
    "--data.batch_size", "4", "--data.caps_per_video_train", "2", "--eval.max_decode_len", "10",
]


def test_pipeline_at_the_c3d_motion_width_gives_jax_captions(tmp_path, capsys):
    """`tests/test_c3d_widths.py:78` through the port: prepro --fixtures at
    4096-d motion, train one epoch, eval beam 2; JAX's `evaluate_split` on
    the port's `best` (carried over through numpy) gives the same
    captions, and the metrics are finite."""
    d, ck = str(tmp_path / "c3d"), str(tmp_path / "ck")
    t_prepro.main(["--out", d, "--fixtures", "--fixture_videos", "12", "--fixture_frames", "5",
                   "--fixture_app_dim", "64", "--fixture_motion_dim", "4096",
                   "--max_caption_len", "10", "--seqs_per_video", "3"])
    t_train.main(["--device", "cpu", "--data_dir", d, "--checkpoint_dir", ck, "--stage", "joint",
                  "--epochs", "1", *C3D_SMALL])
    run = os.path.join(ck, "joint")
    t_eval_cli.main(["--device", "cpu", "--data_dir", d, "--checkpoint_dir", run,
                     "--beam_size", "2", *C3D_SMALL])
    capsys.readouterr()
    with open(os.path.join(run, "eval_test.json")) as f:
        res = json.load(f)
    assert set(res["metrics"]) >= {"Bleu_4", "CIDEr"}
    assert all(np.isfinite(v) for v in res["metrics"].values())

    _, cfg = t_common.parse_with_overrides(t_common.base_parser("c3d"),
                                           ["--data_dir", d, *C3D_SMALL])
    info, labels, store, cfg = t_common.load_corpus(d, cfg)
    assert store.motion_dim == 4096 and cfg.model.motion_dim == 4096
    tree = bridge.to_numpy(t_common.restore_params(run, cfg, torch.device("cpu")))
    jcfg = JConfig().replace_flat({f"model.{k}": v for k, v in cfg.to_dict()["model"].items()})
    shapes = jax.eval_shape(lambda: j_cap.init_captioner(jax.random.PRNGKey(0), jcfg.model))
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                      [jnp.asarray(tree[n]) for n in names])
    _, jc = j_eval.evaluate_split(
        jp, store, labels, info, split="test", batch_size=cfg.data.batch_size,
        max_len=cfg.eval.max_decode_len, max_pos_len=cfg.model.max_pos_len,
        caption_fn=j_beam.make_beam_caption_fn(
            2, cfg.model.max_pos_len, cfg.eval.max_decode_len,
            length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk))
    got = res["captions"]
    assert set(got) == set(jc) and len(jc) == len(info.splits["test"])
    assert {v: (c if isinstance(c, str) else c["caption"]) for v, c in got.items()} == jc


# ------------------------------------------------ config 5's decoder width


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_beam_keeps_the_lanes_tail_at_decoder_width_1024(monkeypatch, policy):
    """Config 5's decoder (Hd 1024) stays on K4, the lanes tail: under bf16
    its chunk kernel takes 16 A tiles of 64 x 64 bf16 + the ring + 1 KiB =
    181,248 of a block's 232,448 B (a width of 1472 would not fit). Beam 5
    with `fused=True` calls the tail's wrapper with k 5 at every step and
    never routes to the grouped tail (a stand-in for the wrapper counts the
    calls on the CPU)."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.kernels import topk_tail
    from controllable_xgating_torch.ops.precision import precision

    with precision(policy):
        assert topk_tail.lanes_fits(5, 1024)
        assert topk_tail.lanes_fits(5, 1472) == (policy == "float32")
    assert 16 * topk_tail._A_TILE + topk_tail._RING + 1024 == 181_248
    cfg = Config().replace_flat({
        "model.app_dim": 16, "model.motion_dim": 12, "model.hidden_dim": 512,
        "model.embed_dim": 8, "model.attn_dim": 8, "model.pos_embed_dim": 8,
        "model.vocab_size": 30, "model.pos_vocab_size": 10, "model.num_frames": 3,
        "model.decoder_hidden_mult": 2,
    })
    params = init_captioner(cfg, seed=0, device="cpu")
    assert params.decoder.w_out.shape[0] == 1024
    calls, real = [], t_beam.logits_topk

    def counting(h, w_out, b_out, k, *args, **kwargs):
        calls.append((h.shape[1], k))
        return real(h, w_out, b_out, k, *args, **kwargs)

    monkeypatch.setattr(t_beam, "logits_topk", counting)
    rng = np.random.default_rng(0)
    app, mot = (torch.from_numpy(rng.standard_normal((2, 3, d)).astype(np.float32))
                for d in (16, 12))
    with precision(policy):
        tokens, _ = t_beam.make_beam_caption_fn(5, 4, 4, fused=True, early_stop=False)(
            params, app, mot, None)
    assert tokens.shape == (2, 4) and calls == [(1024, 5)] * 4
