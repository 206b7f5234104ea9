"""The port's captioning slice vs the JAX package, end to end, on the CPU.

Greedy and beam-5 through the port's `make_greedy_caption_fn` /
`make_beam_caption_fn` must give the JAX package's tokens exactly, and
`evaluate_split` the same captions and metrics on a fixture corpus.
Weights are numpy draws carried to both packages by the weight bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data.vocab import EOS
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch import bridge
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.dispatch import set_fused_kernels
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
MAX_LEN, MAX_POS = 9, 8


def numpy_params(cfg, seed):
    """(JAX CaptionerParams, port CaptionerParams) holding the same numpy
    draws, scaled so that captions vary and some end early."""
    shapes = jax.eval_shape(lambda: j_cap.init_captioner(jax.random.PRNGKey(0), cfg.model))
    rng = np.random.default_rng(seed)
    tree = {}
    for name, leaf in param_paths(shapes):
        if leaf.ndim == 2 and not name.endswith("embed"):
            s = 3.0 / np.sqrt(leaf.shape[0])
            tree[name] = rng.uniform(-s, s, leaf.shape).astype(np.float32)
        else:
            std = 1.0 if name.endswith("embed") else 0.05
            tree[name] = (rng.standard_normal(leaf.shape) * std).astype(np.float32)
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), [jnp.asarray(tree[n]) for n in names])
    return jp, bridge.from_numpy(tree, cfg)


@pytest.fixture(scope="module")
def setup():
    cfg = Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 20,
        "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
        "model.vocab_size": 40, "model.pos_vocab_size": 12, "model.num_frames": 5,
    })
    jp, tp = numpy_params(cfg, 11)
    rng = np.random.default_rng(12)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    t_in = tuple(map(torch.from_numpy, (app, mot, mask)))
    return jp, tp, (app, mot, mask), t_in


@pytest.mark.parametrize("early_stop,block_unk", [(True, False), (False, True)])
def test_greedy_matches_jax(setup, early_stop, block_unk):
    jp, tp, j_in, t_in = setup
    jt, jtags = j_eval.make_greedy_caption_fn(
        MAX_POS, MAX_LEN, early_stop=early_stop, block_unk=block_unk)(jp, *j_in)
    tt, ttags = t_eval.make_greedy_caption_fn(
        MAX_POS, MAX_LEN, early_stop=early_stop, block_unk=block_unk)(tp, *t_in)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert (tt == EOS).any()


@pytest.mark.parametrize("kw", [
    {},
    {"return_all": True, "length_penalty": 1.0},
    {"block_unk": True, "early_stop": False},
    {"topk_mode": "grouped", "return_all": True},
], ids=["default", "return_all_lp", "block_unk_no_early_stop", "grouped"])
def test_beam5_matches_jax(setup, kw):
    jp, tp, j_in, t_in = setup
    jout = j_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN, **kw)(jp, *j_in)
    tout = t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN, **kw)(tp, *t_in)
    assert len(jout) == len(tout)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))  # tokens
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))  # POS tags
    if kw.get("return_all"):
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-6)
        assert tout[0].shape == (3, 5, MAX_LEN)


def test_beam_lanes_tail_matches_jax_lanes_kernel(setup):
    """The port's top-K tail against the JAX lane kernel (interpret mode)."""
    jp, tp, j_in, t_in = setup
    jt, _ = j_beam.make_beam_caption_fn(3, MAX_POS, 6, topk_mode="lanes")(jp, *j_in)
    tt, _ = t_beam.make_beam_caption_fn(3, MAX_POS, 6, topk_mode="lanes")(tp, *t_in)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_plain_path_equals_kernel_path_on_cpu(setup):
    _, tp, _, t_in = setup
    kernels.reset_launch_counts()
    with_kernels = t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN)(tp, *t_in)
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}
    try:
        set_fused_kernels(False)
        plain = t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN)(tp, *t_in)
    finally:
        set_fused_kernels(None)
    for a, b in zip(with_kernels, plain):
        assert torch.equal(a, b)


def test_beam_rejects_unknown_topk_mode(setup):
    _, tp, _, t_in = setup
    with pytest.raises(ValueError, match="topk_mode"):
        t_beam.make_beam_caption_fn(3, MAX_POS, 4, topk_mode="sorted")(tp, *t_in)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from controllable_xgating_tpu.data.corpus import load_labels
    from controllable_xgating_tpu.data.features import FeatureStore
    from controllable_xgating_tpu.data.fixtures import make_fixture_corpus

    out = str(tmp_path_factory.mktemp("torch_corpus"))
    info = make_fixture_corpus(
        out, num_videos=14, num_frames=5, app_dim=12, motion_dim=10, caps_per_video=3,
        seqs_per_video=4, max_caption_len=10, seed=3,
    )
    cfg = Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 12, "model.pos_embed_dim": 12,
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.num_frames": 5,
    })
    jp, tp = numpy_params(cfg, 13)
    return info, load_labels(out), FeatureStore(out + "/features.h5", num_frames=5), jp, tp


@pytest.mark.parametrize("decoder", ["greedy", "beam5"])
def test_evaluate_split_matches_jax(corpus, decoder):
    info, labels, store, jp, tp = corpus
    kw = dict(split="val", batch_size=3, max_len=10, max_pos_len=10)  # padded last batch
    j_fn = t_fn = None
    if decoder == "beam5":
        j_fn = j_beam.make_beam_caption_fn(5, 10, 10)
        t_fn = t_beam.make_beam_caption_fn(5, 10, 10)
    jm, jc = j_eval.evaluate_split(jp, store, labels, info, caption_fn=j_fn, **kw)
    tm, tc = t_eval.evaluate_split(tp, store, labels, info, caption_fn=t_fn, **kw)
    assert tc == jc
    assert set(tm) == set(jm) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "CIDErD"}
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-12, abs=1e-12), k
