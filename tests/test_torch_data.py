"""The port's feature store and corpus reader, `sample_decode`, greedy's
`lanes` opt-in and `evaluate_split_nbest`, vs the JAX package on the CPU.

The store and corpus are held equal to the JAX package's (the features
through the converter from its HDF5 file). Decoding uses seeded numpy
weights handed to both packages (`tests/test_torch_quant.py`): tokens
equal, logprobs and scores at rtol 1e-5, metrics at rel 1e-12. Sampling
draws from a `torch.Generator`, not JAX's random stream, so samples are
compared where the draw is certain (temperature 1e-4) and by their
distribution (a chi-squared test) elsewhere.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from controllable_xgating_tpu.cli import common as j_common
from controllable_xgating_tpu.data import corpus as j_corpus
from controllable_xgating_tpu.data.features import FeatureStore as JaxFeatureStore
from controllable_xgating_tpu.data.features import write_feature_file
from controllable_xgating_tpu.data.fixtures import make_fixture_corpus
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.data import corpus as t_corpus
from controllable_xgating_torch.data import features as t_features
from controllable_xgating_torch.data.vocab import PAD
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.infer import greedy as t_greedy
from controllable_xgating_torch.models import captioner as t_cap
from controllable_xgating_torch.models import decoder as t_dec
from test_torch_quant import make_cfg, numpy_params

torch.set_num_threads(1)
T = torch.from_numpy
MAX_LEN, MAX_POS = 9, 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A fixture corpus (variable frame counts) with both feature layouts."""
    d = str(tmp_path_factory.mktemp("data_corpus"))
    make_fixture_corpus(d, num_videos=18, num_frames=5, app_dim=18, motion_dim=10,
                        caps_per_video=5, seqs_per_video=5, max_caption_len=12,
                        variable_frames=True)
    t_features.main([d])
    return d


# --- the feature store ---


@pytest.mark.parametrize("in_memory", [True, False], ids=["in_memory", "mmap"])
@pytest.mark.parametrize("num_frames", [3, 5, 8], ids=["subsampled", "as_stored", "padded"])
def test_store_matches_jax(corpus, num_frames, in_memory):
    """get_batch and frame_mask equal the JAX store's on the converted
    directory, with T on disk (5) above, at and below `num_frames`, for
    unsorted indices with repeats."""
    j = JaxFeatureStore(os.path.join(corpus, "features.h5"), num_frames, in_memory=in_memory)
    t = t_features.FeatureStore(os.path.join(corpus, "features"), num_frames, in_memory=in_memory)
    assert (t.num_videos, t.app_dim, t.motion_dim) == (j.num_videos, j.app_dim, j.motion_dim)
    np.testing.assert_array_equal(t.frame_counts, j.frame_counts)
    assert (j.frame_counts < 5).any()  # some videos padded in time
    idx = np.array([4, 0, 4, 17, 2, 9])
    for a, b in zip(t.get_batch(idx), j.get_batch(idx)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.frame_mask(idx), j.frame_mask(idx))


def test_store_without_frame_counts(tmp_path):
    """Without nframes every frame is valid (frame_mask None), as the JAX
    store reads a file written without them; rewriting a directory
    without counts removes stale ones."""
    rng = np.random.default_rng(0)
    app, mot = rng.normal(size=(4, 6, 3)), rng.normal(size=(4, 6, 2))
    d = str(tmp_path / "features")
    t_features.write_feature_dir(d, app, mot, nframes=np.array([6, 2, 3, 6]))
    assert t_features.FeatureStore(d, 4).frame_mask([1]) is not None
    t_features.write_feature_dir(d, app, mot)
    write_feature_file(str(tmp_path / "f.h5"), app, mot)
    j, t = JaxFeatureStore(str(tmp_path / "f.h5"), 4), t_features.FeatureStore(d, 4)
    assert t.frame_mask([0, 1]) is None and j.frame_mask([0, 1]) is None
    assert t.frame_counts is None
    for a, b in zip(t.get_batch([3, 1]), j.get_batch([3, 1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app_shape,mot_shape,nframes,match", [
    ((3, 5, 4), (3, 4, 2), None, "align"),
    ((3, 5, 4), (3, 5, 2), [5, 5], r"\[num_videos\]"),
    ((3, 5, 4), (3, 5, 2), [5, 6, 1], r"\[1, num_frames\]"),
    ((3, 5, 4), (3, 5, 2), [5, 0, 1], r"\[1, num_frames\]"),
])
def test_write_feature_dir_checks_like_jax(tmp_path, app_shape, mot_shape, nframes, match):
    app, mot = np.zeros(app_shape), np.zeros(mot_shape)
    with pytest.raises(ValueError, match=match):
        t_features.write_feature_dir(str(tmp_path / "f"), app, mot, nframes)
    with pytest.raises(ValueError, match=match):
        write_feature_file(str(tmp_path / "f.h5"), app, mot, nframes)


def test_load_corpus_refuses_an_hdf5_only_corpus(corpus, tmp_path):
    d = str(tmp_path / "h5only")
    os.makedirs(d)
    for name in ("info.json", "labels.npz", "features.h5"):
        shutil.copy(os.path.join(corpus, name), d)
    with pytest.raises(FileNotFoundError, match="python -m controllable_xgating_torch.data.features"):
        t_common.load_corpus(d, t_common.load_config())
    t_features.main([d])  # the named command makes it readable
    info, _, store, cfg = t_common.load_corpus(d, t_common.load_config())
    assert store.num_videos == len(info.video_ids) == 18 and cfg.model.app_dim == 18


def test_load_corpus_matches_jax(corpus):
    """Info, labels, store widths and the finalized config equal the JAX
    CLI helper's."""
    jinfo, jlabels, jstore, jcfg = j_common.load_corpus(corpus, j_common.load_config())
    tinfo, tlabels, tstore, tcfg = t_common.load_corpus(corpus, t_common.load_config())
    assert tcfg.to_dict() == jcfg.to_dict()
    for field in ("video_ids", "splits", "max_caption_len", "max_pos_len", "seqs_per_video"):
        assert getattr(tinfo, field) == getattr(jinfo, field)
    assert tinfo.vocab.to_list() == jinfo.vocab.to_list()
    assert tinfo.pos_vocab.to_list() == jinfo.pos_vocab.to_list()
    assert tlabels.keys() == jlabels.keys()
    for k in jlabels:
        np.testing.assert_array_equal(tlabels[k], jlabels[k])
    assert t_corpus.SPLITS == j_corpus.SPLITS


def test_corpus_info_round_trip(corpus, tmp_path):
    """CorpusInfo.save writes what the JAX package loads, and back."""
    info = t_corpus.CorpusInfo.load(os.path.join(corpus, "info.json"))
    info.save(str(tmp_path / "info.json"))
    back = j_corpus.CorpusInfo.load(str(tmp_path / "info.json"))
    assert back.video_ids == info.video_ids and back.vocab.to_list() == info.vocab.to_list()
    again = t_corpus.CorpusInfo.load(str(tmp_path / "info.json"))
    assert again.vocab.to_list() == info.vocab.to_list()
    assert again.pos_vocab.to_list() == info.pos_vocab.to_list()
    assert (again.video_ids, again.splits, again.max_caption_len, again.max_pos_len,
            again.seqs_per_video) == (info.video_ids, info.splits, info.max_caption_len,
                                      info.max_pos_len, info.seqs_per_video)


# --- sample_decode and greedy's lanes ---


@pytest.fixture(scope="module")
def model():
    """Both packages' weights and decode contexts (3 videos, one padded)."""
    cfg = make_cfg(40)
    jp, tp = numpy_params(cfg, 41, eos_bias=0.5)
    rng = np.random.default_rng(42)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], np.float32)
    jctx, jsum, _ = j_cap.encode_for_inference(
        jp, jnp.asarray(app), jnp.asarray(mot), jnp.asarray(mask), max_pos_len=MAX_POS)
    tctx, tsum, _ = t_cap.encode_for_inference(tp, T(app), T(mot), T(mask), max_pos_len=MAX_POS)
    return jp, tp, (jctx, jsum), (tctx, tsum)


@pytest.mark.parametrize("fused", [False, True])
def test_sample_decode_at_low_temperature_matches_jax(model, fused):
    """At temperature 1e-4 the draw is the argmax: tokens equal JAX
    sample_decode's and greedy's, logprobs (under the untempered model)
    equal JAX's within rtol 1e-5, 0 after EOS."""
    jp, tp, (jctx, jsum), (tctx, tsum) = model
    jt, jl = j_greedy.sample_decode(jp.decoder, jctx, jsum, MAX_LEN, jax.random.PRNGKey(3), 1e-4)
    gen = torch.Generator().manual_seed(3)
    tt, tl = t_greedy.sample_decode(tp.decoder, tctx, tsum, MAX_LEN, gen, 1e-4, fused=fused)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt.numpy(), t_greedy.greedy_decode(tp.decoder, tctx, tsum, MAX_LEN).numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert (tl.numpy()[tt.numpy() == PAD] == 0).all() and (tt.numpy() == PAD).any()
    assert (tl.numpy()[tt.numpy() != PAD] < 0).all()


def test_sample_decode_draws_from_the_tempered_softmax(model):
    """One step at vocab 40, 20000 rows of one video: the first tokens'
    counts fit softmax(masked logits / 0.7) by a chi-squared test (p >
    1e-3); PAD and BOS are never drawn; the logprob of each draw is that
    of the untempered model."""
    _, tp, _, (tctx, tsum) = model
    n, temp = 20000, 0.7
    rep = lambda x: None if x is None else x[:1].expand(n, *x.shape[1:]).contiguous()
    ctx = t_dec.DecodeContext(*map(rep, tctx))
    tok, logp = t_greedy.sample_decode(tp.decoder, ctx, rep(tsum), 1, torch.Generator().manual_seed(7),
                                       temp)
    h, c = t_dec.init_decoder_state(tp.decoder, tsum[:1])
    logits, *_ = t_dec.decode_step(tp.decoder, t_dec.DecodeContext(*(
        None if x is None else x[:1] for x in tctx)), torch.tensor([1]), h, c)
    masked = t_greedy.mask_special_tokens(logits.float())[0]
    probs = torch.softmax(masked / temp, -1).double().numpy()
    counts = np.bincount(tok[:, 0].numpy(), minlength=40)
    assert counts[[0, 1]].sum() == 0
    keep = probs * n >= 5  # chi-squared needs expected counts >= 5: pool the rest
    exp = np.append(probs[keep] * n, probs[~keep].sum() * n)
    obs = np.append(counts[keep], counts[~keep].sum())
    if exp[-1] < 5:
        exp, obs = exp[:-1], obs[:-1]
        exp *= obs.sum() / exp.sum()
    assert stats.chisquare(obs, exp).pvalue > 1e-3
    want = torch.log_softmax(masked, -1)[tok[:, 0]]
    torch.testing.assert_close(logp[:, 0], want, rtol=1e-5, atol=1e-6)


def test_sample_decode_is_reproducible_by_seed(model):
    _, tp, _, (tctx, tsum) = model
    run = lambda seed: t_greedy.sample_decode(tp.decoder, tctx, tsum, MAX_LEN,
                                              torch.Generator().manual_seed(seed))
    (a, la), (b, lb) = run(5), run(5)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert any(not torch.equal(run(s)[0], a) for s in (6, 7, 8))


@pytest.mark.parametrize("early_stop", [False, True])
def test_greedy_lanes_matches_jax(model, monkeypatch, early_stop):
    """lanes=True takes each greedy step through the top-K tail's wrapper
    at k = 1 (on the CPU its plain version) and gives JAX
    greedy_decode(lanes=True)'s tokens; without a generator only, and not
    with vocab_q or lanes off."""
    jp, tp, (jctx, jsum), (tctx, tsum) = model
    calls = []
    real = t_greedy.logits_topk

    def spy(h, w, b, k, block_unk=False, w_op=None):
        calls.append(k)
        return real(h, w, b, k, block_unk, w_op)

    monkeypatch.setattr(t_greedy, "logits_topk", spy)
    jt = j_greedy.greedy_decode(jp.decoder, jctx, jsum, MAX_LEN, lanes=True, early_stop=early_stop)
    tt = t_greedy.greedy_decode(tp.decoder, tctx, tsum, MAX_LEN, fused=True, lanes=True,
                                early_stop=early_stop)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert calls and set(calls) == {1} and len(calls) <= MAX_LEN
    calls.clear()
    off = t_greedy.greedy_decode(tp.decoder, tctx, tsum, MAX_LEN, fused=True, early_stop=early_stop)
    t_greedy.sample_decode(tp.decoder, tctx, tsum, MAX_LEN, torch.Generator().manual_seed(0))
    assert not calls and torch.equal(off, tt)


# --- evaluate_split_nbest ---


@pytest.fixture(scope="module")
def nbest_setup(corpus):
    jinfo, jlabels, jstore, jcfg = j_common.load_corpus(corpus, j_common.load_config(
        None, {"model.hidden_dim": 20, "model.embed_dim": 12, "model.attn_dim": 12,
               "model.pos_embed_dim": 12, "model.num_frames": 5}))
    tinfo, tlabels, tstore, _ = t_common.load_corpus(corpus, t_common.load_config())
    jp, tp = numpy_params(jcfg, 43, eos_bias=0.5)
    return (jp, jstore, jlabels, jinfo), (tp, tstore, tlabels, tinfo)


@pytest.mark.parametrize("beam,nbest", [(3, 3), (5, 2)])
def test_evaluate_split_nbest_matches_jax(nbest_setup, beam, nbest):
    (jp, jstore, jlabels, jinfo), (tp, tstore, tlabels, tinfo) = nbest_setup
    jfn = j_beam.make_beam_caption_fn(beam, 12, 12, return_all=True)
    tfn = t_beam.make_beam_caption_fn(beam, 12, 12, return_all=True)
    jb, jo, jl = j_eval.evaluate_split_nbest(jp, jstore, jlabels, jinfo, jfn, nbest, split="test",
                                             batch_size=4)
    tb, to, tl = t_eval.evaluate_split_nbest(tp, tstore, tlabels, tinfo, tfn, nbest, split="test",
                                             batch_size=4)
    for got, want in ((tb, jb), (to, jo)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert tl.keys() == jl.keys() and len(tl) == len(jinfo.splits["test"])
    for v in jl:
        assert [c for c, _ in tl[v]] == [c for c, _ in jl[v]] and len(tl[v]) == nbest
        np.testing.assert_allclose([s for _, s in tl[v]], [s for _, s in jl[v]], **TOL)
    assert to["CIDErD"] >= tb["CIDErD"]


def test_evaluate_split_nbest_refuses_what_jax_refuses(nbest_setup):
    _, (tp, tstore, tlabels, tinfo) = nbest_setup
    fn = t_beam.make_beam_caption_fn(3, 12, 12, return_all=True)
    with pytest.raises(ValueError, match="exceeds the decoded beam"):
        t_eval.evaluate_split_nbest(tp, tstore, tlabels, tinfo, fn, 4, split="test")
    with pytest.raises(ValueError, match="nbest must be >= 1"):
        t_eval.evaluate_split_nbest(tp, tstore, tlabels, tinfo, fn, 0, split="test")
    with pytest.raises(ValueError, match="unknown per-video metric"):
        t_eval.evaluate_split_nbest(tp, tstore, tlabels, tinfo, fn, 2, split="test",
                                    oracle_metric="SPICE")
