"""The port's SCST slice vs the JAX package's, on the CPU in f32.

The on-device CIDEr-D reward (`ops/cider_device.py`): the n-gram hashes
and the reward tables bit for bit, the reference statistics within 1e-6,
the bucket lookup against the full-range lookup bit for bit, the reward
within rtol 1e-5, atol 1e-6 of JAX's and within rtol 1e-4, atol 1e-5 of
the host `CiderDScorer` (the JAX package's own bar, `tests/test_scst.py`).
The rollouts token for token. The loss: torch's random stream is not
JAX's, so the port is held to JAX at JAX's sampled tokens, through
`paired_loss` (the code `scst_loss` runs after its paired rollout): loss,
aux and every gradient within rtol 1e-5, atol 1e-6. The two realizations
against each other under one generator seed at JAX's own bar for that
comparison. One train step. The CLI (`--stage scst`, the
`train.scst_start_epoch` switch) is held in `tests/test_torch_cli.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data.corpus import load_labels
from controllable_xgating_tpu.data.features import FeatureStore
from controllable_xgating_tpu.data.fixtures import make_fixture_corpus
from controllable_xgating_tpu.data.loader import TrainBatchIterator
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models.decoder import make_decode_context as j_make_ctx
from controllable_xgating_tpu.models.encoder import encode as j_encode
from controllable_xgating_tpu.models.pos_generator import pos_greedy_generate as j_pos_greedy
from controllable_xgating_tpu.ops import cider_device as j_cd
from controllable_xgating_tpu.train import scst as j_scst
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.infer import greedy as t_greedy
from controllable_xgating_torch.metrics.cider import CiderDScorer, compute_doc_freq
from controllable_xgating_torch.ops import cider_device as t_cd
from controllable_xgating_torch.ops.kernels import attn_lstm as k_attn
from controllable_xgating_torch.train import scst as t_scst
from controllable_xgating_torch.train import state as t_state
from controllable_xgating_torch.train.xe import batch_to_device, param_grads
from test_torch_quant import numpy_params
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)        # port vs JAX
HOST_TOL = dict(rtol=1e-4, atol=1e-5)   # reward vs the host scorer (tests/test_scst.py)
MAX_LEN = 12


def random_corpus(rng, n_videos=12, s=4, length=14, vocab=40):
    """Captions BOS, 3 .. length-3 words, EOS, PAD; 2..s real per video."""
    caps = np.zeros((n_videos, s, length), np.int32)
    ncaps = rng.integers(2, s + 1, n_videos).astype(np.int32)
    for v in range(n_videos):
        for j in range(ncaps[v]):
            n = int(rng.integers(3, length - 2))
            caps[v, j, 0] = BOS
            caps[v, j, 1:1 + n] = rng.integers(4, vocab, n)
            caps[v, j, 1 + n] = EOS
    return caps, ncaps


def candidates(rng, caps, vocab=40, length=12):
    """Decoded-style candidates (no BOS): a reference's words where v % 3
    is 0, random words otherwise, and an empty one (EOS first) at v % 5 == 4."""
    n = caps.shape[0]
    cand = np.zeros((n, length), np.int32)
    for v in range(n):
        if v % 5 == 4:
            cand[v, 0] = EOS
        elif v % 3 == 0:
            words = caps[v, 0, 1:][:length]
            cand[v, :len(words)] = words
        else:
            k = int(rng.integers(2, length - 1))
            cand[v, :k] = rng.integers(4, vocab, k)
            cand[v, k] = EOS
    return cand


# ------------------------------------------------------------------ hashes

@pytest.mark.parametrize("ids", ["random", "top_of_range", "with_specials"])
def test_device_hashes_match_jax_bit_for_bit(ids):
    rng = np.random.default_rng(0)
    if ids == "random":
        tok = rng.integers(0, 10000, (64, 30))
    elif ids == "top_of_range":
        tok = rng.integers(9990, 10000, (64, 30))
        tok[0] = 9999
    else:
        tok = rng.integers(4, 10000, (64, 30))
        tok[rng.random(tok.shape) < 0.15] = rng.choice([PAD, BOS, EOS])
    tok = tok.astype(np.int32)
    jh1, jh2, jv = (np.asarray(x) for x in j_cd._device_hashes(jnp.asarray(tok)))
    th1, th2, tv = t_cd._device_hashes(torch.from_numpy(tok))
    np.testing.assert_array_equal(th1.numpy(), jh1.astype(np.int64))
    np.testing.assert_array_equal(th2.numpy(), jh2.astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), jv)
    # the accumulator runs past 2^31: the hashes use the unsigned order
    assert (th1 >= 2 ** 31).any() and (th2 >= 2 ** 31).any() and int(th1.max()) < 2 ** 32


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("corpus", ["random", "no_df_videos", "wordless_df_videos"])
def test_reward_tables_match_jax(corpus):
    rng = np.random.default_rng(1)
    caps, ncaps = random_corpus(rng)
    df_idx = list(range(0, 12, 2)) + [4]  # a video listed twice counts twice
    if corpus == "no_df_videos":
        df_idx = []
    elif corpus == "wordless_df_videos":
        caps[:6, :, 1:] = 0
        caps[:6, :, 1] = EOS
        df_idx = list(range(6))
    jt = j_cd.build_reward_tables(caps, ncaps, df_idx)
    tt = t_cd.build_reward_tables(caps, ncaps, df_idx, device="cpu")
    np.testing.assert_array_equal(tt.table_rows.numpy(), np.asarray(jt.table_rows).astype(np.int64))
    np.testing.assert_array_equal(tt.table_dir.numpy(), np.asarray(jt.table_dir))
    assert (tt.dir_bits, tt.bucket_steps) == (jt.dir_bits, jt.bucket_steps)
    assert tt.log_n.dtype == torch.float32 and float(tt.log_n) == float(jt.log_n)
    if corpus != "random":
        assert tt.table_rows.shape == (1, 4) and not tt.table_rows.any()
    for name in ("ref_h1", "ref_h2"):
        np.testing.assert_array_equal(getattr(tt, name).numpy().view(np.uint32),
                                      np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(tt.ref_valid.numpy(), np.asarray(jt.ref_valid))
    for name in ("ref_tf", "ref_idf", "ref_norm", "ref_wordlen"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_bucket_lookup_equals_full_range_lookup_bit_for_bit():
    """The bucket-directory bisection gives the same bits as the full-range
    bisection of the column form, on present, near-miss (+1 on h2),
    random and extreme keys, with invalid positions zeroed."""
    rng = np.random.default_rng(7)
    caps = np.zeros((40, 5, 16), np.int32)
    caps[:, :, 0] = BOS
    caps[:, :, 1:-1] = rng.integers(4, 300, (40, 5, 14))
    caps[:, :, -1] = EOS
    tables = t_cd.host_tables(caps, np.full(40, 5), list(range(40)))
    rows = tables.table_rows
    m = rows.shape[0]
    d = tables.table_dir.numpy()
    assert d.shape == (1 << tables.dir_bits, 2) and d[0, 0] == 0 and d[-1, 1] == m
    assert (d[1:, 0] == d[:-1, 1]).all()
    cols = t_cd.CiderRewardTables(
        log_n=tables.log_n, ref_caps=tables.ref_caps, ref_counts=tables.ref_counts,
        table_h1=rows[:, 0], table_h2=rows[:, 1],
        table_df=torch.from_numpy(rows[:, 2].numpy().astype(np.uint32).view(np.float32)))
    idx = torch.from_numpy(rng.integers(0, m, 128))
    q1, q2 = rows[idx, 0], rows[idx, 1]
    r1, r2 = (torch.from_numpy(rng.integers(0, 2 ** 32, 128, dtype=np.int64)) for _ in range(2))
    ext1 = torch.tensor([0, 0, 2 ** 32 - 1, 2 ** 32 - 1])
    ext2 = torch.tensor([0, 2 ** 32 - 1, 0, 2 ** 32 - 1])
    h1 = torch.cat([q1, q1, r1, ext1])
    h2 = torch.cat([q2, (q2 + 1) & 0xFFFFFFFF, r2, ext2])
    valid = torch.ones(h1.shape, dtype=torch.bool)
    valid[::7] = False
    got = t_cd._idf_lookup(tables, h1, h2, valid)
    want = t_cd._idf_lookup(cols, h1, h2, valid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # present keys find their own row's df
    df = cols.table_df[idx]
    want_present = torch.where(valid[:128], tables.log_n - torch.log(df.clamp(min=1.0)), 0.0)
    assert torch.equal(got[:128], want_present) and (df > 1).any()
    # and the same idf as the JAX package's lookup of the same keys
    jt = j_cd.build_reward_tables(caps, np.full(40, 5), list(range(40)))
    jidf = j_cd._idf_lookup(jt, jnp.asarray(h1.numpy().astype(np.uint32)),
                            jnp.asarray(h2.numpy().astype(np.uint32)), jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jidf), **TOL)


# ------------------------------------------------------------------ reward

def words(ids):
    """ids -> 'w<id> ...' up to EOS, for the host scorer (a bijection)."""
    out = []
    for t in ids:
        if int(t) == EOS:
            break
        if int(t) not in (PAD, BOS):
            out.append(f"w{int(t)}")
    return " ".join(out)


def test_cider_d_device_matches_jax_and_the_host_scorer():
    rng = np.random.default_rng(2)
    caps, ncaps = random_corpus(rng, n_videos=16)
    df_idx = list(range(10))
    cand = candidates(rng, caps)
    vi = np.concatenate([np.arange(16), rng.integers(0, 16, 16)])
    cand = np.concatenate([cand, cand[rng.permutation(16)]])
    jt = j_cd.build_reward_tables(caps, ncaps, df_idx)
    tt = t_cd.build_reward_tables(caps, ncaps, df_idx, device="cpu")
    got = t_cd.cider_d_device(tt, torch.from_numpy(cand), torch.from_numpy(vi)).numpy()
    want = np.asarray(j_cd.cider_d_device(jt, jnp.asarray(cand), jnp.asarray(vi)))
    np.testing.assert_allclose(got, want, **TOL)
    gts = {f"v{v}": [words(caps[v, j]) for j in range(ncaps[v])] for v in range(16)}
    df, num = compute_doc_freq({k: gts[k] for k in (f"v{v}" for v in df_idx)})
    scorer = CiderDScorer(df=df, df_num_segments=num)
    host = [scorer.score({"k": gts[f"v{v}"]}, {"k": [words(c)]})[0] for c, v in zip(cand, vi)]
    np.testing.assert_allclose(got, host, **HOST_TOL)
    assert (got > 0).sum() >= 8


def test_cider_d_device_own_reference_beats_another_and_empty_scores_zero():
    rng = np.random.default_rng(3)
    caps, ncaps = random_corpus(rng, n_videos=6)
    tt = t_cd.build_reward_tables(caps, ncaps, list(range(6)), device="cpu")
    cand = torch.from_numpy(np.concatenate([caps[:, 0, 1:], np.zeros((6, 1), np.int32)], 1))
    own = t_cd.cider_d_device(tt, cand, torch.arange(6))
    other = t_cd.cider_d_device(tt, cand, torch.roll(torch.arange(6), 1))
    assert (own > other).all() and (own > 1.0).all()
    empty = torch.full((6, 12), PAD)
    empty[:, 0] = EOS
    assert torch.equal(t_cd.cider_d_device(tt, empty, torch.arange(6)), torch.zeros(6))


# ------------------------------------------------------- rollouts and loss

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The fixture corpus of `tests/test_scst.py`, a batch of it, the same
    weights in both packages, both packages' reward tables, and JAX's paired
    SCST loss, gradients and sampled tokens (the one compile-heavy JAX call
    of this file)."""
    out = str(tmp_path_factory.mktemp("scst"))
    info = make_fixture_corpus(
        out, num_videos=16, num_frames=5, app_dim=16, motion_dim=10, caps_per_video=3,
        seqs_per_video=5, max_caption_len=12, seed=11)
    labels = load_labels(out)
    store = FeatureStore(out + "/features.h5", num_frames=5)
    cfg = Config().replace_flat({
        "model.app_dim": 16, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 10, "model.attn_dim": 10, "model.pos_embed_dim": 10,
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.num_frames": 5, "model.max_caption_len": 12, "model.max_pos_len": 12,
        "model.dropout": 0.5, "data.batch_size": 6, "data.caps_per_video_train": 2,
        "train.lr": 1e-3, "eval.max_decode_len": MAX_LEN,
    })
    it = TrainBatchIterator(store, labels["caps"], labels["pos"], labels["ncaps"],
                            np.asarray(info.splits["train"]), 6, 2, seed=3)
    batch = next(iter(it))
    jp, tp = numpy_params(cfg, seed=5, eos_bias=0.5)
    jtables = j_scst.build_scst_reward_tables(info, labels)
    ttables = t_scst.build_scst_reward_tables(info, labels, device="cpu")
    rng = jax.random.PRNGKey(9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return j_scst.scst_loss(p, jb, jtables, rng, MAX_LEN, 12, paired=True)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    enc_out, summary = j_encode(jp.encoder, jb["app"], jb["motion"], jb.get("frame_mask"))
    _, psi = j_pos_greedy(jp.pos, summary, 12)
    ctx = j_make_ctx(jp.decoder, enc_out, psi, jb.get("frame_mask"))
    greedy, sample = j_greedy.paired_rollout(jp.decoder, ctx, summary, MAX_LEN, rng)
    return {
        "cfg": cfg, "info": info, "labels": labels, "batch": batch, "tp": tp, "jp": jp,
        "ttables": ttables, "jctx": ctx, "jsummary": summary,
        "jax": (float(loss), {k: float(v) for k, v in aux.items()},
                {n: np.asarray(g) for n, g in param_paths(grads)},
                np.asarray(greedy), np.asarray(sample)),
    }


def port_inputs(env):
    """Port parameters with gradient on, the batch as tensors, and the
    port's (ctx, summary) of it."""
    params = env["tp"].requires_grad_(True)
    batch = batch_to_device(env["batch"], "cpu", t_scst._BATCH_KEYS)
    ctx, summary = t_scst.scst_context(params, batch, 12)
    return params, batch, ctx, summary


def grads_of(loss, params):
    named = list(params.named_parameters())
    return dict(zip([n for n, _ in named], param_grads(loss, [p for _, p in named])))


def test_reward_tables_of_the_corpus_match_jax(env):
    jt = j_scst.build_scst_reward_tables(env["info"], env["labels"])
    tt = env["ttables"]
    np.testing.assert_array_equal(tt.table_rows.numpy(), np.asarray(jt.table_rows).astype(np.int64))
    np.testing.assert_allclose(tt.ref_norm.numpy(), np.asarray(jt.ref_norm), rtol=1e-6, atol=1e-6)


def test_greedy_baseline_matches_jax_token_for_token(env):
    """The port's baseline (greedy half of the paired rollout, and
    `greedy_decode`) equals JAX's greedy on the same weights."""
    params, _, ctx, summary = port_inputs(env)
    with torch.no_grad():
        got = t_greedy.greedy_decode(params.decoder, ctx, summary, MAX_LEN, fused=True)
    want = np.asarray(j_greedy.greedy_decode(env["jp"].decoder, env["jctx"], env["jsummary"],
                                             MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(env["jax"][3], want)  # JAX's own paired greedy half
    assert (got == EOS).any(1).any() and len({tuple(r) for r in got.tolist()}) > 1


@pytest.mark.parametrize("fused", [None, True])
def test_paired_rollout_halves_equal_greedy_and_sample_decode(env, fused):
    params, _, ctx, summary = port_inputs(env)
    g = torch.Generator().manual_seed(4)
    greedy, sample = t_greedy.paired_rollout(params.decoder, ctx, summary, MAX_LEN, g, fused=fused)
    with torch.no_grad():
        ref_g = t_greedy.greedy_decode(params.decoder, ctx, summary, MAX_LEN, fused=fused)
        ref_s, _ = t_greedy.sample_decode(params.decoder, ctx, summary, MAX_LEN,
                                          torch.Generator().manual_seed(4), fused=fused)
    assert torch.equal(greedy, ref_g) and torch.equal(sample, ref_s)
    assert not torch.equal(sample, greedy)
    assert not greedy.requires_grad and not sample.requires_grad


def test_paired_loss_and_gradients_match_jax_at_jax_tokens(env):
    """At JAX's sampled tokens (its paired rollout with the key its
    `scst_loss` used), `paired_loss` gives JAX's loss, aux and the gradient
    of every parameter; the step's mask zeroes the POS gradients."""
    jloss, jaux, jgrads, jgreedy, jsample = env["jax"]
    params, batch, ctx, summary = port_inputs(env)
    loss, aux = t_scst.paired_loss(params.decoder, ctx, summary, env["ttables"],
                                   batch["video_indices"], torch.tensor(jgreedy).long(),
                                   torch.tensor(jsample).long())
    assert loss.item() == pytest.approx(jloss, rel=TOL["rtol"], abs=TOL["atol"])
    for k, v in jaux.items():
        assert float(aux[k]) == pytest.approx(v, rel=TOL["rtol"], abs=TOL["atol"]), k
    assert abs(jaux["advantage"]) > 1e-3  # the gradient is not trivially zero
    grads = grads_of(loss, params)
    assert grads.keys() == jgrads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], **TOL, err_msg=n)
    assert any(np.abs(jgrads[n]).max() > 0 for n in jgrads if n.startswith("pos."))
    masked = t_state.apply_grad_mask(grads, t_state.stage_grad_mask(params, "caption"))
    assert all(not g.any() for n, g in masked.items() if n.startswith("pos."))


def test_unpaired_loss_matches_paired_under_one_generator_seed(env):
    """The two realizations are the same estimator: equal rewards (the same
    tokens), loss within rel 1e-4, gradients within rtol 1e-3, atol 1e-5
    (logp from the rollout vs teacher-forced: other sum orders)."""
    params, batch, *_ = port_inputs(env)
    out = {}
    for paired in (False, True):
        loss, aux = t_scst.scst_loss(params, batch, env["ttables"], torch.Generator().manual_seed(8),
                                     MAX_LEN, 12, paired=paired)
        out[paired] = (loss.item(), {k: float(v) for k, v in aux.items()}, grads_of(loss, params))
    (la, aa, ga), (lb, ab, gb) = out[False], out[True]
    assert aa == ab
    assert la == pytest.approx(lb, rel=1e-4)
    for n in ga:
        np.testing.assert_allclose(ga[n].numpy(), gb[n].numpy(), rtol=1e-3, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("paired", [False, True])
def test_rollouts_without_gradient_reach_the_decoder_step_wrapper(env, monkeypatch, paired):
    """With `fused_baseline`, the baseline (or the paired rollout) takes
    every step through the decoder-step kernel's wrapper, never under
    autograd and never with a tensor that requires grad; the sampled
    rollout with gradient (unpaired) takes the plain step."""
    seen = []
    real = k_attn.attn_lstm_step_kernel

    def spy(decoder_params, *args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        seen.append((torch.is_grad_enabled(), any(t.requires_grad for t in tensors), len(tensors[0])))
        return real(decoder_params, *args)

    monkeypatch.setattr(k_attn, "attn_lstm_step_kernel", spy)
    params, batch, *_ = port_inputs(env)
    loss, _ = t_scst.scst_loss(params, batch, env["ttables"], torch.Generator().manual_seed(8),
                               MAX_LEN, 12, fused_baseline=True, paired=paired)
    assert loss.requires_grad
    rows = 2 * 6 if paired else 6
    assert seen == [(False, False, rows)] * MAX_LEN


@pytest.mark.parametrize("paired", [False, True])
def test_scst_step_freezes_pos_and_moves_the_decoder(env, paired):
    cfg = env["cfg"].replace_flat({"train.scst_paired_rollout": paired})
    _, tp = numpy_params(cfg, seed=5, eos_bias=0.5)
    state = t_state.create_train_state(tp, cfg)
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    step = t_scst.make_scst_train_step(t_state.make_optimizer(cfg, 2, "scst"), cfg, env["ttables"])
    state, m = step(state, env["batch"])
    assert state.step == 1
    assert set(m) == {"loss", "grad_norm", "reward_sample", "reward_greedy", "advantage"}
    assert all(np.isfinite(float(v)) for v in m.values())
    after = dict(tp.named_parameters())
    for n, p in before.items():
        if n.startswith("pos."):
            assert torch.equal(after[n], p), n
    assert not torch.equal(after["decoder.w_out"], before["decoder.w_out"])
