"""The port's measurement tools (`controllable_xgating_torch/tools/`:
cider_piece_timing, beam_topk_ab, ensemble_bench, profile_beam_step,
xe_breakdown, scst_breakdown, serve_bench, trace_ops) against the JAX
package's, on the CPU in f32 at a tiny config.

Each piece a tool times is run once, on JAX weights carried over by
`bridge.py`, and held against the JAX function the JAX tool times on the
same numpy inputs: CIDEr-D's hashes and lookups equal and its rewards
within rtol 1e-6; the XE pieces at dropout 0 (encoder, POS logits,
context, decoder logits, the losses and the loss gradient) within rtol
1e-5, atol 1e-6; the decode step, the logits chain's top-K and the beam
tokens of all four tails and of a two-member ensemble equal; SCST's
context, greedy rollout and reward equal. The sampled pieces draw from
torch's stream, not JAX's: they are held to themselves (one seed, one
result; the paired rollout's greedy half is the greedy rollout). Then
each tool's `main` end to end on `--device cpu` with its model cut to the
tiny config, reporting the JAX tool's rows, and without `--device cpu`
on a machine with no card, refusing with exit 1.
"""

import gzip
import io
import json
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import ensemble as j_ens
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models import decoder as j_dec
from controllable_xgating_tpu.models.captioner import init_captioner as j_init
from controllable_xgating_tpu.models.encoder import encode as j_encode
from controllable_xgating_tpu.models.pos_generator import pos_forward as j_pos_forward
from controllable_xgating_tpu.models.pos_generator import pos_greedy_generate as j_pos_greedy
from controllable_xgating_tpu.ops import cider_device as j_cd
from controllable_xgating_tpu.ops.precision import mm as j_mm
from controllable_xgating_tpu.train import xe as j_xe
from controllable_xgating_tpu.utils.config import Config as JConfig
from controllable_xgating_torch import bridge
from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn, stack_params
from controllable_xgating_torch.infer.greedy import greedy_decode, paired_rollout, sample_decode
from controllable_xgating_torch.models.captioner import init_captioner
from controllable_xgating_torch.models.decoder import decoder_forward, make_decode_context
from controllable_xgating_torch.models.encoder import encode
from controllable_xgating_torch.models.pos_generator import pos_forward
from controllable_xgating_torch.ops import cider_device as t_cd
from controllable_xgating_torch.tools import (
    beam_topk_ab,
    cider_piece_timing,
    ensemble_bench,
    profile_beam_step,
    scst_breakdown,
    serve_bench,
    trace_ops,
    xe_breakdown,
)
from controllable_xgating_torch.train.xe import masked_xe_loss, xe_losses
from controllable_xgating_torch.utils import timing
from controllable_xgating_torch.utils.config import Config
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
TINY = {
    "model.app_dim": 8, "model.motion_dim": 6, "model.hidden_dim": 8,
    "model.embed_dim": 6, "model.attn_dim": 6, "model.pos_embed_dim": 6,
    "model.vocab_size": 24, "model.pos_vocab_size": 10,
    "model.num_frames": 3, "model.max_pos_len": 5, "model.max_caption_len": 6,
    "eval.max_decode_len": 6,
}
T = torch.from_numpy
A = np.asarray


def bridged(seed: int):
    jcfg, tcfg = JConfig().replace_flat(TINY), Config().replace_flat(TINY)
    jp = j_init(jax.random.PRNGKey(seed), jcfg.model)
    return jcfg, tcfg, jp, bridge.from_numpy({n: A(x) for n, x in param_paths(jp)}, tcfg)


@pytest.fixture(scope="module")
def model():
    return bridged(0)


def tiny_build(cfg_overrides=None, device="cuda"):
    cfg = Config().replace_flat({**TINY, **(cfg_overrides or {})})
    return cfg, init_captioner(cfg, seed=0, device=device)


# ----------------------------------------------------------------- pieces


def test_cider_pieces_equal_jax():
    b = 6
    caps, ncaps, cand = cider_piece_timing.make_inputs(b)
    rng = np.random.default_rng(11)  # the JAX tool's draws, in its order
    want = rng.integers(4, 10000, (b, 20, 26))
    np.testing.assert_array_equal(caps[:, :, 1:-1], want)
    np.testing.assert_array_equal(cand[:, :-1], rng.integers(4, 10000, (b, 27)))
    jt = j_cd.build_reward_tables(caps, ncaps, list(range(b)))
    tt = t_cd.build_reward_tables(caps, ncaps, list(range(b)), device="cpu")
    vidx = np.arange(b, dtype=np.int32)

    jh = [A(x) for x in j_cd._device_hashes(jnp.asarray(cand))]
    th = [x.numpy() for x in t_cd._device_hashes(T(cand))]
    for j, t in zip(jh, th):
        np.testing.assert_array_equal(t, j.astype(t.dtype))
    np.testing.assert_array_equal(
        t_cd._idf_lookup(tt, *map(T, th)).numpy(), A(j_cd._idf_lookup(jt, *map(jnp.asarray, jh))))
    np.testing.assert_array_equal(
        t_cd._self_tf(*map(T, th)).numpy(), A(j_cd._self_tf(*map(jnp.asarray, jh))))

    j_reward = lambda c: A(j_cd.cider_d_device(jt, jnp.asarray(c), jnp.asarray(vidx)))
    r1, r2 = cider_piece_timing.two_calls(tt, T(cand), T(vidx))
    np.testing.assert_allclose(r1.numpy(), j_reward(cand), rtol=1e-6)
    np.testing.assert_allclose(r2.numpy(), j_reward(cand[::-1]), rtol=1e-6)
    one = cider_piece_timing.one_call(tt, T(cand), T(vidx)).numpy()
    np.testing.assert_allclose(one, np.concatenate([r1.numpy(), r2.numpy()]), rtol=0, atol=1e-6)

    v = jnp.asarray(vidx)
    for f, got in zip(cider_piece_timing.REF_FIELDS, cider_piece_timing.ref_gather(
            tt, T(vidx).long())):
        want = A(getattr(jt, f)[v])
        if want.dtype == np.float32:  # statistics of the tables: test_torch_scst.py's bar
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=f)
        else:  # hashes as int32 here, uint32 there: the same bits
            np.testing.assert_array_equal(got.numpy().view(want.dtype), want, err_msg=f)
    refs = cider_piece_timing.ref_gather(tt, T(vidx).long())[:5]
    dot = cider_piece_timing.match_dot(t_cd._as_int32(T(th[0])), t_cd._as_int32(T(th[1])),
                                       T(th[2]), *refs)
    rh1, rh2, rv, rtf, ridf = (getattr(jt, f)[v] for f in ("ref_h1", "ref_h2", "ref_valid",
                                                            "ref_tf", "ref_idf"))
    h1, h2, cv = map(jnp.asarray, jh)
    eq = ((h1[:, None, :, :, None] == rh1[:, :, :, None, :])
          & (h2[:, None, :, :, None] == rh2[:, :, :, None, :])
          & cv[:, None, :, :, None] & rv[:, :, :, None, :])
    jdot = (jnp.minimum(eq.sum(3).astype(jnp.float32), rtf) * ridf * ridf).sum(-1)
    np.testing.assert_allclose(dot.numpy(), A(jdot), rtol=1e-6)


def test_xe_pieces_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    b, k = 3, xe_breakdown.K
    batch = timing.bench_train_batch(tcfg, b, k)
    app, mot = batch["app"], batch["motion"]
    caps = batch["caps"].reshape(b * k, -1)
    pos = batch["pos"].reshape(b * k, -1)
    with torch.no_grad():
        t_enc, t_sum = encode(tp.encoder, T(app), T(mot))
    j_enc, j_sum = j_encode(jp.encoder, jnp.asarray(app), jnp.asarray(mot), None, None, 0.0)
    np.testing.assert_allclose(t_enc.numpy(), A(j_enc), **TOL)
    t_sum_k, j_sum_k = t_sum.repeat_interleave(k, 0), jnp.repeat(j_sum, k, 0)
    with torch.no_grad():
        t_pl, t_psi = pos_forward(tp.pos, t_sum_k, T(pos))
        t_ctx = make_decode_context(tp.decoder, t_enc.repeat_interleave(k, 0), t_psi)
    j_pl, j_psi = j_pos_forward(jp.pos, j_sum_k, jnp.asarray(pos))
    j_ctx = j_dec.make_decode_context(jp.decoder, jnp.repeat(j_enc, k, 0), j_psi)
    np.testing.assert_allclose(t_pl.numpy(), A(j_pl), **TOL)
    np.testing.assert_allclose(t_ctx.keys.numpy(), A(j_ctx.keys), **TOL)
    with torch.no_grad():
        t_lg = decoder_forward(tp.decoder, t_ctx, t_sum_k, T(caps), None, 0.0,
                                            remat=True)
    j_lg = j_dec.decoder_forward(jp.decoder, j_ctx, j_sum_k, jnp.asarray(caps), None, 0.0,
                                 remat=True)
    np.testing.assert_allclose(t_lg.numpy(), A(j_lg), **TOL)

    targets = caps[:, 1:]
    x = np.random.default_rng(2).normal(size=t_lg.shape).astype(np.float32)
    j_loss = float(j_xe.masked_xe_loss(jnp.asarray(x), jnp.asarray(targets)))
    j_grad = A(jax.grad(lambda z: j_xe.masked_xe_loss(z, jnp.asarray(targets)))(jnp.asarray(x)))
    for kernels in (False, True):
        with xe_breakdown.routed(kernels):
            np.testing.assert_allclose(float(masked_xe_loss(T(x), T(targets))), j_loss, **TOL)
            np.testing.assert_allclose(xe_breakdown.loss_grad(T(x), T(targets)).numpy(), j_grad,
                                       **TOL)
    with torch.no_grad():
        t_tot = xe_losses(tp, {kk: T(v) for kk, v in batch.items()}, None, 0.0, remat=True)
    j_tot = j_xe.xe_losses(jp, {kk: jnp.asarray(v) for kk, v in batch.items()}, None, 0.0,
                           remat=True)
    np.testing.assert_allclose([float(v) for v in t_tot], [float(v) for v in j_tot], **TOL)


def test_decode_pieces_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    b, k = 3, profile_beam_step.K
    s = profile_beam_step.setup(tcfg, tp, b, torch.device("cpu"))
    j_enc, j_sum = j_encode(jp.encoder, jnp.asarray(s["app"].numpy()),
                            jnp.asarray(s["motion"].numpy()))
    np.testing.assert_allclose(s["summary"].numpy(), A(j_sum), **TOL)
    j_ctx_k = jax.tree.map(lambda x: None if x is None else jnp.repeat(x, k, 0),
                           j_dec.make_decode_context(jp.decoder, j_enc, jnp.asarray(_psi(tcfg, b))),
                           is_leaf=lambda x: x is None)
    np.testing.assert_allclose(s["ctx_k"].keys.numpy(), A(j_ctx_k.keys), **TOL)
    np.testing.assert_allclose(s["ctx_k"].psi_g.numpy(), A(j_ctx_k.psi_g), **TOL)
    h, c = j_dec.init_decoder_state(jp.decoder, jnp.repeat(j_sum, k, 0))
    np.testing.assert_allclose(s["h"].numpy(), A(h), **TOL)
    tok = jnp.asarray(s["tok"].numpy())
    _, jh2, jc2, _ = j_dec.decode_step(jp.decoder, j_ctx_k, tok, h, c, fused=False)
    for fused in (False, True):
        with torch.no_grad():
            th2, tc2 = profile_beam_step.decode_core(tp.decoder, s["ctx_k"], s["tok"], s["h"],
                                                     s["c"], fused)
        np.testing.assert_allclose(th2.numpy(), A(jh2), **TOL)
        np.testing.assert_allclose(tc2.numpy(), A(jc2), **TOL)
    with torch.no_grad():
        tv, ti = profile_beam_step.logits_chain(tp.decoder, th2, b)
    logits = j_greedy.mask_special_tokens(j_mm(jh2, jp.decoder.w_out)
                                          + jp.decoder.b_out.astype(jnp.float32))
    jv, ji = jax.lax.top_k(jax.nn.log_softmax(logits, -1).reshape(b, -1), k)
    np.testing.assert_array_equal(ti.numpy(), A(ji))
    np.testing.assert_allclose(tv.numpy(), A(jv), **TOL)


def _psi(tcfg, b):
    """The JAX tool's psi draw: after app and motion from seed 0."""
    m = tcfg.model
    rng = np.random.default_rng(0)
    rng.normal(size=(b, m.num_frames, m.app_dim))
    rng.normal(size=(b, m.num_frames, m.motion_dim))
    return rng.normal(size=(b, m.pos_embed_dim)).astype(np.float32)


def test_beam_forms_and_ensemble_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    app, mot = timing.random_batch(tcfg, 4, seed=3)
    forms = {}
    for mode in beam_topk_ab.MODES:
        t_tok = timing.make_fn(tcfg, topk_mode=mode)(tp, T(app), T(mot))[0]
        j_tok = bench.make_fn(jcfg, topk_mode=mode)(jp, jnp.asarray(app), jnp.asarray(mot))[0]
        np.testing.assert_array_equal(t_tok.numpy(), A(j_tok))
        forms[mode] = t_tok
    assert all(torch.equal(forms["flat"], t) for t in forms.values())
    *_, jp1, tp1 = bridged(1)
    t_ens = make_ensemble_caption_fn(timing.BEAM, tcfg.model.max_pos_len, timing.MAX_LEN,
                                     early_stop=False)(stack_params([tp, tp1]), T(app), T(mot))
    j_ens_tok = j_ens.make_ensemble_caption_fn(timing.BEAM, jcfg.model.max_pos_len,
                                               timing.MAX_LEN, early_stop=False)(
        j_ens.stack_params([jp, jp1]), jnp.asarray(app), jnp.asarray(mot))
    np.testing.assert_array_equal(t_ens[0].numpy(), A(j_ens_tok[0]))


def test_scst_pieces_equal_jax(model):
    jcfg, tcfg, jp, tp = model
    b, max_len = 5, tcfg.eval.max_decode_len
    caps, ncaps, feats = scst_breakdown.make_inputs(tcfg, b)
    app, mot, vidx = feats["app"], feats["motion"], feats["video_indices"]
    with torch.no_grad():
        ctx, summary, psi = scst_breakdown.encode_psi(tp, T(app), T(mot), tcfg.model.max_pos_len)
    j_enc, j_sum = j_encode(jp.encoder, jnp.asarray(app), jnp.asarray(mot))
    _, j_psi = j_pos_greedy(jp.pos, j_sum, jcfg.model.max_pos_len)
    j_ctx = j_dec.make_decode_context(jp.decoder, j_enc, j_psi, None)
    np.testing.assert_allclose(psi.numpy(), A(j_psi), **TOL)
    np.testing.assert_allclose(ctx.keys.numpy(), A(j_ctx.keys), **TOL)
    np.testing.assert_allclose(summary.numpy(), A(j_sum), **TOL)
    j_tok = A(j_greedy.greedy_decode(jp.decoder, j_ctx, j_sum, max_len))
    with torch.no_grad():
        for fused in (None, True):
            tok = greedy_decode(tp.decoder, ctx, summary, max_len, fused=fused)
            np.testing.assert_array_equal(tok.numpy(), j_tok)
    tt = t_cd.build_reward_tables(caps, ncaps, list(range(b)), device="cpu")
    jt = j_cd.build_reward_tables(caps, ncaps, list(range(b)))
    np.testing.assert_allclose(
        t_cd.cider_d_device(tt, tok, T(vidx)).numpy(),
        A(j_cd.cider_d_device(jt, jnp.asarray(j_tok), jnp.asarray(vidx))), rtol=1e-6)

    def sampled(fn):
        return fn(torch.Generator().manual_seed(3))

    with torch.no_grad():
        s1 = sampled(lambda g: sample_decode(tp.decoder, ctx, summary, max_len, g)[0])
        s2 = sampled(lambda g: sample_decode(tp.decoder, ctx, summary, max_len, g)[0])
        g1, p1 = sampled(lambda g: paired_rollout(tp.decoder, ctx, summary, max_len, g))
        g2, p2 = sampled(lambda g: paired_rollout(tp.decoder, ctx, summary, max_len, g,
                                                  fused=True))
    assert torch.equal(s1, s2) and torch.equal(p1, p2) and torch.equal(p1, s1)
    assert torch.equal(g1, tok) and torch.equal(g2, tok)


# ---------------------------------------------------------- serve, trace


JAX_POINT_KEYS = {"offered_rps", "achieved_rps", "n", "rejected", "latency_ms_p50",
                  "latency_ms_p99", "mean_ride_bucket"}


def test_serve_load_point_keys(monkeypatch):
    monkeypatch.setattr(timing, "build", tiny_build)
    engine = serve_bench.build_engine("beam", (1, 4), 4.0, shed_margin=1.3, device="cpu")
    try:
        point = serve_bench.run_load_point(engine, 60.0, 0.3, np.random.default_rng(0),
                                           deadline_ms=2000.0)
    finally:
        engine.close()
    assert set(point) == JAX_POINT_KEYS | {"deadline_ms", "expired", "late_completions"}
    assert point["n"] >= 1 and point["latency_ms_p50"] <= point["latency_ms_p99"]
    assert not engine._dispatcher.is_alive()


def chrome_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_trace_sums_device_events(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_ops.parse_trace(str(tmp_path))
    k = lambda name, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "dur": dur,
                                         "pid": 0, "args": {"device": 0}}
    chrome_trace(tmp_path / "a.pt.trace.json", [
        k("void cxg::attn_rows_kernel<bf16>(...)", 30.0),
        k("void cxg::attn_rows_kernel<bf16>(...)", 20.0),
        k("Memcpy HtoD (Pageable -> Device)", 5.0, "gpu_memcpy"),
        k("Memset (Device)", 1.0, "gpu_memset"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 500.0, "pid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "cxg_attn_lstm_fwd", "dur": 80.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "s": "t"},
    ])
    (tmp_path / "sub").mkdir()
    chrome_trace(tmp_path / "sub" / "b.pt.trace.json.gz", [
        k("void cxg::xgate_chain_kernel<1>(...)", 12.0),
        k("void cxg::xgate_chain_kernel<2>(...)", 12.0),
        k("void cxg::xgate_chain_kernel<3>(...)", 12.0),
        k("ampere_sgemm", 8.0),
    ], gz=True)
    r = trace_ops.parse_trace(str(tmp_path), top=40)
    assert r["total_device_us"] == 100.0 and r["devices"] == [0]
    ops = [(o["op"], o["us"]) for o in r["ops"]]
    assert ops[0] == ("void cxg::attn_rows_kernel<bf16>(...)", 50.0)
    assert dict(ops) == {"void cxg::attn_rows_kernel<bf16>(...)": 50.0,
                         "void cxg::xgate_chain_kernel<1>(...)": 12.0,
                         "void cxg::xgate_chain_kernel<2>(...)": 12.0,
                         "void cxg::xgate_chain_kernel<3>(...)": 12.0, "ampere_sgemm": 8.0,
                         "Memcpy HtoD (Pageable -> Device)": 5.0, "Memset (Device)": 1.0}
    assert [o["us"] for o in r["ops"]] == sorted((o["us"] for o in r["ops"]), reverse=True)
    assert sum(o["pct"] for o in r["ops"]) == pytest.approx(100.0, abs=0.02)
    assert r["port_kernel_events"] == {"attn_lstm": 2.0, "xgate": 1.0}
    assert len(trace_ops.parse_trace(str(tmp_path), top=2)["ops"]) == 2


# ------------------------------------------------------------ the mains


def quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        ret = main(argv)
    return ret, out.getvalue()


CPU_ARGS = ["--device", "cpu", "--batch", "2"]
TOOLS = {
    "cider_piece_timing": (cider_piece_timing, ["--device", "cpu", "--batch", "3", "--reps", "1,2"]),
    "beam_topk_ab": (beam_topk_ab, CPU_ARGS + ["--reps", "1,2"]),
    "ensemble_bench": (ensemble_bench, CPU_ARGS + ["--reps", "1,2", "--members", "1,2",
                                                   "--repeats", "1"]),
    "profile_beam_step": (profile_beam_step, CPU_ARGS + ["--reps", "1,2"]),
    "xe_breakdown": (xe_breakdown, CPU_ARGS + ["--reps", "1,2"]),
    "scst_breakdown": (scst_breakdown, CPU_ARGS + ["--reps", "1,2"]),
    "serve_bench": (serve_bench, ["--device", "cpu", "--buckets", "1,2", "--rates", "40",
                                  "--duration", "0.2", "--deadline_ms", "2000"]),
    "trace_ops": (trace_ops, CPU_ARGS + ["--reps", "1", "--workload", "xe"]),
}
XE_ROWS = ["encoder", "pos_teacher", "context", "dec_fwd", "logits_matmul", "loss_lse",
           "loss_fwdbwd", "fwd_total", "step_total", "loss_lse_KERNEL", "loss_fwdbwd_KERNEL",
           "step_total_KERNEL", "dec_scan (derived)", "bwd+opt (derived)",
           "fwd_unattributed (derived)"]


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_reports_jax_rows(name, monkeypatch, tmp_path):
    monkeypatch.setattr(timing, "build", tiny_build)
    mod, argv = TOOLS[name]
    if name == "trace_ops":
        argv = argv + ["--out", str(tmp_path / "tr")]
    ret, out = quiet(mod.main, argv)
    last = out.strip().splitlines()[-1] if name in ("beam_topk_ab", "ensemble_bench") else None
    if name == "cider_piece_timing":
        assert json.loads(out) == ret and list(ret) == [
            "batch", "device", "df_table_size", "timings_ms", "device_ms", "launches"]
        assert list(ret["timings_ms"]) == ["two_calls_B", "one_call_2B", "ref_gather",
                                           "cand_hash", "idf_lookup", "self_tf", "match_dot"]
    elif name == "beam_topk_ab":
        assert list(ret["forms"]) == ["lanes", "block", "grouped", "flat"]
        assert json.loads(last) == ret and "lanes vs flat:" in out
    elif name == "ensemble_bench":
        assert list(ret["points"]) == ["M=1", "M=2"] and json.loads(last) == ret
        assert {"captions_per_sec", "stats"} <= set(ret["points"]["M=1"])
        assert "per_member_vs_single" in ret["points"]["M=2"]
    elif name == "profile_beam_step":
        assert list(ret["summary"]) == ["decode_jnp", "decode_fused", "logits_chain",
                                        "logits_matmul", "full_beam_step(prod/28)", "xe_fwd",
                                        "xe_step"]
        assert ret["roofline"] == timing.NO_SHARES and "mfu" not in ret["pieces"]["xe_step"]
    elif name == "xe_breakdown":
        assert list(ret["pieces"]) == XE_ROWS and ret["roofline"] == timing.NO_SHARES
        assert {"batch", "k", "rows", "len", "vocab", "device", "routing"} <= set(ret)
    elif name == "scst_breakdown":
        assert list(ret["timings_ms"]) == ["encode_psi", "greedy_rollout", "sample_rollout",
                                           "paired_rollout", "cider_candidate",
                                           "loss_forward_original", "loss_forward_paired",
                                           "step_original", "step_paired"]
        assert list(ret["videos_per_sec"]) == ["original", "paired"]
    elif name == "serve_bench":
        assert len(ret) == 1 and set(ret[0]) == JAX_POINT_KEYS | {
            "deadline_ms", "expired", "late_completions", "mode", "engine_stats"}
        assert set(ret[0]["engine_stats"]) == set(serve_bench.STATS_KEYS)
    else:
        assert {"devices", "total_device_us", "ops", "workload", "launches"} <= set(ret)
        assert "setup.init" in ret["settle_spans"]["spans"]  # the set-up is collected too
        parsed, _ = quiet(trace_ops.main, ["--parse", str(tmp_path / "tr")])
        assert parsed["total_device_us"] == ret["total_device_us"]


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_without_card(name, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--out", str(tmp_path)] if name == "trace_ops" else []
    with pytest.raises(SystemExit) as e:
        TOOLS[name][0].main(argv)
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
