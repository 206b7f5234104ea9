"""PyTorch port vs the JAX package, op by op, on the CPU in f32.

Every input and weight is drawn from a numpy seed and handed to both
packages. Tolerances are the JAX package's own for its kernels
(tests/test_pallas.py: rtol 1e-5, atol 1e-6 in f32). Each kernel's plain
PyTorch version is held against the JAX Pallas function run in interpret
mode, as tests/test_pallas.py runs it.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.ops import attention as j_attn
from controllable_xgating_tpu.ops import lstm as j_lstm
from controllable_xgating_tpu.ops import precision as j_prec
from controllable_xgating_tpu.ops import xgate as j_xgate
from controllable_xgating_torch.ops import attention as t_attn
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops import lstm as t_lstm
from controllable_xgating_torch.ops import precision as t_prec
from controllable_xgating_torch.ops import xgate as t_xgate
from controllable_xgating_torch.ops.dispatch import fused_enabled, set_fused_kernels

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def close(t, j, **tol):
    np.testing.assert_allclose(
        t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), **(tol or TOL)
    )


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def lstm_pair(seed, din, h):
    wih, whh, b = arrays(seed, (din, 4 * h), (h, 4 * h), (4 * h,), scale=0.3)
    return (j_lstm.LSTMWeights(wih=jnp.asarray(wih), whh=jnp.asarray(whh), b=jnp.asarray(b)),
            t_lstm.LSTMWeights(T(wih), T(whh), T(b)))


XG_FIELDS = ("wa", "ba", "wm", "bm", "uga", "bga", "ugm", "bgm", "wf", "bf")


def xgate_pair(seed, da, dm, h, mode="xgate"):
    shapes = [(da, h), (h,), (dm, h), (h,), (h, h), (h,), (h, h), (h,), (2 * h, h), (h,)]
    vals = arrays(seed, *shapes, scale=0.2)
    jw = j_xgate.XGateWeights(**{n: jnp.asarray(v) for n, v in zip(XG_FIELDS, vals)}, mode=mode)
    return jw, t_xgate.XGateWeights(*map(T, vals), mode=mode)


def attn_pair(seed, hq, he, a):
    wq, wk, b, v = arrays(seed, (hq, a), (he, a), (a,), (a,), scale=0.3)
    return (j_attn.AttentionWeights(wq=jnp.asarray(wq), wk=jnp.asarray(wk), b=jnp.asarray(b),
                                    v=jnp.asarray(v)),
            t_attn.AttentionWeights(T(wq), T(wk), T(b), T(v)))


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_mm_policy(policy):
    a, b = arrays(0, (3, 4, 24), (24, 10))
    with j_prec.precision(policy), t_prec.precision(policy):
        close(t_prec.mm(T(a), T(b)), j_prec.mm(jnp.asarray(a), jnp.asarray(b)))
        assert t_prec.mm(T(a), T(b)).dtype == torch.float32


def test_precision_rejects_unknown_dtype():
    with pytest.raises(ValueError):
        t_prec.set_compute_dtype("float16")


def test_lstm_cell_and_cell_pre():
    jw, tw = lstm_pair(1, 12, 16)
    x, h, c = arrays(2, (5, 12), (5, 16), (5, 16))
    for jo, to in zip(j_lstm.lstm_cell(jw, x, h, c), t_lstm.lstm_cell(tw, T(x), T(h), T(c))):
        close(to, jo)
    (xg,) = arrays(3, (5, 64))
    for jo, to in zip(j_lstm.lstm_cell_pre(jw, xg, h, c),
                      t_lstm.lstm_cell_pre(tw, T(xg), T(h), T(c))):
        close(to, jo)


def test_init_lstm_forget_bias():
    w = t_lstm.init_lstm(torch.Generator().manual_seed(0), 6, 8)
    assert w.wih.shape == (6, 32) and w.whh.shape == (8, 32)
    assert torch.equal(w.b[8:16], torch.ones(8)) and not w.b[:8].any() and not w.b[16:].any()
    assert float(w.wih.abs().max()) <= 6 ** -0.5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan(masked, reverse):
    jw, tw = lstm_pair(4, 10, 12)
    (xs,) = arrays(5, (3, 6, 10))
    mask = np.array([[1] * 6, [1, 1, 1, 0, 0, 0], [1, 1, 0, 0, 0, 0]], np.float32)
    jm, tm = (jnp.asarray(mask), T(mask)) if masked else (None, None)
    jhs, (jh, jc) = j_lstm.lstm_scan(jw, xs, jm, reverse=reverse)
    ths, (th, tc) = t_lstm.lstm_scan(tw, T(xs), tm, reverse=reverse)
    close(ths, jhs)
    close(th, jh)
    close(tc, jc)
    if masked:  # masked steps emit zero
        assert not ths[1, 3:].any()


def test_bilstm_scan_masked():
    jf, tf = lstm_pair(6, 8, 10)
    jb, tb = lstm_pair(7, 8, 10)
    (xs,) = arrays(8, (2, 5, 8))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], np.float32)
    jhs, (jh, jc) = j_lstm.bilstm_scan(jf, jb, xs, jnp.asarray(mask))
    ths, (th, tc) = t_lstm.bilstm_scan(tf, tb, T(xs), T(mask))
    close(ths, jhs)
    close(th, jh)
    close(tc, jc)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["lstm", "bilstm"])
def test_hoisted_scan_grads_match_jax(policy, masked, bidirectional):
    """The scan with its input projection hoisted into one product: the
    gradients of a loss over its outputs and final state, by wih, whh, b
    and xs, against the VJP of the JAX package's per-step scan (its `mm`'s
    custom VJP on both sides). The products are the same bf16-exact
    products; only the order of the f32 sums differs."""
    pairs = [lstm_pair(11, 8, 10)] + ([lstm_pair(12, 8, 10)] if bidirectional else [])
    d = len(pairs)
    xs, w_hs, w_h, w_c = arrays(13, (3, 5, 8), (3, 5, 10 * d), (3, 10 * d), (3, 10 * d))
    mask = np.array([[1] * 5, [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)

    def j_loss(ws, x):
        m = jnp.asarray(mask) if masked else None
        hs, (h, c) = (j_lstm.bilstm_scan(*ws, x, m) if bidirectional
                      else j_lstm.lstm_scan(ws[0], x, m))
        return (hs * w_hs).sum() + (h * w_h).sum() + (c * w_c).sum()

    tws = [tw.requires_grad_(True) for _, tw in pairs]
    tx = T(xs).requires_grad_(True)
    with j_prec.precision(policy), t_prec.precision(policy):
        jg_w, jg_x = jax.grad(j_loss, argnums=(0, 1))([jw for jw, _ in pairs], jnp.asarray(xs))
        m = T(mask) if masked else None
        hs, (h, c) = (t_lstm.bilstm_scan(*tws, tx, m) if bidirectional
                      else t_lstm.lstm_scan(tws[0], tx, m))
        ((hs * T(w_hs)).sum() + (h * T(w_h)).sum() + (c * T(w_c)).sum()).backward()
    close(tx.grad, jg_x)
    for jg, tw in zip(jg_w, tws):
        for name in ("wih", "whh", "b"):
            close(getattr(tw, name).grad, getattr(jg, name))


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["lstm", "bilstm"])
def test_bilstm_loop_chunks_match_the_eager_scan(policy, masked, bidirectional):
    """The encoder's `BiLstmLoop` through the chunk runner of
    `infer/graphs.py` (what the card captures and replays, stepped
    eagerly) against the eager scan and the JAX package's, over 9 frames
    (3 chunks, the last one short): outputs and final state; masked
    frames emit zero."""
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.models.encoder import BiLstmLoop, EncoderParams
    from controllable_xgating_torch.utils import spans

    pairs = [lstm_pair(21, 8, 10)] + ([lstm_pair(22, 8, 10)] if bidirectional else [])
    params = EncoderParams(xgate_pair(23, 6, 4, 8)[1], pairs[0][1],
                           pairs[1][1] if bidirectional else None)
    (xs,) = arrays(24, (3, 9, 8))
    mask = np.array([[1] * 9, [1] * 6 + [0] * 3, [1, 1] + [0] * 7], np.float32)
    jm, tm = (jnp.asarray(mask), T(mask)) if masked else (None, None)
    with j_prec.precision(policy), t_prec.precision(policy), spans.collect() as col:
        want = (t_lstm.bilstm_scan(pairs[0][1], pairs[1][1], T(xs), tm) if bidirectional
                else t_lstm.lstm_scan(pairs[0][1], T(xs), tm))
        jwant = (j_lstm.bilstm_scan(pairs[0][0], pairs[1][0], xs, jm) if bidirectional
                 else j_lstm.lstm_scan(pairs[0][0], xs, jm))
        hs, (h, c) = graphs.run(BiLstmLoop(params, T(xs), tm), 9, False, graphs="chunks")
    counters = col.summary()["counters"]
    assert counters["graphs.replays.bilstm"] == counters["graphs.chunks_of.bilstm"] == 3
    assert hs.shape == (3, 9, 10 * len(pairs)) and hs.is_contiguous()
    for got, t_ref, j_ref in zip((hs, h, c), (want[0], *want[1]), (jwant[0], *jwant[1])):
        close(got, t_ref.numpy())
        close(got, j_ref)
    if masked:
        assert not hs[1, 6:].any() and not hs[2, 2:].any()


def test_precompute_keys():
    jw, tw = attn_pair(9, 12, 20, 14)
    (enc,) = arrays(10, (3, 5, 20))
    close(t_attn.precompute_keys(tw, T(enc)), j_attn.precompute_keys(jw, enc))


@pytest.mark.parametrize("masked", [False, True])
def test_additive_attention(masked):
    jw, tw = attn_pair(11, 12, 20, 14)
    q, enc = arrays(12, (3, 12), (3, 5, 20))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [1, 0, 0, 0, 0]], np.float32)
    jm, tm = (jnp.asarray(mask), T(mask)) if masked else (None, None)
    jctx, jal = j_attn.additive_attention(jw, q, enc, mask=jm)
    tctx, tal = t_attn.additive_attention(tw, T(q), T(enc), mask=tm)
    close(tctx, jctx)
    close(tal, jal)
    if masked:
        assert float(tal[1, 2:].abs().max()) < 1e-6


@pytest.mark.parametrize("mode", ["xgate", "concat"])
def test_xgate_fuse(mode):
    jw, tw = xgate_pair(13, 24, 16, 20, mode)
    xa, xm = arrays(14, (3, 5, 24), (3, 5, 16))
    close(t_xgate.xgate_fuse(tw, T(xa), T(xm)), j_xgate.xgate_fuse(jw, xa, xm))


# --- each kernel's plain version vs the JAX Pallas kernel (interpret mode) ---


@pytest.mark.parametrize("policy,tol", [("float32", TOL), ("bfloat16", dict(rtol=2e-2, atol=2e-2))])
def test_xgate_kernel_plain_matches_pallas(policy, tol):
    from controllable_xgating_tpu.ops.pallas.xgate import xgate_fuse_pallas
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel

    jw, tw = xgate_pair(15, 24, 16, 32)
    xa, xm = arrays(16, (3, 7, 24), (3, 7, 16))
    with j_prec.precision(policy), t_prec.precision(policy):
        ref = xgate_fuse_pallas(jw, jnp.asarray(xa), jnp.asarray(xm), interpret=True)
        out = xgate_fuse_kernel(tw, T(xa), T(xm))
    close(out, ref, **tol)


# f32: the chain sums Wf's two halves in one product over K = 2H, another
# order than the plain version's two (up to ~1e-6 at H = 136)
@pytest.mark.parametrize("policy,tol", [("float32", dict(rtol=1e-5, atol=1e-5)),
                                        ("bfloat16", dict(rtol=0.0, atol=2.0 ** -8))])
def test_xgate_chain_operands_rebuild_the_plain_fusion(policy, tol):
    """The bf16 chain of csrc/xgate.cu written out in torch on the K-major
    operands of `xgate_weights`, at a width the chain takes (rows 37, da
    40, dm 24, H 136): E = [ea | em], Eb = [em | ea] rounded, P = [ea * ga |
    em * gm] rounded, then one product over K = 2H. It equals the plain
    version (the bf16 bound: one ulp of the rounded tanh output) and the
    Pallas kernel in interpret mode (that test's bounds)."""
    from controllable_xgating_tpu.ops.pallas.xgate import xgate_fuse_pallas
    from controllable_xgating_torch.ops.kernels.xgate import (
        xgate_fits,
        xgate_fuse_plain,
        xgate_weights,
    )

    h = 136
    jw, tw = xgate_pair(30, 40, 24, h)
    xa, xm = arrays(31, (37, 40), (37, 24))
    assert xgate_fits(40, 24, h) and not xgate_fits(40, 24, 132) and not xgate_fits(42, 24, h)
    with j_prec.precision(policy), t_prec.precision(policy):
        cdt = t_prec.compute_dtype()
        ops = xgate_weights(tw)
        kmajor = lambda a, w_t: a.to(cdt).float() @ w_t.float().t()  # w_t [N, K]
        e = torch.cat([kmajor(T(xa), ops.wa_t) + ops.ba, kmajor(T(xm), ops.wm_t) + ops.bm], 1)
        eb = torch.cat([e[:, h:], e[:, :h]], 1).to(cdt)
        g = torch.sigmoid(torch.cat([kmajor(eb[:, :h], ops.uga_t) + ops.bga,
                                     kmajor(eb[:, h:], ops.ugm_t) + ops.bgm], 1))
        p = (e * g).to(cdt)
        out = torch.tanh(kmajor(p, ops.wf_t) + ops.bf).to(cdt).float()
        ref = xgate_fuse_plain(tw, T(xa), T(xm))
        pallas = xgate_fuse_pallas(jw, jnp.asarray(xa), jnp.asarray(xm), interpret=True)
    for got, src in zip(ops[:5], (tw.wa, tw.wm, tw.uga, tw.ugm, tw.wf)):
        assert got.dtype == cdt and got.is_contiguous() and torch.equal(got, src.to(cdt).t())
    for got, src in zip(ops[5:], (tw.ba, tw.bm, tw.bga, tw.bgm, tw.bf)):
        assert got.dtype == torch.float32 and torch.equal(got, src.to(cdt).float())
    close(out, ref.float().numpy(), **tol)
    close(out, np.asarray(pallas, np.float32),
          **(tol if policy == "float32" else dict(rtol=2e-2, atol=2e-2)))


@pytest.mark.parametrize("k,hd,policy,fits", [
    (1, 512, "bfloat16", True), (8, 512, "bfloat16", True), (9, 512, "float32", False),
    (16, 512, "bfloat16", False), (0, 512, "float32", False), (5, 1408, "bfloat16", True),
    (5, 1416, "bfloat16", False), (5, 4096, "float32", True), (5, 6, "bfloat16", True),
])
def test_lanes_fits_is_the_tail_kernels_shape_predicate(k, hd, policy, fits):
    """1 <= k <= MAX_K (csrc/topk_tail.cu instantiates 1..8), and under
    bf16 the chunk kernel's shared memory (h's row tile, 8 KB a 64-deep K
    step, and a 48 KB ring) within a block's 227 KB: Hd <= 1408."""
    from controllable_xgating_torch.ops.kernels.topk_tail import lanes_fits

    with t_prec.precision(policy):
        assert lanes_fits(k, hd) is fits


@pytest.mark.parametrize("hd", [6, 42])
def test_tail_operands_pad_hd_with_zero_columns(hd):
    """Under bf16 the top-K kernels' h and K-major w_out operands carry Hd
    padded with zero columns to a multiple of 8 (16-byte TMA rows), which
    changes no logit: the plain tail on the padded operands equals the
    unpadded one. Under f32 w_out is taken as it is."""
    from controllable_xgating_torch.ops.kernels.topk_tail import (
        h_operand,
        logits_topk_plain,
        padded_hd,
        topk_tail_weights,
    )

    h, w, b = map(T, arrays(40 + hd, (9, hd), (hd, 300), (300,)))
    hp = padded_hd(hd)
    with t_prec.precision("bfloat16"):
        w_op, h_op = topk_tail_weights(w), h_operand(h)
        got = logits_topk_plain(h_op, w_op.t(), b, 5)
        want = logits_topk_plain(h, w, b, 5)
    assert hp % 8 == 0 and hp - hd < 8
    assert w_op.shape == (300, hp) and h_op.shape == (9, hp) and w_op.is_contiguous()
    assert w_op.dtype == h_op.dtype == torch.bfloat16
    assert torch.equal(w_op[:, :hd], w.bfloat16().t()) and torch.equal(h_op[:, :hd], h.bfloat16())
    assert not w_op[:, hd:].any() and not h_op[:, hd:].any()
    assert torch.equal(got[1], want[1])
    for a, e in ((got[0], want[0]), (got[2], want[2])):
        close(a, e.numpy(), rtol=1e-6, atol=1e-6)
    with t_prec.precision("float32"):
        assert torch.equal(topk_tail_weights(w), w)


def _pos_and_decoder(seed):
    from controllable_xgating_tpu.models.captioner import init_captioner
    from controllable_xgating_tpu.utils.config import Config
    from controllable_xgating_torch import bridge
    from tools.import_torch_checkpoint import param_paths

    cfg = Config().replace_flat({
        "model.app_dim": 10, "model.motion_dim": 8, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
        "model.vocab_size": 40, "model.pos_vocab_size": 12,
    })
    jp = init_captioner(jax.random.PRNGKey(seed), cfg.model)
    tp = bridge.from_numpy({n: np.asarray(x) for n, x in param_paths(jp)}, cfg)
    return jp, tp


def test_pos_lstm_kernel_plain_matches_pallas():
    from controllable_xgating_tpu.models.pos_generator import _summary_gates
    from controllable_xgating_tpu.ops.pallas.pos_lstm import pos_lstm_step_pallas
    from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout

    jp, tp = _pos_and_decoder(17)
    summary, h, c = arrays(18, (5, 32), (5, 16), (5, 16))
    tok = np.array([3, 5, 7, 2, 9])
    e = np.asarray(jp.pos.embed)[tok]
    sg = _summary_gates(jp.pos, jnp.asarray(summary))
    jh, jc = pos_lstm_step_pallas(jp.pos, jnp.asarray(e), sg, jnp.asarray(h), jnp.asarray(c),
                                  interpret=True)
    th, tc = PosLstmRollout(tp.pos, T(h), T(np.asarray(sg))).step(T(c), torch.from_numpy(tok))
    close(th, jh)
    close(tc, jc)
    assert th.dtype == tc.dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
def test_attn_lstm_kernel_plain_matches_pallas(masked):
    from controllable_xgating_tpu.models.decoder import make_decode_context
    from controllable_xgating_tpu.ops.pallas.attn_lstm import attn_lstm_step_pallas
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_kernel

    jp, tp = _pos_and_decoder(19)
    enc, psi, h, c = arrays(20, (4, 6, 32), (4, 10), (4, 16), (4, 16))
    mask = np.array([[1] * 6, [1, 1, 1, 0, 0, 0], [1] * 6, [1, 0, 0, 0, 0, 0]], np.float32)
    ctx = make_decode_context(jp.decoder, jnp.asarray(enc), jnp.asarray(psi))
    e = np.asarray(jp.decoder.embed)[[4, 7, 9, 11]]
    m = mask if masked else None
    ref = attn_lstm_step_pallas(jp.decoder, jnp.asarray(e), jnp.asarray(h), jnp.asarray(c),
                                ctx.keys, ctx.enc_proj, ctx.psi_g,
                                None if m is None else jnp.asarray(m), interpret=True)
    out = attn_lstm_step_kernel(tp.decoder, T(e), T(h), T(c), T(np.asarray(ctx.keys)),
                                T(np.asarray(ctx.enc_proj)), T(np.asarray(ctx.psi_g)),
                                None if m is None else T(m))
    for o, r in zip(out, ref):
        close(o, r)


@pytest.mark.parametrize("r,hd,v,k,block_unk", [
    (6, 12, 40, 5, False),     # V below one 128-lane tile
    (16, 32, 300, 3, True),    # ragged V, block_unk
    (10, 8, 1000, 5, False),   # several vocab tiles, rows % 8 != 0
])
def test_topk_tail_plain_matches_pallas(r, hd, v, k, block_unk):
    from controllable_xgating_tpu.ops.pallas.topk_tail import logits_topk_lanes
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk

    h, w, b = arrays(21, (r, hd), (hd, v), (v,))
    jv, ji, jl = logits_topk_lanes(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k,
                                   block_unk=block_unk, interpret=True)
    tv, ti, tl = logits_topk(T(h), T(w), T(b), k, block_unk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tv, jv, rtol=1e-5, atol=1e-5)   # the Pallas golden's own bound for raw logits
    close(tl, jl, rtol=1e-5, atol=1e-5)


def test_topk_breaks_ties_by_lower_index():
    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]])
    vals, idx = topk(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


# --- dispatch and the CPU route of the kernel wrappers ---


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    from controllable_xgating_torch.ops.kernels import attn_lstm, pos_lstm, topk_tail, xent, xgate

    kernels.reset_launch_counts()
    jp, tp = _pos_and_decoder(22)
    xa, xm = arrays(23, (2, 3, 10), (2, 3, 8))
    assert torch.equal(xgate.xgate_fuse_kernel(tp.encoder.xgate, T(xa), T(xm)),
                       xgate.xgate_fuse_plain(tp.encoder.xgate, T(xa), T(xm)))
    e, sg, h, c = map(T, arrays(24, (2, 12), (2, 64), (2, 16), (2, 16)))
    tok = torch.tensor([4, 9])
    for a, b in zip(pos_lstm.PosLstmRollout(tp.pos, h, sg).step(c, tok),
                    pos_lstm.pos_lstm_step_plain(tp.pos, tp.pos.embed[tok], sg, h, c)):
        assert torch.equal(a, b)
    keys, encp, psi = map(T, arrays(25, (2, 3, 14), (2, 3, 16), (2, 16)))
    args = (tp.decoder, e, h, c, keys, encp, psi, None)
    for a, b in zip(attn_lstm.attn_lstm_step_kernel(*args), attn_lstm.attn_lstm_step_plain(*args)):
        assert torch.equal(a, b)
    w, bias = T(np.asarray(jp.decoder.w_out)), T(np.asarray(jp.decoder.b_out))
    for a, b in zip(topk_tail.logits_topk(h, w, bias, 3), topk_tail.logits_topk_plain(h, w, bias, 3)):
        assert torch.equal(a, b)
    (x,) = arrays(29, (6, 40))
    t = torch.tensor([0, 3, 39, 7, 1, 2])
    for a, b in zip(xent.xent_row_stats(T(x), t), xent.xent_row_stats_plain(T(x), t)):
        assert torch.equal(a, b)
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


def test_xgate_kernel_rejects_concat_mode():
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel

    _, tw = xgate_pair(26, 6, 4, 8, mode="concat")
    xa, xm = arrays(27, (2, 6), (2, 4))
    with pytest.raises(ValueError, match="xgate"):
        xgate_fuse_kernel(tw, T(xa), T(xm))


def test_dispatch_resolution():
    try:
        assert fused_enabled() is True  # auto: the wrappers route by device
        assert fused_enabled(False) is False
        set_fused_kernels(False)
        assert fused_enabled() is False and fused_enabled(True) is True
    finally:
        set_fused_kernels(None)


def test_kernel_sources_and_library_name():
    from controllable_xgating_torch.ops.kernels import build

    assert {os.path.basename(p) for p in build._sources()[0]} == {
        "attn_lstm.cu", "int8_vocab.cu", "pos_lstm.cu", "topk_extract.cu", "topk_tail.cu",
        "xent.cu", "xgate.cu"}
    name = os.path.basename(build.library_path())
    assert name.startswith("libcxg_kernels_") and name.endswith(".so")
    assert build.build_dir() == os.path.join(REPO, "build", "kernels")


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_kernel_weights_are_cast_once_to_the_policy(policy):
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights
    from controllable_xgating_torch.ops.kernels.pos_lstm import pos_lstm_weights

    _, tp = _pos_and_decoder(28)
    dec, pos = tp.decoder, tp.pos
    hd, e_dim, pe = dec.lstm.hidden_dim, dec.embed.shape[1], pos.embed.shape[1]
    with t_prec.precision(policy):
        cdt = t_prec.compute_dtype()
        aw, pw = attn_lstm_weights(dec), pos_lstm_weights(pos)
    want = {
        "wq": dec.attn.wq, "v": dec.attn.v, "wg_h": dec.w_gate[:hd], "wg_e": dec.w_gate[hd:],
        "wih_e": dec.lstm.wih[:e_dim], "wih_g": dec.lstm.wih[e_dim:], "whh": dec.lstm.whh,
    }
    for name, t in want.items():
        got = getattr(aw, name)
        assert got.dtype == cdt and got.is_contiguous() and torch.equal(got, t.to(cdt)), name
    for got, t in ((aw.battn, dec.attn.b), (aw.bg, dec.b_gate), (aw.bl, dec.lstm.b), (pw.b, pos.lstm.b)):
        assert got.dtype == torch.float32 and torch.equal(got, t)
    assert torch.equal(pw.wih_e, pos.lstm.wih[:pe].to(cdt)) and pw.wih_e.is_contiguous()
    assert torch.equal(pw.whh, pos.lstm.whh.to(cdt)) and pw.whh.dtype == cdt


def _decoder(hd, e, a, g, seed=0):
    from controllable_xgating_torch.models.decoder import init_decoder

    return init_decoder(torch.Generator().manual_seed(seed), 50, 2 * hd, hd, e, a, 24, guide_dim=g)


@pytest.mark.parametrize("hd", [16, 18])
def test_gate_perm_puts_a_units_gates_in_one_threads_columns(hd):
    """Thread q of a quad holds, in each 8-column group of a wgmma m64nN
    accumulator, columns 2q and 2q + 1 (hopper_gemm.cuh, acc_col). In
    gate_perm's order those columns of 16-column block j hold exactly the
    i, f, g, o gates of unit 4j + q; every gate column appears once."""
    from controllable_xgating_torch.ops.kernels.attn_lstm import gate_perm

    perm = gate_perm(hd)
    assert len(perm) == 4 * (-(-hd // 4) * 4)
    assert sorted(perm[perm >= 0].tolist()) == list(range(4 * hd))
    for q in range(4):
        cols = sorted({8 * (i >> 2) + 2 * q + (i & 1) for i in range(64)})  # a 128-column tile
        for j in range(len(perm) // 16):
            mine = [c for c in cols if c // 16 == j % 8]
            p = [16 * j + c % 16 for c in mine]
            assert p == [16 * j + 2 * q, 16 * j + 2 * q + 1, 16 * j + 8 + 2 * q, 16 * j + 9 + 2 * q]
            u = 4 * j + q
            want = [gate * hd + u for gate in range(4)] if u < hd else [-1] * 4
            assert perm[p].tolist() == want


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,e,a,g", [(16, 12, 14, 16), (18, 20, 36, 44)])
def test_packed_weights_hold_the_source_slices(policy, hd, e, a, g):
    """The bf16 kernel's packed operands, block by block: rows of W_pre^T
    are q's, then gate_pre's, then lstm_pre's gate columns (in gate_perm
    order) over K = [h | e], zero-padded to a multiple of 8; W_cell^T and
    the cell bias follow gate_perm too; padding units are zero."""
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights, gate_perm

    dec = _decoder(hd, e, a, g)
    with t_prec.precision(policy):
        cdt = t_prec.compute_dtype()
        w = attn_lstm_weights(dec)
    kx, perm = hd + e, gate_perm(hd)
    live = perm >= 0
    n_pre = a + g + len(perm)
    assert w.w_pre.shape == (n_pre, -(-kx // 8) * 8) and w.w_pre.dtype == cdt
    assert w.w_cell.shape == (len(perm), -(-g // 8) * 8) and w.w_cell.dtype == cdt
    assert w.b_cell.dtype == torch.float32 and w.w_pre.is_contiguous() and w.w_cell.is_contiguous()
    rnd = lambda t: t.to(cdt)
    wp = w.w_pre
    assert not wp[:, kx:].any() and not w.w_cell[:, g:].any()
    assert torch.equal(wp[:a, :hd], rnd(dec.attn.wq.T)) and not wp[:a, hd:].any()
    assert torch.equal(wp[a:a + g, :hd], rnd(dec.w_gate[:hd].T))
    assert torch.equal(wp[a:a + g, hd:kx], rnd(dec.w_gate[hd:].T))
    lstm = wp[a + g:]
    assert torch.equal(lstm[live, :hd], rnd(dec.lstm.whh[:, perm[live]].T))
    assert torch.equal(lstm[live, hd:kx], rnd(dec.lstm.wih[:e, perm[live]].T))
    assert not lstm[~live].any() and not w.w_cell[~live].any() and not w.b_cell[~live].any()
    assert torch.equal(w.w_cell[live, :g], rnd(dec.lstm.wih[e:, perm[live]].T))
    assert torch.equal(w.b_cell[live], dec.lstm.b[perm[live]])


@pytest.mark.parametrize("hd,e,a,g", [(16, 12, 14, 16), (18, 20, 36, 44)])
def test_packed_weights_rebuild_the_plain_step(hd, e, a, g):
    """In f32 on the CPU, [h | e] @ W_pre gives the q, gate_pre and lstm_pre
    that attn_lstm_step_plain forms, and the bf16 kernel's data flow on the
    packed operands (attention from that q and gate_pre, then guide @
    W_cell + lstm_pre + b_cell read in gate_perm order) gives its h', c'."""
    from controllable_xgating_torch.models.decoder import init_decoder_state, make_decode_context
    from controllable_xgating_torch.ops.kernels.attn_lstm import (
        attn_lstm_step_plain,
        attn_lstm_weights,
        gate_perm,
    )

    dec = _decoder(hd, e, a, g, seed=1)
    r, t = 5, 7
    rng = np.random.default_rng(30)
    mask = T((np.arange(t)[None] < np.array([[7], [3], [1], [7], [5]])).astype(np.float32))
    ctx = make_decode_context(dec, torch.tanh(T(rng.standard_normal((r, t, 2 * hd)))),
                              torch.tanh(T(rng.standard_normal((r, 24)))), mask)
    h, c = init_decoder_state(dec, torch.tanh(T(rng.standard_normal((r, 2 * hd)))))
    emb = T(rng.standard_normal((r, e))) * 0.5
    with t_prec.precision("float32"):
        w = attn_lstm_weights(dec)
        ref_h, ref_c, ref_alpha = attn_lstm_step_plain(dec, emb, h, c, ctx.keys, ctx.enc_proj,
                                                       ctx.psi_g, mask)
    perm = gate_perm(hd)
    pre = torch.cat([h, emb], 1) @ w.w_pre[:, :hd + e].T
    q, gate_pre, lstm_pre = pre[:, :a], pre[:, a:a + g], pre[:, a + g:]
    close(q, (h @ dec.attn.wq).numpy())
    close(gate_pre, (h @ dec.w_gate[:hd] + emb @ dec.w_gate[hd:]).numpy())
    full = emb @ dec.lstm.wih[:e] + h @ dec.lstm.whh
    live = perm >= 0
    close(lstm_pre[:, live], full[:, perm[live]].numpy())
    # the kernel's data flow on the packed operands
    score = (torch.tanh(q[:, None] + w.battn + ctx.keys) * w.v).sum(-1)
    alpha = torch.softmax(torch.where(mask > 0, score, torch.full_like(score, -1e9)), -1)
    gate = torch.sigmoid(gate_pre + w.bg)
    guide = gate * (alpha[..., None] * ctx.enc_proj).sum(1) + (1 - gate) * ctx.psi_g
    gates_p = guide @ w.w_cell[:, :g].T + lstm_pre + w.b_cell
    gates = torch.empty(r, 4 * hd)
    gates[:, perm[live]] = gates_p[:, live]
    i, f, gg, o = gates.split(hd, 1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    close(alpha, ref_alpha.numpy())
    close(c_new, ref_c.numpy())
    close(torch.sigmoid(o) * torch.tanh(c_new), ref_h.numpy())


def _planted_rows(shape, seed):
    """f32 rows with ties across the whole row, +-0.0, -inf and -1e30:
    half-integers on even rows, N(0, 1) draws on odd ones, a tie for the
    top planted far apart, and every fourth row a finished beam's (0 at
    PAD, -1e30 elsewhere)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x2 = x.reshape(-1, shape[-1])
    x2[::2] = rng.integers(-3, 4, x2[::2].shape) * 0.5
    x2[1::2, [3, shape[-1] - 2]] = x2[1::2].max(-1, keepdims=True) + 1.0
    x2[:, ::7] = -0.0
    x2[:, 1::11] = -1e30
    x2[:, 2::13] = -np.inf
    x2[3::4] = np.where(np.arange(shape[-1]) == 0, 0.0, -1e30)
    return torch.from_numpy(x2.reshape(shape))


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("shape", [(40,), (7, 40), (6, 3000), (9, 10000), (4, 5 * 10000),
                                   (5, 2561), (3, 5121)])
def test_topk_equals_the_stable_sort(shape, k):
    """The tails' top-K (int64 keys, a block prescreen past 4 k blocks of
    128) against `torch.sort(..., stable=True)`: indices and values equal,
    on rows of the grouped tail's, the flat tail's [B, K*V] and ragged
    widths (a last block of 1 column)."""
    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    x = _planted_rows(shape, seed=sum(shape) + k)
    vals, idx = topk(x, k)
    ref_v, ref_i = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(idx, ref_i[..., :k])
    assert torch.equal(vals, ref_v[..., :k])


@pytest.mark.parametrize("k", [1, 5, 8])
def test_topk_takes_the_lowest_ids_of_a_row_of_minus_inf(k):
    """A row whose top-K must include -inf entries: the lowest ids, and
    never a column of the prescreen's padding past the row's end."""
    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    x = torch.full((2, 5121), -float("inf"))
    x[:, [5120, 4000]] = 1.0
    vals, idx = topk(x, k)
    want = ([4000, 5120] + list(range(k)))[:k]
    assert idx.tolist() == [want] * 2
    assert torch.equal(vals, torch.sort(x, dim=-1, descending=True, stable=True)[0][:, :k])


@pytest.mark.parametrize("hd,e", [(16, 12), (48, 20), (72, 100), (64, 64)])
def test_pos_packed_operand_rebuilds_the_plain_step(hd, e):
    """In f32 on the CPU, the bf16 POS kernel's data flow on its operands:
    A = [e | h] tiles (e's K padded to a multiple of 64, as TMA's zero fill
    pads it), B = `pack_pos_weights` (gate_perm rows, zero K padding), plus
    `pack_pos_addend` (s_gates + b in gate_perm order), the LSTM tail on a
    thread's four gate columns, gives pos_lstm_step_plain's h', c'."""
    from controllable_xgating_torch.models.pos_generator import _summary_gates, init_pos_generator
    from controllable_xgating_torch.ops.kernels.attn_lstm import gate_perm
    from controllable_xgating_torch.ops.kernels.pos_lstm import (
        pack_pos_addend,
        pack_pos_weights,
        pos_lstm_step_plain,
    )

    pos = init_pos_generator(torch.Generator().manual_seed(2), 35, 2 * hd, hd, e, 24)
    r = 5
    emb, h, c, summ = map(T, arrays(31, (r, e), (r, hd), (r, hd), (r, 2 * hd)))
    h = torch.tanh(h)
    with t_prec.precision("float32"):
        sg = _summary_gates(pos, torch.tanh(summ))
        ref_h, ref_c = pos_lstm_step_plain(pos, emb, sg, h, c)
        w = pack_pos_weights(pos, torch.float32)
    e64, h64 = -(-e // 64) * 64, -(-hd // 64) * 64
    perm = gate_perm(hd)
    assert w.shape == (len(perm), e64 + h64)
    assert not w[:, e:e64].any() and not w[:, e64 + hd:].any() and not w[perm < 0].any()
    a = torch.cat([torch.nn.functional.pad(emb, (0, e64 - e)),
                   torch.nn.functional.pad(h, (0, h64 - hd))], 1)
    gates_p = a @ w.t() + pack_pos_addend(sg, pos.lstm.b)
    # thread q of 16-column block j: unit 4j + q's i, f, g, o at 2q, 2q + 1, 8 + 2q, 9 + 2q
    for j in range(len(perm) // 16):
        for q in range(4):
            u = 4 * j + q
            if u >= hd:
                assert not gates_p[:, 16 * j + 2 * q].any()
                continue
            i, f, g, o = (gates_p[:, 16 * j + col] for col in (2 * q, 2 * q + 1, 8 + 2 * q, 9 + 2 * q))
            c_new = torch.sigmoid(f) * c[:, u] + torch.sigmoid(i) * torch.tanh(g)
            close(c_new, ref_c[:, u].numpy())
            close(torch.sigmoid(o) * torch.tanh(c_new), ref_h[:, u].numpy())


def test_pos_rollout_on_the_cpu_is_the_plain_step():
    """`PosLstmRollout` on CPU tensors: four steps on gathered tags equal
    the plain step chained from the same state, and count no launch."""
    from controllable_xgating_torch.models.pos_generator import _summary_gates, init_pos_generator
    from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout, pos_lstm_step_plain

    pos = init_pos_generator(torch.Generator().manual_seed(3), 35, 32, 16, 12, 24)
    h, c, summ = map(T, arrays(32, (4, 16), (4, 16), (4, 32)))
    sg = _summary_gates(pos, summ)
    kernels.reset_launch_counts()
    cell = PosLstmRollout(pos, h, sg)
    rh, rc = h, c
    for tok in map(torch.tensor, ([3, 5, 7, 2], [1, 1, 9, 4], [6, 0, 2, 8], [11, 3, 3, 0])):
        h, c = cell.step(c, tok=tok)
        rh, rc = pos_lstm_step_plain(pos, pos.embed[tok], sg, rh, rc)
        assert torch.equal(h, rh) and torch.equal(c, rc)
    assert kernels.launch_counts()["pos_lstm"] == 0


GPU_TEST_FILES = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*_gpu.py")))


def test_the_gpu_test_files_are_found():
    """The glob below finds the `gpu` test files: with none, the
    parametrized check would be one skipped empty case."""
    assert len(GPU_TEST_FILES) >= 7, GPU_TEST_FILES


@pytest.mark.parametrize("path", GPU_TEST_FILES, ids=os.path.basename)
def test_gpu_test_file_imports_nothing_of_jax_or_the_jax_package(path):
    """The card has no jax: the `gpu` test files that run there import
    none of it, nor the JAX package or the repo's JAX-side tools."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert mods and not [m for m in mods if m.split(".")[0] in (
        "jax", "flax", "optax", "orbax", "h5py", "controllable_xgating_tpu", "experiments", "tools",
        "bench")]


def test_port_imports_no_jax_flax_orbax_h5py():
    """Every module imports without jax & co. or any module of the JAX
    package, and importing builds nothing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import controllable_xgating_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "banned = ('jax', 'flax', 'optax', 'orbax', 'h5py', 'controllable_xgating_tpu',\n"
        "          'experiments', 'tools', 'bench')\n"
        "bad = sorted({m for m in sys.modules if m.split('.')[0] in banned})\n"
        "assert len(mods) >= 30 and not bad, (len(mods), bad)\n"
        "from controllable_xgating_torch.ops.kernels import build\n"
        "assert build._LIB is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
