"""PyTorch port vs the JAX package, op by op, on the CPU in f32.

Every input and weight is drawn from a numpy seed and handed to both
packages. Tolerances are the JAX package's own for its kernels
(tests/test_pallas.py: rtol 1e-5, atol 1e-6 in f32). Each kernel's plain
PyTorch version is held against the JAX Pallas function run in interpret
mode, as tests/test_pallas.py runs it.
"""

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
    from controllable_xgating_torch.ops.kernels.pos_lstm import pos_lstm_step_kernel

    jp, tp = _pos_and_decoder(17)
    summary, h, c = arrays(18, (5, 32), (5, 16), (5, 16))
    tok = np.array([3, 5, 7, 2, 9])
    e = np.asarray(jp.pos.embed)[tok]
    sg = _summary_gates(jp.pos, jnp.asarray(summary))
    jh, jc = pos_lstm_step_pallas(jp.pos, jnp.asarray(e), sg, jnp.asarray(h), jnp.asarray(c),
                                  interpret=True)
    th, tc = pos_lstm_step_kernel(tp.pos, T(e), T(np.asarray(sg)), T(h), T(c))
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
    for a, b in zip(pos_lstm.pos_lstm_step_kernel(tp.pos, e, sg, h, c),
                    pos_lstm.pos_lstm_step_plain(tp.pos, e, sg, h, c)):
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
        "attn_lstm.cu", "pos_lstm.cu", "topk_tail.cu", "xent.cu", "xgate.cu"}
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


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert mods and not [m for m in mods if m.split(".")[0] in (
        "jax", "flax", "optax", "orbax", "h5py", "controllable_xgating_tpu")]


def test_port_imports_no_jax_flax_orbax_h5py():
    """Every module imports without jax & co. or any module of the JAX
    package, and importing builds nothing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import controllable_xgating_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "banned = ('jax', 'flax', 'optax', 'orbax', 'h5py', 'controllable_xgating_tpu')\n"
        "bad = sorted({m for m in sys.modules if m.split('.')[0] in banned})\n"
        "assert len(mods) >= 30 and not bad, (len(mods), bad)\n"
        "from controllable_xgating_torch.ops.kernels import build\n"
        "assert build._LIB is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
