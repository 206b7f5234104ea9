"""The port's quantized decode path vs the JAX package, on the CPU, in f32.

The weight-only int8 vocab projection (`experiments/int8_vocab_matmul.py`
in both packages), the `vocab_q` hook of `decode_step`, greedy and beam-5
with it (every beam tail that takes it), and the port's `quant_ab` tool.
Weights and inputs are numpy draws handed to both packages; the weight
tree goes through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data.vocab import EOS
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.models import decoder as j_dec
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch import bridge
from controllable_xgating_torch.experiments import int8_vocab_matmul as t_q
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import greedy as t_greedy
from controllable_xgating_torch.models import captioner as t_cap
from controllable_xgating_torch.models import decoder as t_dec
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.dispatch import set_fused_kernels
from controllable_xgating_torch.ops.precision import compute_dtype, precision
from experiments import int8_vocab_matmul as j_q
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN, MAX_POS = 9, 8


def rand_proj(k=64, n=1300, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) * 0.01
    return w, b


def both_quantized(w, b):
    return j_q.quantize_vocab_proj(jnp.asarray(w), jnp.asarray(b)), t_q.quantize_vocab_proj(T(w), T(b))


def test_quantize_matches_jax_bit_for_bit():
    """wq, scale, bias and n equal the JAX function's, padding included,
    with a zero column and values exactly half a step from two integers
    (round half to even: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2)."""
    w, b = rand_proj()
    w[:, 7] = 0.0
    w[:4, 11] = [127.0, 2.5, 3.5, -2.5]  # amax 127: scale exactly 1
    w[4:, 11] = 0.25
    w[:3, 12] = [254.0, 5.0, -7.0]        # scale exactly 2: 2.5 -> 2, -3.5 -> -4
    w[3:, 12] = 0.5
    jq, tq = both_quantized(w, b)
    assert tq.n == jq.n == 1300
    assert tq.wq.dtype == torch.int8 and tq.wq.shape == (64, 2048)
    for name in ("wq", "scale", "bias"):
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tq.wq[1:4, 11].tolist() == [2, 4, -2] and tq.wq[1:3, 12].tolist() == [2, -4]
    assert tq.scale[0, 7] == 1.0 and not tq.wq[:, 7].any()
    assert (tq.scale[0, 1300:] == 1.0).all() and not tq.bias[0, 1300:].any()


def test_quantize_error_bound():
    """The JAX package's own bound (tests/test_int8_matmul.py) on the port."""
    w, b = rand_proj()
    q = t_q.quantize_vocab_proj(T(w), T(b))
    assert q.wq.shape[1] % 1024 == 0 and q.wq.shape[1] >= q.n
    scale = q.scale[0, : q.n].numpy()
    err = np.abs(q.wq[:, : q.n].numpy().astype(np.float32) * scale - w)
    assert (err <= scale[None, :] / 2 + 1e-7).all()


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_vocab_proj_int8_matches_jax(policy):
    """The port's plain version and the wrapper equal the JAX jnp path and
    the Pallas kernel in interpret mode, under either compute policy: x is
    cast to bf16 whatever the policy."""
    w, b = rand_proj()
    jq, tq = both_quantized(w, b)
    x = np.random.default_rng(1).normal(size=(24, 64)).astype(np.float32)
    ref = np.asarray(j_q._dequant_matmul_jnp(jnp.asarray(x), jq))
    ker = np.asarray(j_q._int8_matmul_pallas(jnp.asarray(x), jq, interpret=True))
    with precision(policy):
        plain = t_q._dequant_matmul_plain(T(x), tq)
        kernels.reset_launch_counts()
        outs = [t_q.vocab_proj_int8(T(x), tq, fused=f) for f in (True, False)]
    assert kernels.launch_counts()["int8_vocab"] == 0  # CPU tensors: the plain version
    assert plain.shape == (24, 2048)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    np.testing.assert_allclose(plain.numpy(), ker, **TOL)
    for out in outs:
        assert out.shape == (24, 1300) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref[:, :1300], **TOL)


@pytest.mark.parametrize("k,n", [(64, 1300), (96, 1300), (512, 2048), (20, 40)])
def test_kernel_operand_reproduces_the_plain_version_exactly(k, n):
    """The int8 kernel's K-major operand (`int8_vocab_weights`), read as the
    kernel reads it (thread q of a row takes bytes 16q .. 16q + 15 of each
    64-byte K block; byte 4kk + 2h + b is chunk kk's k = 16kk + 8h + 2q +
    b), rebuilds wq exactly, zero past K: on integer inputs, whose sums are
    exact in any order, the logits equal `int8_vocab_plain`'s bit for bit.
    `with_kernel_operand` attaches it once and leaves wq, scale, bias and n
    as the JAX function made them."""
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_plain, int8_vocab_weights

    w, b = rand_proj(k, n, seed=k + n)
    q = t_q.quantize_vocab_proj(T(w), T(b))
    wt = int8_vocab_weights(q.wq)
    vpad, kp = wt.shape
    assert wt.dtype == torch.int8 and vpad == q.wq.shape[1] and kp == -(-k // 64) * 64
    seen = torch.zeros(vpad, kp, dtype=torch.int8)
    for blk in range(kp // 64):
        for qq in range(4):
            for kk in range(4):
                for h in range(2):
                    for bb in range(2):
                        seen[:, 64 * blk + 16 * kk + 8 * h + 2 * qq + bb] = \
                            wt[:, 64 * blk + 16 * qq + 4 * kk + 2 * h + bb]
    assert torch.equal(seen[:, :k].t(), q.wq) and not seen[:, k:].any()
    x = torch.from_numpy(np.random.default_rng(5).integers(-4, 5, (7, k)).astype(np.float32))
    out = (x @ seen[:, :k].float().t()) * q.scale + q.bias
    assert torch.equal(out, int8_vocab_plain(x, q.wq, q.scale, q.bias))
    qk = t_q.with_kernel_operand(q)
    assert torch.equal(qk.wq_t, wt) and qk[:4] == q[:4] and t_q.with_kernel_operand(qk) is qk


@pytest.mark.parametrize("k", [6, 42, 64, 100])
def test_kernel_x_operand_pads_k_with_zero_columns(k):
    """The int8 kernel's x operand (`x_operand`) is x in bf16 with zero
    columns up to a multiple of 8 (16-byte TMA rows); against the K-major
    weight, zero past K, the padded product equals the plain one exactly
    (integer inputs: exact sums in any order). No copy of columns at a
    multiple of 8."""
    from controllable_xgating_torch.ops.kernels.int8_vocab import (
        int8_vocab_plain,
        int8_vocab_weights,
        x_operand,
    )

    w, b = rand_proj(k, 300, seed=k)
    q = t_q.quantize_vocab_proj(T(w), T(b))
    x = torch.from_numpy(np.random.default_rng(k).integers(-4, 5, (9, k)).astype(np.float32))
    xb = x_operand(x)
    kx = -(-k // 8) * 8
    assert xb.shape == (9, kx) and xb.dtype == torch.bfloat16 and xb.is_contiguous()
    assert torch.equal(xb[:, :k], x.bfloat16()) and not xb[:, k:].any()
    wt = int8_vocab_weights(q.wq)  # rows: vocab; columns: K in fragment order, zero past K
    p = torch.arange(wt.shape[1])
    kk = (p // 64) * 64 + 16 * ((p % 64 % 16) // 4) + 8 * ((p % 4) // 2) + 2 * ((p % 64) // 16) + p % 2
    w_k = torch.zeros_like(wt).index_copy_(1, kk, wt)[:, :kx].float()  # back to K order
    out = (xb.float() @ w_k.t()) * q.scale + q.bias
    assert torch.equal(out, int8_vocab_plain(x, q.wq, q.scale, q.bias))


def make_cfg(vocab=40):
    """A narrow config (also used by tests/test_torch_beam_tails.py)."""
    return Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 20,
        "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
        "model.vocab_size": vocab, "model.pos_vocab_size": 12, "model.num_frames": 5,
    })


def numpy_params(cfg, seed, eos_bias=1.0):
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
    tree["decoder.b_out"][EOS] += eos_bias
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), [jnp.asarray(tree[n]) for n in names])
    return jp, bridge.from_numpy(tree, cfg)


@pytest.fixture(scope="module", params=[40, 3000], ids=["vocab40", "vocab3000"])
def model(request):
    """Both packages' weights, decode contexts and quantized projections;
    vocab 3000 engages the block tail's prescreen (V > 4 * 5 * 128)."""
    cfg = make_cfg(request.param)
    jp, tp = numpy_params(cfg, 21)
    rng = np.random.default_rng(22)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    jctx, jsum, _ = j_cap.encode_for_inference(
        jp, jnp.asarray(app), jnp.asarray(mot), jnp.asarray(mask), max_pos_len=MAX_POS)
    tctx, tsum, _ = t_cap.encode_for_inference(tp, T(app), T(mot), T(mask), max_pos_len=MAX_POS)
    jq = j_q.quantize_vocab_proj(jp.decoder.w_out, jp.decoder.b_out)
    tq = t_q.quantize_vocab_proj(tp.decoder.w_out, tp.decoder.b_out)
    return jp, tp, (jctx, jsum, jq), (tctx, tsum, tq)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_vocab_q_matches_jax(model, fused):
    jp, tp, (jctx, jsum, jq), (tctx, tsum, tq) = model
    jh, jc = j_dec.init_decoder_state(jp.decoder, jsum)
    th, tc = t_dec.init_decoder_state(tp.decoder, tsum)
    tok = np.array([4, 9, 1])
    jout = j_dec.decode_step(jp.decoder, jctx, jnp.asarray(tok), jh, jc, vocab_q=jq)
    tout = t_dec.decode_step(tp.decoder, tctx, T(tok), th, tc, fused=fused, vocab_q=tq)
    assert tout[0].shape == (3, tp.decoder.vocab_size)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # return_hidden wins over vocab_q
    hid = t_dec.decode_step(tp.decoder, tctx, T(tok), th, tc, fused=fused, vocab_q=tq,
                            return_hidden=True)
    assert torch.equal(hid[0], hid[1])


@pytest.mark.parametrize("early_stop", [False, True])
def test_greedy_vocab_q_matches_jax(model, early_stop):
    jp, tp, (jctx, jsum, jq), (tctx, tsum, tq) = model
    jt = j_greedy.greedy_decode(jp.decoder, jctx, jsum, MAX_LEN, early_stop=early_stop, vocab_q=jq)
    tt = t_greedy.greedy_decode(tp.decoder, tctx, tsum, MAX_LEN, fused=True, early_stop=early_stop,
                                vocab_q=tq)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("mode", ["auto", "grouped", "flat", "block"])
def test_beam_vocab_q_matches_jax(model, mode):
    jp, tp, (jctx, jsum, jq), (tctx, tsum, tq) = model
    jt, js = j_beam.beam_search(jp.decoder, jctx, jsum, 5, MAX_LEN, topk_mode=mode, vocab_q=jq)
    kernels.reset_launch_counts()
    tt, ts = t_beam.beam_search(tp.decoder, tctx, tsum, 5, MAX_LEN, fused=True, topk_mode=mode,
                                vocab_q=tq)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    # auto takes grouped with vocab_q: the lanes wrapper is never called
    assert kernels.launch_counts()["topk_tail"] == 0


def test_beam_lanes_rejects_vocab_q(model):
    _, tp, _, (tctx, tsum, tq) = model
    with pytest.raises(ValueError, match="vocab_q"):
        t_beam.beam_search(tp.decoder, tctx, tsum, 5, 3, fused=True, topk_mode="lanes",
                           vocab_q=tq)


def test_quantized_path_plain_equals_kernel_path_on_cpu(model):
    """set_fused_kernels(False) takes the plain int8 version: on the CPU the
    wrappers run the same arithmetic, so the captions are equal."""
    _, tp, _, (tctx, tsum, tq) = model
    run = lambda fused: t_beam.beam_search(tp.decoder, tctx, tsum, 5, MAX_LEN, fused=fused,
                                           vocab_q=tq)
    try:
        set_fused_kernels(False)
        plain = run(False)
    finally:
        set_fused_kernels(None)
    for a, b in zip(run(True), plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_quant_ab_tool_runs_on_cpu(capsys, beam):
    from controllable_xgating_torch.tools import quant_ab

    quant_ab.main(["--device", "cpu", "--hidden", "16", "--batches", "2"]
                  + (["--beam"] if beam else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# beam-5" if beam else "# greedy") and "on cpu" in lines[0]
    batch, bf16, int8, delta = lines[-1].split()
    assert batch == "2" and bf16.endswith("/s") and int8.endswith("/s") and delta.endswith("%")


QUANT_AB_CPU = ["--device", "cpu", "--hidden", "16", "--batches", "2"]


def test_quant_ab_tool_restores_the_compute_policy(capsys):
    """The tool runs under bf16 but the policy is process-global: after it
    returns, the caller's f32 policy holds again."""
    from controllable_xgating_torch.tools import quant_ab

    with precision("float32"):
        quant_ab.main(QUANT_AB_CPU)
        assert compute_dtype() is torch.float32
    capsys.readouterr()


def test_slice_matches_jax_after_the_quant_ab_tool(capsys):
    """The captioning slice's beam-5 check (tests/test_torch_slice.py's
    weights and inputs) run after the tool in one process, as a test
    worker runs one file after another: the tokens equal the JAX package's."""
    from controllable_xgating_torch.tools import quant_ab

    cfg = make_cfg(40)
    jp, tp = numpy_params(cfg, 11, eos_bias=0.0)
    rng = np.random.default_rng(12)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    with precision("float32"):
        quant_ab.main(QUANT_AB_CPU + ["--beam"])
        jt = j_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN)(jp, app, mot, mask)[0]
        tt = t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN)(tp, T(app), T(mot), T(mask))[0]
    capsys.readouterr()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_quant_ab_tool_refuses_cuda_without_a_card(monkeypatch):
    from controllable_xgating_torch.tools import quant_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        quant_ab.main(["--batches", "2"])
