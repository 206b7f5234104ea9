"""`controllable_xgating_torch/utils/debug.py` on the CPU: the NaN checks
(`--debug_nans`) and `kernel_plain_diff`, the counterpart of the JAX
package's `jit_eager_diff`.

A NaN made inside a model function raises `FloatingPointError` naming
the operator and the port's module; one that enters a hand-kernel
wrapper (K1-K7; K5's backward wrapper runs only on the card) names the
kernel; turning the checks off restores the anomaly mode and the
decode-graph setting, and the decode loops never capture a graph while
they are on. The CLI runs (clean losses equal with and without the
flag; on a planted NaN the port's refusal beside the JAX CLI's NaN
loss) are in `tests/test_torch_cli.py`.
"""

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.utils import debug as j_debug
from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
from controllable_xgating_torch.infer import graphs
from controllable_xgating_torch.infer.beam import make_beam_caption_fn
from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
from controllable_xgating_torch.models.captioner import init_captioner
from controllable_xgating_torch.models.decoder import init_decoder_state, make_decode_context
from controllable_xgating_torch.models.encoder import encode
from controllable_xgating_torch.models.pos_generator import _summary_gates
from controllable_xgating_torch.ops import dispatch
from controllable_xgating_torch.ops.kernels import (
    attn_lstm,
    int8_vocab,
    pos_lstm,
    topk_extract,
    topk_tail,
    xent,
    xgate,
)
from controllable_xgating_torch.utils.config import ModelConfig
from controllable_xgating_torch.utils.debug import enable_nan_checks, kernel_plain_diff, nan_checks

torch.set_num_threads(1)
CFG = ModelConfig(app_dim=18, motion_dim=10, hidden_dim=20, embed_dim=12, attn_dim=12,
                  pos_embed_dim=12, num_frames=5, vocab_size=40, pos_vocab_size=14,
                  max_caption_len=9, max_pos_len=9, dropout=0.0)
B, T = 3, 5


@pytest.fixture(scope="module")
def params():
    return init_captioner(CFG, seed=0, device="cpu").requires_grad_(False)


def features(seed: int = 0):
    rng = np.random.default_rng(seed)
    app = torch.from_numpy(rng.standard_normal((B, T, CFG.app_dim), dtype=np.float32))
    mot = torch.from_numpy(rng.standard_normal((B, T, CFG.motion_dim), dtype=np.float32))
    mask = torch.ones(B, T)
    mask[1, 3:] = 0
    return app, mot, mask


def with_nan(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[1] = float("nan")
    return x


def kernel_calls(p):
    """{label: call} of every kernel wrapper on seeded inputs, made here
    (before any check is on), with one NaN planted in its first input."""
    g = torch.Generator().manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g)
    enc, pos, dec = p.encoder, p.pos, p.decoder
    he, hp, hd, r = enc.out_dim, pos.lstm.hidden_dim, dec.hidden_dim, B * 2
    ctx = make_decode_context(dec, torch.tanh(rn(r, T, he)), torch.tanh(rn(r, dec.w_psi.shape[0])),
                              torch.ones(r, T))
    h, c = init_decoder_state(dec, torch.tanh(rn(r, he)))
    sg = _summary_gates(pos, torch.tanh(rn(B, he)))
    q = quantize_vocab_proj(dec.w_out, dec.b_out)
    xa, xm = with_nan(rn(B * T, CFG.app_dim)), rn(B * T, CFG.motion_dim)
    h_pos, c_pos, tok = with_nan(torch.tanh(rn(B, hp))), rn(B, hp), torch.tensor([4, 5, 6])
    e_dec, h_nan = dec.embed[torch.arange(4, 4 + r)], with_nan(h)
    h_out = with_nan(rn(r, hd))
    logits = with_nan(rn(r, CFG.vocab_size))
    return {
        "K1 xgate": lambda: xgate.xgate_fuse_kernel(enc.xgate, xa, xm),
        "K2 pos_lstm": lambda: pos_lstm.PosLstmRollout(pos, h_pos, sg).step(c_pos, tok=tok),
        "K3 attn_lstm": lambda: attn_lstm.attn_lstm_step_kernel(
            dec, e_dec, h_nan, c, ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask),
        "K4 topk_tail": lambda: topk_tail.logits_topk(h_out, dec.w_out, dec.b_out, 3),
        "K5 xent_fwd": lambda: xent.xent_row_stats(logits, torch.arange(r)),
        "K6 topk_extract": lambda: topk_extract.logits_topk_extract_kernel(
            h_out, dec.w_out, dec.b_out, 3),
        "K7 int8_vocab": lambda: int8_vocab.int8_vocab_proj(h_out, q.wq, q.scale, q.bias, q.n),
    }


@pytest.mark.parametrize("label", ["K1 xgate", "K2 pos_lstm", "K3 attn_lstm", "K4 topk_tail",
                                   "K5 xent_fwd", "K6 topk_extract", "K7 int8_vocab"])
def test_nan_in_a_kernel_wrapper_names_the_kernel(params, label):
    call = kernel_calls(params)[label]
    call()  # without the checks the NaN passes silently, as in the reference
    with nan_checks(), pytest.raises(FloatingPointError, match=f"kernel {label}"):
        call()
    assert not dispatch.nan_checks_enabled()


def test_nan_in_the_features_names_the_encoder(params):
    app, mot, mask = features()
    app = with_nan(app)
    out, _ = encode(params.encoder, app, mot, mask)
    assert torch.isnan(out).any()  # the plain run carries it on
    with nan_checks(), pytest.raises(FloatingPointError) as e:
        encode(params.encoder, app, mot, mask)
    assert "models/encoder.py" in str(e.value) and "operator aten." in str(e.value)


def test_nan_made_by_an_operator_in_a_caption_call_is_refused(params):
    """A whole greedy call: a NaN in one video's features stops it."""
    app, mot, mask = features(1)
    fn = make_greedy_caption_fn(CFG.max_pos_len, CFG.max_caption_len)
    app = with_nan(app)
    with nan_checks(), pytest.raises(FloatingPointError, match="controllable_xgating_torch/"):
        fn(params, app, mot, mask)


@pytest.mark.parametrize("graphs_before", [None, True, False])
def test_checks_off_restore_anomaly_mode_and_the_graph_setting(graphs_before):
    dispatch.set_decode_graphs(graphs_before)
    anomaly = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        assert dispatch.decode_graphs_setting() is False and dispatch.nan_checks_enabled()
        # no capture, even where a caller forces the graphs on the card
        assert graphs.resolve_mode(True, torch.device("cuda"), False) == "eager"
        assert graphs.resolve_mode(None, torch.device("cuda"), False) == "eager"
        enable_nan_checks(True)  # a second call changes nothing
        enable_nan_checks(False)
        assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == anomaly
        assert dispatch.decode_graphs_setting() is graphs_before
        assert not dispatch.nan_checks_enabled()
        assert graphs.resolve_mode(None, torch.device("cuda"), False) == (
            "eager" if graphs_before is False else "graphs")
        torch.log(torch.tensor([-1.0]))  # off: no check
    finally:
        enable_nan_checks(False)
        dispatch.set_decode_graphs(None)


def test_backward_nan_is_refused():
    """A NaN made in the backward (sqrt at 0 times 0 gives 0 * inf)."""
    x = torch.zeros(3, requires_grad=True)
    with nan_checks(), pytest.raises((FloatingPointError, RuntimeError), match="nan|NaN"):
        (torch.sqrt(x) * 0).sum().backward()


def test_checks_only_read_clean_values(params):
    """The same greedy and beam tokens and scores with the checks on."""
    app, mot, mask = features(2)
    greedy = make_greedy_caption_fn(CFG.max_pos_len, CFG.max_caption_len)
    beam = make_beam_caption_fn(3, CFG.max_pos_len, CFG.max_caption_len)
    want = greedy(params, app, mot, mask), beam(params, app, mot, mask)
    with nan_checks():
        got = greedy(params, app, mot, mask), beam(params, app, mot, mask)
    flat = lambda tree: torch.utils._pytree.tree_flatten(tree)[0]
    for a, b in zip(flat(want), flat(got)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam3"])
def test_kernel_plain_diff_is_zero_on_the_cpu(params, beam):
    """On the CPU the kernel path is the wrappers' plain versions: the fast
    and plain paths give the same tokens, and their scores agree within
    the f32 bound. Both switches come back as they were."""
    app, mot, mask = features(3)

    def call(p, a, m, fm):
        make = (lambda: make_beam_caption_fn(3, CFG.max_pos_len, CFG.max_caption_len)) if beam \
            else (lambda: make_greedy_caption_fn(CFG.max_pos_len, CFG.max_caption_len))
        return make()(p, a, m, fm)

    dispatch.set_fused_kernels(None)
    diffs = kernel_plain_diff(call, params, app, mot, mask)
    assert diffs and all(v <= 1e-5 for v in diffs.values())
    assert dispatch.fused_setting() is None and dispatch.decode_graphs_setting() is None


def test_kernel_plain_diff_raises_on_a_divergence_and_restores():
    dispatch.set_fused_kernels(True)
    dispatch.set_decode_graphs(None)
    try:
        fn = lambda x: (x * (1.0 if dispatch.fused_enabled() else 1.01), (x > 0).int())
        with pytest.raises(AssertionError):
            kernel_plain_diff(fn, torch.linspace(-1, 1, 16))
        assert dispatch.fused_setting() is True and dispatch.decode_graphs_setting() is None
        ints = lambda x: (x, torch.tensor([1 if dispatch.fused_enabled() else 2]))
        with pytest.raises(AssertionError):
            kernel_plain_diff(ints, torch.ones(2))
    finally:
        dispatch.set_fused_kernels(None)


def test_kernel_plain_diff_returns_what_jit_eager_diff_returns():
    """On a function with no kernel the two probes agree: one entry per
    output leaf, 0 for the exact ones."""
    import jax.numpy as jnp

    xs = np.linspace(-1, 1, 16, dtype=np.float32)
    got = kernel_plain_diff(lambda x: (torch.tanh(x) * 2.0, (x > 0).int()), torch.from_numpy(xs))
    want = j_debug.jit_eager_diff(lambda x: (jnp.tanh(x) * 2.0, (x > 0).astype(jnp.int32)),
                                  jnp.asarray(xs))
    assert got.keys() == want.keys() and got[1] == want[1] == 0.0
    assert got[0] == 0.0 and want[0] < 1e-5
