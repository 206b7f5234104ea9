"""PyTorch port vs the JAX package, model by model, on the CPU in f32.

Weights are drawn from a numpy seed in the JAX parameter tree's shapes and
reach both packages through the weight bridge; inputs come from the same
seed. Tolerance rtol 1e-5, atol 1e-6 (the JAX package's own kernel bound);
tokens and tags must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data.vocab import EOS
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.models import decoder as j_dec
from controllable_xgating_tpu.models import encoder as j_enc
from controllable_xgating_tpu.models import pos_generator as j_pos
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch import bridge
from controllable_xgating_torch.models import captioner as t_cap
from controllable_xgating_torch.models import decoder as t_dec
from controllable_xgating_torch.models import encoder as t_enc
from controllable_xgating_torch.models import pos_generator as t_pos
from controllable_xgating_torch.ops import kernels
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def make_cfg(**over):
    flat = {
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
        "model.vocab_size": 40, "model.pos_vocab_size": 12, "model.num_frames": 5,
    }
    flat.update({f"model.{k}": v for k, v in over.items()})
    return Config().replace_flat(flat)


def numpy_params(cfg, seed):
    """(JAX CaptionerParams, port CaptionerParams) holding the same numpy
    draws. EOS gets a raised bias so rollouts finish at different steps."""
    shapes = jax.eval_shape(lambda: j_cap.init_captioner(jax.random.PRNGKey(0), cfg.model))
    rng = np.random.default_rng(seed)
    tree = {}
    for name, leaf in param_paths(shapes):
        if leaf.ndim == 2 and not name.endswith("embed"):
            s = 1.5 / np.sqrt(leaf.shape[0])
            tree[name] = rng.uniform(-s, s, leaf.shape).astype(np.float32)
        else:
            tree[name] = (rng.standard_normal(leaf.shape) * 0.3).astype(np.float32)
    tree["decoder.b_out"][EOS] += 1.5
    tree["pos.b_out"][EOS] += 1.0
    treedef = jax.tree_util.tree_structure(shapes)
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(tree[n]) for n in names])
    return jp, bridge.from_numpy(tree, cfg)


def inputs(cfg, b=3, seed=1):
    rng = np.random.default_rng(seed)
    m = cfg.model
    app = rng.standard_normal((b, m.num_frames, m.app_dim)).astype(np.float32)
    mot = rng.standard_normal((b, m.num_frames, m.motion_dim)).astype(np.float32)
    mask = np.ones((b, m.num_frames), np.float32)
    mask[1, 3:] = 0
    mask[-1, 2:] = 0
    return app, mot, mask


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


T = torch.from_numpy


@pytest.fixture(scope="module")
def model():
    cfg = make_cfg()
    jp, tp = numpy_params(cfg, 0)
    return cfg, jp, tp


@pytest.mark.parametrize("over", [
    {}, {"fusion": "concat"}, {"pos_guidance": False}, {"encoder_bidirectional": False},
], ids=["xgate", "concat", "no_psi", "unidirectional"])
def test_bridge_round_trip_is_bit_identical(over):
    cfg = make_cfg(**over)
    jp = j_cap.init_captioner(jax.random.PRNGKey(3), cfg.model)
    tree = {n: np.asarray(x) for n, x in param_paths(jp)}
    tp = bridge.from_numpy(tree, cfg)
    back = bridge.to_numpy(tp)
    assert sorted(back) == sorted(tree)
    for name in tree:
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], tree[name], err_msg=name)
    assert tp.encoder.xgate.mode == cfg.model.fusion
    assert tp.decoder.use_psi == cfg.model.pos_guidance
    assert (tp.encoder.lstm_bwd is None) == (not cfg.model.encoder_bidirectional)


def test_bridge_rejects_unknown_and_missing_keys(model):
    cfg, jp, _ = model
    tree = {n: np.asarray(x) for n, x in param_paths(jp)}
    with pytest.raises(KeyError, match="does not know"):
        bridge.from_numpy({**tree, "decoder.vocab_q": np.zeros(1)}, cfg)
    del tree["pos.w_psi"]
    with pytest.raises(KeyError, match="pos.w_psi"):
        bridge.from_numpy(tree, cfg)


@pytest.mark.parametrize("fusion", ["xgate", "concat"])
def test_init_captioner_matches_jax_shapes_and_ranges(fusion):
    cfg = make_cfg(fusion=fusion)
    tp = t_cap.init_captioner(cfg, seed=5, device="cpu")
    jshapes = {n: tuple(x.shape) for n, x in param_paths(
        jax.eval_shape(lambda: j_cap.init_captioner(jax.random.PRNGKey(0), cfg.model)))}
    assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == jshapes
    h = cfg.model.hidden_dim
    for name, p in tp.named_parameters():
        assert p.dtype == torch.float32 and not p.requires_grad
        if name.endswith("lstm.b") or name.endswith("_fwd.b") or name.endswith("_bwd.b"):
            assert torch.equal(p[h:2 * h], torch.ones(h)), name  # forget-gate bias
        elif p.ndim == 2 and not name.endswith("embed"):
            assert float(p.abs().max()) <= 1.0 / np.sqrt(p.shape[0]) + 1e-7, name
    again = t_cap.init_captioner(cfg, seed=5, device="cpu")  # same seed, same weights
    assert all(torch.equal(a, b) for a, b in zip(tp.parameters(), again.parameters()))
    assert tp.encoder.xgate.mode == fusion


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fusion,fused", [("xgate", False), ("xgate", True), ("concat", True)])
def test_encode(fusion, fused, masked):
    cfg = make_cfg(fusion=fusion)
    jp, tp = numpy_params(cfg, 2)
    app, mot, mask = inputs(cfg)
    m = mask if masked else None
    jout, jsum = j_enc.encode(jp.encoder, app, mot, None if m is None else jnp.asarray(m))
    tout, tsum = t_enc.encode(tp.encoder, T(app), T(mot), None if m is None else T(m),
                              fused_kernels=fused)
    close(tout, jout)
    close(tsum, jsum)


def test_pos_forward_and_psi_from_tags(model):
    cfg, jp, tp = model
    rng = np.random.default_rng(4)
    summary = rng.standard_normal((3, 32)).astype(np.float32)
    tags = np.array([[1, 5, 6, 7, 2, 0, 0], [1, 4, 2, 0, 0, 0, 0], [1, 8, 9, 10, 11, 6, 2]])
    jl, jpsi = j_pos.pos_forward(jp.pos, summary, jnp.asarray(tags))
    tl, tpsi = t_pos.pos_forward(tp.pos, T(summary), T(tags))
    close(tl, jl)
    close(tpsi, jpsi)
    close(t_pos.psi_from_tags(tp.pos, T(summary), T(tags)), jpsi)


@pytest.mark.parametrize("early_stop,fused", [(False, False), (True, False), (True, True)],
                         ids=["scan", "early_stop", "fused"])
def test_pos_greedy_generate(model, early_stop, fused):
    cfg, jp, tp = model
    summary = np.random.default_rng(5).standard_normal((6, 32)).astype(np.float32)
    jt, jpsi = j_pos.pos_greedy_generate(jp.pos, jnp.asarray(summary), 9, early_stop=early_stop)
    tt, tpsi = t_pos.pos_greedy_generate(tp.pos, T(summary), 9, early_stop=early_stop, fused=fused)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    close(tpsi, jpsi)
    assert (tt == EOS).any(), "the rollout should finish some rows early"


@pytest.mark.parametrize("use_psi", [True, False])
def test_make_decode_context_and_initial_state(use_psi):
    cfg = make_cfg(pos_guidance=use_psi)
    jp, tp = numpy_params(cfg, 6)
    rng = np.random.default_rng(7)
    enc, psi, summary = (rng.standard_normal(s).astype(np.float32)
                         for s in ((3, 5, 32), (3, 10), (3, 32)))
    jc = j_dec.make_decode_context(jp.decoder, jnp.asarray(enc), jnp.asarray(psi))
    tc = t_dec.make_decode_context(tp.decoder, T(enc), T(psi))
    for name in ("enc_proj", "keys", "psi_g"):
        close(getattr(tc, name), getattr(jc, name))
    assert bool((tc.psi_g == 0).all()) == (not use_psi)
    for a, b in zip(t_dec.init_decoder_state(tp.decoder, T(summary)),
                    j_dec.init_decoder_state(jp.decoder, jnp.asarray(summary))):
        close(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_decode_step(model, fused, masked):
    cfg, jp, tp = model
    rng = np.random.default_rng(8)
    enc, psi, summary = (rng.standard_normal(s).astype(np.float32)
                         for s in ((4, 5, 32), (4, 10), (4, 32)))
    mask = np.array([[1] * 5, [1, 1, 0, 0, 0], [1] * 5, [1, 0, 0, 0, 0]], np.float32)
    m = mask if masked else None
    jc = j_dec.make_decode_context(jp.decoder, jnp.asarray(enc), jnp.asarray(psi),
                                   None if m is None else jnp.asarray(m))
    tc = t_dec.make_decode_context(tp.decoder, T(enc), T(psi), None if m is None else T(m))
    jh, jcc = j_dec.init_decoder_state(jp.decoder, jnp.asarray(summary))
    th, tcc = t_dec.init_decoder_state(tp.decoder, T(summary))
    tok = np.array([4, 9, 1, 30])
    jout = j_dec.decode_step(jp.decoder, jc, jnp.asarray(tok), jh, jcc)
    tout = t_dec.decode_step(tp.decoder, tc, T(tok), th, tcc, fused=fused)
    for a, b in zip(tout, jout):
        close(a, b)
    hid = t_dec.decode_step(tp.decoder, tc, T(tok), th, tcc, fused=fused, return_hidden=True)
    assert torch.equal(hid[0], hid[1])


@pytest.mark.parametrize("mode", ["free", "tags", "mixed"])
def test_encode_for_inference(model, mode):
    cfg, jp, tp = model
    app, mot, mask = inputs(cfg, b=4, seed=9)
    tags = np.array([[1, 5, 6, 2, 0, 0, 0, 0], [1, 4, 2, 0, 0, 0, 0, 0],
                     [1, 8, 9, 10, 6, 2, 0, 0], [1, 7, 7, 2, 0, 0, 0, 0]])
    kw_j, kw_t = {}, {}
    if mode != "free":
        kw_j["pos_tags"], kw_t["pos_tags"] = jnp.asarray(tags), T(tags)
    if mode == "mixed":
        use = np.array([True, False, True, False])
        kw_j["use_tags"], kw_t["use_tags"] = jnp.asarray(use), T(use)
    jctx, jsum, jtags = j_cap.encode_for_inference(jp, app, mot, jnp.asarray(mask),
                                                   max_pos_len=8, early_stop=True, **kw_j)
    kernels.reset_launch_counts()
    tctx, tsum, ttags = t_cap.encode_for_inference(tp, T(app), T(mot), T(mask), max_pos_len=8,
                                                   fused=True, early_stop=True, **kw_t)
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}  # CPU: plain versions
    close(tsum, jsum)
    for name in ("enc_proj", "keys", "psi_g"):
        close(getattr(tctx, name), getattr(jctx, name))
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))


def test_encode_for_inference_use_tags_needs_tags(model):
    cfg, _, tp = model
    app, mot, _ = inputs(cfg)
    with pytest.raises(ValueError, match="use_tags"):
        t_cap.encode_for_inference(tp, T(app), T(mot), use_tags=torch.ones(3, dtype=torch.bool))
