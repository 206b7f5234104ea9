"""The port's XE training slice vs the JAX package, on the CPU.

Weights are numpy draws carried to both packages by the weight bridge;
batches are seeded numpy. Tolerance: rtol 1e-5, atol 1e-6 (the bound of
the port's other parity tests) for losses and metrics, and for gradients,
updated parameters and Adam moments as well: a looser bound for the other
order of sums through the recurrent steps turned out not to be needed
(second moments, of the size of squared gradients, take atol 1e-10).
Dropout bits differ between a
`torch.Generator` and a JAX key, so the dropout tests hand the port JAX's
masks (`ops/dropout.keep_mask` replaced) and compare the arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import controllable_xgating_tpu.train.xe as j_xe
from controllable_xgating_tpu.data import loader as j_loader
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.models import decoder as j_dec
from controllable_xgating_tpu.models import encoder as j_enc
from controllable_xgating_tpu.ops import precision as j_prec
from controllable_xgating_tpu.ops.pallas.xent import xent_row_stats as j_xent_row_stats
from controllable_xgating_tpu.train import state as j_state
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch import bridge
from controllable_xgating_torch.data import loader as t_loader
from controllable_xgating_torch.models import captioner as t_cap
from controllable_xgating_torch.models import decoder as t_dec
from controllable_xgating_torch.models import encoder as t_enc
from controllable_xgating_torch.ops import dropout as t_dropout
from controllable_xgating_torch.ops import precision as t_prec
from controllable_xgating_torch.ops.dispatch import set_fused_kernels
from controllable_xgating_torch.ops.kernels.xent import xent_row_stats
from controllable_xgating_torch.train import state as t_state
from controllable_xgating_torch.train import xe as t_xe
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
B, K, L, T = 4, 2, 7, 5


def make_cfg(**flat):
    base = {
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 14, "model.pos_embed_dim": 10,
        "model.vocab_size": 40, "model.pos_vocab_size": 12, "model.num_frames": T,
        "model.dropout": 0.0,
    }
    return Config().replace_flat({**base, **flat})


def numpy_tree(cfg, seed):
    shapes = jax.eval_shape(lambda: j_cap.init_captioner(jax.random.PRNGKey(0), cfg.model))
    rng = np.random.default_rng(seed)
    tree = {}
    for name, leaf in param_paths(shapes):
        s = 1.0 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 and not name.endswith("embed") else 0.3
        tree[name] = rng.uniform(-s, s, leaf.shape).astype(np.float32)
    return tree, shapes


def both_params(cfg, seed=0):
    """(JAX CaptionerParams, port CaptionerParams) holding the same draws."""
    tree, shapes = numpy_tree(cfg, seed)
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                      [jnp.asarray(tree[n]) for n in names])
    return jp, bridge.from_numpy(tree, cfg)


def make_batch(cfg, seed=1, b=B):
    """Captions and POS tags: BOS, words, EOS, PAD*; one short row; one
    video with padded frames."""
    rng = np.random.default_rng(seed)
    m = cfg.model

    def seqs(vocab):
        x = np.zeros((b, K, L), np.int32)
        n = rng.integers(2, L - 1, (b, K))
        for i in range(b):
            for j in range(K):
                x[i, j, 0] = 1
                x[i, j, 1:n[i, j]] = rng.integers(4, vocab, n[i, j] - 1)
                x[i, j, n[i, j]] = 2
        return x

    mask = np.ones((b, T), np.float32)
    mask[1, 3:] = 0
    return {
        "app": rng.standard_normal((b, T, m.app_dim)).astype(np.float32),
        "motion": rng.standard_normal((b, T, m.motion_dim)).astype(np.float32),
        "caps": seqs(m.vocab_size), "pos": seqs(m.pos_vocab_size), "frame_mask": mask,
    }


def close(t, j, tol):
    np.testing.assert_allclose(
        t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t), np.asarray(j), **tol)


def close_trees(tdict, jdict, tol):
    assert sorted(tdict) == sorted(jdict)
    for name in jdict:
        np.testing.assert_allclose(np.asarray(tdict[name]), np.asarray(jdict[name]), **tol,
                                   err_msg=name)


def torch_grads(params, loss):
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).numpy() for (n, p), g in zip(named, grads)}


def jax_masks(monkeypatch, masks):
    """Make the port draw `masks` (JAX bool arrays, in order) as its
    dropout keep-masks."""
    queue = [torch.from_numpy(np.array(m)) for m in masks]

    def keep_mask(gen, shape, rate, device):
        got = queue.pop(0)
        assert tuple(got.shape) == tuple(shape)
        return got

    monkeypatch.setattr(t_dropout, "keep_mask", keep_mask)
    return queue


# --- ops ---


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_mm_vjp_matches_jax(policy):
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4, 24)), rng.standard_normal((24, 10))
    g = rng.standard_normal((3, 4, 10))
    a, b, g = (x.astype(np.float32) for x in (a, b, g))
    with j_prec.precision(policy), t_prec.precision(policy):
        out, vjp = jax.vjp(j_prec.mm, jnp.asarray(a), jnp.asarray(b))
        jda, jdb = vjp(jnp.asarray(g))
        ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
        tout = t_prec.mm(ta, tb)
        tda, tdb = torch.autograd.grad(tout, (ta, tb), torch.from_numpy(g))
    close(tout, out, TOL)
    close(tda, jda, TOL)
    close(tdb, jdb, TOL)
    assert tda.dtype == tdb.dtype == torch.float32


def test_mm_vjp_rounds_the_cotangent_under_bf16():
    """The custom VJP rounds g to bf16 first; plain autograd would not."""
    g = torch.tensor([[1.0 + 2.0 ** -10]])
    a = torch.ones(1, 1, requires_grad=True)
    b = torch.ones(1, 1, requires_grad=True)
    with t_prec.precision("bfloat16"):
        (da,) = torch.autograd.grad(t_prec.mm(a, b), a, g)
    assert da.item() == 1.0


@pytest.mark.parametrize("n,v", [(128, 257), (130, 257), (7, 64)])
def test_xent_plain_matches_pallas(n, v):
    rng = np.random.default_rng(n + v)
    x = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    t = rng.integers(0, v, n)
    w = rng.standard_normal((3, n)).astype(np.float32)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    want = j_xent_row_stats(jx, jt)
    jgrad = jax.grad(lambda xx: sum((wi * s).sum() for wi, s in zip(w, j_xent_row_stats(xx, jt))))(jx)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = xent_row_stats(tx, torch.from_numpy(t))
    (tgrad,) = torch.autograd.grad(sum((torch.from_numpy(wi) * s).sum() for wi, s in zip(w, got)), tx)
    for a, b in zip(got, want):
        close(a, b, dict(rtol=1e-6, atol=1e-6))  # the Pallas kernel's own test bound
    close(tgrad, jgrad, TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("jax_kernel", [True, False], ids=["pallas", "jnp"])
def test_masked_xe_sum_matches_jax(jax_kernel, smoothing, monkeypatch):
    """At the kernel gate's width: JAX through its Pallas kernel (interpret
    mode) or its jnp path; the port through the kernel route (the plain
    version on the CPU) and through the plain path."""
    rng = np.random.default_rng(3)
    v = t_xe.XENT_KERNEL_MIN_V
    logits = rng.standard_normal((8, 17, v)).astype(np.float32)
    targets = rng.integers(0, v, (8, 17))
    targets[1, 3:] = 0  # PAD
    monkeypatch.setattr(j_xe, "_XENT_KERNEL", jax_kernel)
    jl = jnp.asarray(logits)
    want = j_xe.masked_xe_sum(jl, jnp.asarray(targets), smoothing)
    jgrad = jax.grad(lambda x: j_xe.masked_xe_sum(x, jnp.asarray(targets), smoothing))(jl)
    for fused in (None, False):
        tl = torch.from_numpy(logits).requires_grad_(True)
        try:
            set_fused_kernels(fused)
            got = t_xe.masked_xe_sum(tl, torch.from_numpy(targets), smoothing)
        finally:
            set_fused_kernels(None)
        (tgrad,) = torch.autograd.grad(got, tl)
        close(got, want, TOL)
        close(tgrad, jgrad, TOL)


def test_masked_xe_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 30)).astype(np.float32)
    targets = rng.integers(0, 30, (3, 5))
    targets[0, 2:] = 0
    close(t_xe.masked_xe_loss(torch.from_numpy(logits), torch.from_numpy(targets)),
          j_xe.masked_xe_loss(jnp.asarray(logits), jnp.asarray(targets)), TOL)


def test_dropout_keep_mask_rate_and_seed():
    g = lambda: torch.Generator().manual_seed(5)
    m = t_dropout.keep_mask(g(), (200, 500), 0.3, "cpu")
    assert m.dtype == torch.bool and abs(m.float().mean().item() - 0.7) < 0.01
    assert torch.equal(m, t_dropout.keep_mask(g(), (200, 500), 0.3, "cpu"))


# --- models ---


@pytest.fixture(scope="module")
def model():
    cfg = make_cfg()
    jp, tp = both_params(cfg)
    tp.requires_grad_(True)
    return cfg, jp, tp, make_batch(cfg)


def test_encode_dropout_matches_jax_given_its_mask(model, monkeypatch):
    cfg, jp, tp, batch = model
    key = jax.random.PRNGKey(7)
    app, mot, mask = batch["app"], batch["motion"], batch["frame_mask"]
    want = j_enc.encode(jp.encoder, app, mot, jnp.asarray(mask), key, 0.5)
    jax_masks(monkeypatch, [jax.random.bernoulli(key, 0.5, (B, T, cfg.model.hidden_dim))])
    got = t_enc.encode(tp.encoder, torch.from_numpy(app), torch.from_numpy(mot),
                       torch.from_numpy(mask), gen=torch.Generator(), dropout_rate=0.5)
    for a, b in zip(got, want):
        close(a, b, TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_decoder_forward_matches_jax(model, rate, remat, monkeypatch):
    cfg, jp, tp, batch = model
    rng = np.random.default_rng(8)
    enc = rng.standard_normal((B, T, 32)).astype(np.float32)
    psi = rng.standard_normal((B, 10)).astype(np.float32)
    summary = rng.standard_normal((B, 32)).astype(np.float32)
    caps = batch["caps"][:, 0]
    key = jax.random.PRNGKey(9) if rate else None
    mask = jnp.asarray(batch["frame_mask"])
    jctx = j_dec.make_decode_context(jp.decoder, jnp.asarray(enc), jnp.asarray(psi), mask)
    want = j_dec.decoder_forward(jp.decoder, jctx, jnp.asarray(summary), jnp.asarray(caps), key,
                                 rate, remat=remat)
    if rate:
        k1, k2 = jax.random.split(key)
        jax_masks(monkeypatch, [jax.random.bernoulli(k1, 1 - rate, (L - 1, B, 12)),
                                jax.random.bernoulli(k2, 1 - rate, (L - 1, B, 16))])
    tctx = t_dec.make_decode_context(tp.decoder, torch.from_numpy(enc), torch.from_numpy(psi),
                                     torch.from_numpy(batch["frame_mask"]))
    got = t_dec.decoder_forward(tp.decoder, tctx, torch.from_numpy(summary), torch.from_numpy(caps),
                                torch.Generator() if rate else None, rate, remat=remat)
    assert got.shape == (B, L - 1, cfg.model.vocab_size) and got.is_contiguous()
    close(got, want, TOL)


def test_xe_logits_matches_jax(model):
    cfg, jp, tp, batch = model
    j_in = [jnp.asarray(batch[k][:, 0] if k in ("caps", "pos") else batch[k])
            for k in ("app", "motion", "caps", "pos", "frame_mask")]
    want = j_cap.xe_logits(jp, *j_in[:4], frame_mask=j_in[4])
    t_in = [torch.from_numpy(np.array(x)) for x in j_in]
    got = t_cap.xe_logits(tp, *t_in[:4], frame_mask=t_in[4])
    for a, b in zip(got, want):
        close(a, b, TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_xe_losses_and_every_gradient_match_jax(model, remat):
    cfg, jp, tp, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        cap, pos = j_xe.xe_losses(p, jb, None, 0.0, remat)
        return cap + pos, (cap, pos)

    (_, (jcap, jpos)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcap, tpos = t_xe.xe_losses(tp, tb, None, 0.0, remat)
    close(tcap, jcap, TOL)
    close(tpos, jpos, TOL)
    close_trees(torch_grads(tp, tcap + tpos), dict(param_paths(jg)), TOL)


def test_xe_losses_with_dropout_match_jax_given_its_masks(model, monkeypatch):
    cfg, jp, tp, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key, rate = jax.random.PRNGKey(11), 0.5

    def jloss(p):
        cap, pos = j_xe.xe_losses(p, jb, key, rate, label_smoothing=0.1)
        return cap + pos, (cap, pos)

    (_, (jcap, jpos)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    r_enc, r_dec, _ = jax.random.split(key, 3)
    k1, k2 = jax.random.split(r_dec)
    queue = jax_masks(monkeypatch, [
        jax.random.bernoulli(r_enc, 1 - rate, (B, T, 16)),
        jax.random.bernoulli(k1, 1 - rate, (L - 1, B * K, 12)),
        jax.random.bernoulli(k2, 1 - rate, (L - 1, B * K, 16)),
    ])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcap, tpos = t_xe.xe_losses(tp, tb, torch.Generator(), rate, label_smoothing=0.1)
    assert not queue
    close(tcap, jcap, TOL)
    close(tpos, jpos, TOL)
    close_trees(torch_grads(tp, tcap + tpos), dict(param_paths(jg)), TOL)


# --- optimizer, schedules, masks ---


@pytest.mark.parametrize("flat", [
    {}, {"train.lr_schedule": "cosine"}, {"train.warmup_epochs": 1.5},
    {"train.lr_schedule": "cosine", "train.warmup_epochs": 0.5, "train.lr_final_frac": 0.1},
], ids=["step", "cosine", "warmup_step", "warmup_cosine"])
@pytest.mark.parametrize("stage", ["joint", "pos"])
def test_lr_schedule_matches_optax(flat, stage):
    cfg = make_cfg(**{"train.epochs": 6, "train.lr_decay_every_epochs": 2, "train.pos_lr": 1e-3,
                      **flat})
    want = j_state.make_lr_schedule(cfg, 7, stage)
    got = t_state.make_lr_schedule(cfg, 7, stage)
    # optax evaluates in f32, the port in float64: they part by f32
    # rounding of terms of the size of the base rate
    base = cfg.train.pos_lr if stage == "pos" else cfg.train.lr
    for count in range(0, 50):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-6 * base), count


def test_lr_schedule_rejects_unknown_kind():
    with pytest.raises(ValueError, match="lr_schedule"):
        t_state.make_lr_schedule(make_cfg(**{"train.lr_schedule": "linear"}), 5)


@pytest.mark.parametrize("stage", ["pos", "caption", "joint"])
def test_stage_grad_mask_matches_jax(model, stage):
    cfg, jp, tp, _ = model
    want = {n: float(v) for n, v in param_paths(j_state.stage_grad_mask(jp, stage))}
    assert t_state.stage_grad_mask(tp, stage) == want
    with pytest.raises(ValueError, match="stage"):
        t_state.stage_grad_mask(tp, "scst")


def jax_moments(opt_state):
    """(mu, nu) as {dotted path: array} from optax's chain state."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return dict(param_paths(leaf.mu)), dict(param_paths(leaf.nu))
    raise AssertionError("no Adam state")


def torch_moments(state):
    st = state.opt_state.state
    named = list(state.params.named_parameters())
    return ({n: st[p]["exp_avg"].numpy() for n, p in named},
            {n: st[p]["exp_avg_sq"].numpy() for n, p in named})


def run_both(flat, stage, steps=2, seed=0):
    """Per step: (JAX step, metrics and params, port step, metrics and
    params); then the final JAX and port states (the port's is updated in
    place)."""
    cfg = make_cfg(**flat)
    tree, shapes = numpy_tree(cfg, seed)
    names = [n for n, _ in param_paths(shapes)]
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                      [jnp.asarray(tree[n]) for n in names])
    js = j_state.create_train_state(jp, cfg, 5)
    jstep = j_xe.make_xe_train_step(j_state.make_optimizer(cfg, 5, stage), cfg, stage, donate=False)
    ts = t_state.create_train_state(bridge.from_numpy(tree, cfg), cfg)
    tstep = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5, stage), cfg, stage)
    out = []
    for i in range(steps):
        batch = make_batch(cfg, seed=10 + i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, batch)
        out.append((int(js.step), jm, dict(param_paths(js.params)),
                    ts.step, tm, bridge.to_numpy(ts.params)))
    return out, js, ts


@pytest.mark.parametrize("stage,flat", [
    ("pos", {}), ("caption", {}), ("joint", {}),
    ("pos", {"train.accum_steps": 2}), ("caption", {"train.accum_steps": 2}),
    ("joint", {"train.accum_steps": 2}),
    ("joint", {"train.label_smoothing": 0.1}),
    ("joint", {"train.accum_steps": 2, "train.label_smoothing": 0.1}),
    ("joint", {"train.grad_clip": 0.05}),  # the clip is active
    ("caption", {"model.vocab_size": 2048, "train.label_smoothing": 0.1}),  # the xent route
], ids=lambda x: x if isinstance(x, str) else "-".join(f"{k.split('.')[1]}={v}" for k, v in x.items()))
def test_train_step_matches_jax(stage, flat):
    """Two steps: metrics and updated parameters after each, Adam moments
    after the second."""
    steps, js, ts = run_both(flat, stage)
    for i, (jstep, jm, jparams, tstep, tm, tparams) in enumerate(steps):
        assert tstep == jstep == i + 1
        for key in ("loss", "grad_norm", "cap_loss", "pos_loss"):
            close(tm[key], jm[key], TOL)
        close_trees(tparams, jparams, TOL)
    jmu, jnu = jax_moments(js.opt_state)
    tmu, tnu = torch_moments(ts)
    close_trees(tmu, jmu, TOL)
    close_trees(tnu, jnu, dict(rtol=1e-5, atol=1e-10))


@pytest.mark.parametrize("stage,frozen", [("pos", "decoder."), ("caption", "pos.")])
def test_frozen_subtrees_stay_unchanged(stage, frozen):
    cfg = make_cfg()
    tree, _ = numpy_tree(cfg, 0)
    _, _, ts = run_both({}, stage, steps=1)
    ts, _ = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5, stage), cfg, stage)(
        ts, make_batch(cfg, seed=20))
    after = bridge.to_numpy(ts.params)
    mu, _ = torch_moments(ts)
    for name in tree:
        if name.startswith(frozen):
            np.testing.assert_array_equal(after[name], tree[name], err_msg=name)
            assert not mu[name].any(), name
        elif name.endswith("w_out"):
            assert not np.array_equal(after[name], tree[name]), name


def test_train_step_rejects_indivisible_accum():
    cfg = make_cfg(**{"train.accum_steps": 3})
    ts = t_state.create_train_state(both_params(cfg)[1], cfg)
    with pytest.raises(ValueError, match="accum_steps"):
        t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5), cfg)(ts, make_batch(cfg))


def test_train_step_with_dropout_is_seeded_by_the_state():
    """The same params, batch and generator seed give the same step."""
    cfg = make_cfg(**{"model.dropout": 0.5})
    results = []
    for _ in range(2):
        ts = t_state.create_train_state(both_params(cfg)[1], cfg, seed=3)
        ts, m = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5), cfg)(ts, make_batch(cfg))
        results.append((m["loss"], bridge.to_numpy(ts.params)))
    assert torch.equal(results[0][0], results[1][0])
    ts = t_state.create_train_state(both_params(cfg)[1], cfg, seed=4)
    _, m = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5), cfg)(ts, make_batch(cfg))
    assert not torch.equal(m["loss"], results[0][0])


# --- data ---


class NumpyStore:
    def __init__(self, app, motion, counts):
        self.app, self.motion, self.counts = app, motion, counts

    def get_batch(self, idx):
        return self.app[idx], self.motion[idx]

    def frame_mask(self, idx):
        return (np.arange(self.app.shape[1])[None] < self.counts[idx][:, None]).astype(np.float32)


def test_train_batch_iterator_matches_jax():
    rng = np.random.default_rng(12)
    n, s = 11, 6
    store = NumpyStore(rng.standard_normal((n, T, 3)).astype(np.float32),
                       rng.standard_normal((n, T, 2)).astype(np.float32), rng.integers(2, T + 1, n))
    caps, pos = rng.integers(0, 50, (n, s, L)), rng.integers(0, 9, (n, s, L))
    ncaps = rng.integers(1, s + 1, n)
    ncaps[0] = 2  # fewer captions than K draws with replacement
    args = (store, caps, pos, ncaps, np.arange(1, n), 4, 3)
    jit = iter(j_loader.TrainBatchIterator(*args, seed=5))
    tit_obj = t_loader.TrainBatchIterator(*args, seed=5)
    tit = iter(tit_obj)
    assert tit_obj.steps_per_epoch() == 3
    for _ in range(7):  # past an epoch's wrapped tail
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            assert tb[k].dtype == jb[k].dtype
    with pytest.raises(ValueError, match="empty"):
        t_loader.TrainBatchIterator(store, caps, pos, ncaps, [], 4, 3)


# --- checkpoints ---


def test_checkpoint_round_trip(tmp_path):
    cfg = make_cfg(**{"model.dropout": 0.3})
    mk = lambda seed: t_state.create_train_state(both_params(cfg, seed)[1], cfg, seed=seed)
    step = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, 5), cfg)
    ts, _ = step(mk(0), make_batch(cfg))
    ck = t_state.CheckpointManager(str(tmp_path / "ck"))
    infos = {"epoch": 0, "config": {"model": {"vocab_size": 40, "fusion": "xgate"}}}
    ck.save_last(ts, infos)
    assert ck.exists("last") and not ck.exists("best")
    assert t_state.CheckpointManager.load_infos(str(tmp_path / "ck"), "last") == infos
    back, got_infos = ck.restore("last", mk(1))
    assert got_infos == infos and back.step == ts.step == 1
    for a, b in zip(back.params.parameters(), ts.params.parameters()):
        assert torch.equal(a, b)
    (ma, va), (mb, vb) = torch_moments(back), torch_moments(ts)
    for name in ma:
        np.testing.assert_array_equal(ma[name], mb[name])
        np.testing.assert_array_equal(va[name], vb[name])
    # the restored state continues exactly as the saved one, dropout included
    _, m1 = step(ts, make_batch(cfg, seed=2))
    _, m2 = step(back, make_batch(cfg, seed=2))
    assert torch.equal(m1["loss"], m2["loss"])
    ck.delete("last")
    ck.delete("last")  # idempotent
    assert not ck.exists("last")


@pytest.mark.parametrize("saved,match", [
    ({"vocab_size": 41}, "vocab_size=41"),
    ({"fusion": "concat"}, "model.fusion"),
    ({"pos_guidance": False}, "pos_guidance"),
])
def test_checkpoint_refuses_another_architecture(tmp_path, saved, match):
    cfg = make_cfg()
    ts = t_state.create_train_state(both_params(cfg)[1], cfg)
    ck = t_state.CheckpointManager(str(tmp_path))
    ck.save_best(ts, {"config": {"model": saved}})
    with pytest.raises(ValueError, match=match):
        ck.restore("best", ts)


# --- the train loop ---


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from controllable_xgating_tpu.data.corpus import load_labels
    from controllable_xgating_tpu.data.features import FeatureStore
    from controllable_xgating_tpu.data.fixtures import make_fixture_corpus

    out = str(tmp_path_factory.mktemp("train_corpus"))
    info = make_fixture_corpus(
        out, num_videos=16, num_frames=T, app_dim=12, motion_dim=10, caps_per_video=3,
        seqs_per_video=4, max_caption_len=L, seed=5,
    )
    cfg = make_cfg(**{
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.max_pos_len": L, "eval.max_decode_len": L, "data.batch_size": 4,
        "data.caps_per_video_train": 2, "train.log_every_steps": 2,
        "train.keep_epoch_snapshots": 1, "train.lr": 3e-3,
    })
    return cfg, info, load_labels(out), FeatureStore(out + "/features.h5", num_frames=T)


def test_train_loop_matches_jax(corpus, tmp_path):
    """Two epochs on the fixture corpus at dropout 0: the same per-epoch
    mean loss and val metrics as the JAX loop; `best`, `last` and one
    epoch snapshot on disk, and the JSONL log."""
    from controllable_xgating_tpu.train.loop import train_loop as j_train_loop
    from controllable_xgating_torch.train.loop import train_loop as t_train_loop
    from controllable_xgating_torch.utils.logging import JsonlLogger

    cfg, info, labels, store = corpus
    jp, tp = both_params(cfg, seed=6)
    split = np.asarray(info.splits["train"])
    it = lambda mod: mod.TrainBatchIterator(store, labels["caps"], labels["pos"], labels["ncaps"],
                                            split, cfg.data.batch_size,
                                            cfg.data.caps_per_video_train, seed=2)
    j_it, t_it = it(j_loader), it(t_loader)
    spe = t_it.steps_per_epoch()
    js = j_state.create_train_state(jp, cfg, spe)
    jstep = j_xe.make_xe_train_step(j_state.make_optimizer(cfg, spe), cfg, donate=False)
    _, jhist = j_train_loop(js, jstep, j_it, store, labels, info, cfg, epochs=2)
    ts = t_state.create_train_state(tp, cfg)
    tstep = t_xe.make_xe_train_step(t_state.make_optimizer(cfg, spe), cfg)
    ck = t_state.CheckpointManager(str(tmp_path / "ck"))
    with JsonlLogger(str(tmp_path / "log.jsonl"), echo=False) as jsonl:
        ts, thist = t_train_loop(ts, tstep, t_it, store, labels, info, cfg, epochs=2, ckpt=ck,
                                 jsonl=jsonl, infos_extra={"config": cfg.to_dict()})
    assert ts.step == 2 * spe
    assert len(thist["history"]) == len(jhist["history"]) == 2
    for te, je in zip(thist["history"], jhist["history"]):
        assert te["loss"] == pytest.approx(je["loss"], rel=1e-5, abs=1e-6)
        assert set(te["eval"]) == set(je["eval"]) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
        for k in je["eval"]:
            assert te["eval"][k] == pytest.approx(je["eval"][k], rel=1e-5, abs=1e-6), k
    assert thist["best"] == pytest.approx(jhist["best"], rel=1e-5, abs=1e-6)
    assert ck.exists("best") and ck.exists("last") and ck.exists("epoch_1")
    assert not ck.exists("epoch_0")  # a window of one snapshot
    assert t_state.CheckpointManager.load_infos(ck.directory, "last")["epoch"] == 1
    with open(tmp_path / "log.jsonl") as f:
        events = [__import__("json").loads(line) for line in f]
    assert any("loss" in e for e in events) and any("val_CIDEr" in e for e in events)
