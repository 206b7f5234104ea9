"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `gpu`: every test skips without a CUDA device. The kernels build
from `controllable_xgating_torch/csrc` at first use (nvcc, sm_90a). This
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: f32 operands rtol 1e-4, atol 1e-5 (the JAX package's CPU
kernel bound x10, for the card's other summation order); bf16 operands
2e-2, the JAX package's own bf16 kernel bound.
"""

import pytest
import torch

from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.precision import precision

pytestmark = pytest.mark.gpu
POLICIES = [("float32", dict(rtol=1e-4, atol=1e-5)), ("bfloat16", dict(rtol=2e-2, atol=2e-2))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    kernels.reset_launch_counts()
    return torch.device("cuda:0")


def gen(dev):
    return torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(1)


def close(a, b, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("rows,da,dm,h", [(37, 40, 24, 136), (6656, 1536, 1024, 512)])
def test_xgate_kernel(dev, policy, tol, rows, da, dm, h):
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel, xgate_fuse_plain
    from controllable_xgating_torch.ops.xgate import init_xgate

    g, gd = gen(dev)
    w = init_xgate(g, da, dm, h).to(dev)
    xa = torch.randn(rows, da, generator=gd, device=dev)
    xm = torch.randn(rows, dm, generator=gd, device=dev)
    with precision(policy):
        close(xgate_fuse_kernel(w, xa, xm), xgate_fuse_plain(w, xa, xm), tol)
    assert kernels.launch_counts()["xgate"] == 1


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("b,e,h", [(35, 20, 48), (256, 512, 512)])
def test_pos_lstm_kernel(dev, policy, tol, b, e, h):
    from controllable_xgating_torch.models.pos_generator import _summary_gates, init_pos_generator
    from controllable_xgating_torch.ops.kernels.pos_lstm import (
        pos_lstm_step_kernel,
        pos_lstm_step_plain,
    )

    g, gd = gen(dev)
    pos = init_pos_generator(g, 35, 2 * h, h, e, 64).to(dev)
    emb = torch.randn(b, e, generator=gd, device=dev)
    hs, cs = torch.tanh(torch.randn(b, h, generator=gd, device=dev)), torch.randn(b, h, generator=gd, device=dev)
    with precision(policy):
        sg = _summary_gates(pos, torch.tanh(torch.randn(b, 2 * h, generator=gd, device=dev)))
        for a, r in zip(pos_lstm_step_kernel(pos, emb, sg, hs, cs), pos_lstm_step_plain(pos, emb, sg, hs, cs)):
            close(a, r, tol)
    assert kernels.launch_counts()["pos_lstm"] == 1


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("r,t,h,e,a,g_dim", [(35, 7, 48, 20, 36, 44), (1280, 26, 512, 512, 512, 512)])
def test_attn_lstm_kernel(dev, policy, tol, r, t, h, e, a, g_dim):
    from controllable_xgating_torch.models.decoder import (
        init_decoder,
        init_decoder_state,
        make_decode_context,
    )
    from controllable_xgating_torch.ops.kernels.attn_lstm import (
        attn_lstm_step_kernel,
        attn_lstm_step_plain,
    )

    g, gd = gen(dev)
    dec = init_decoder(g, 300, 2 * h, h, e, a, 32, guide_dim=g_dim).to(dev)
    rn = lambda *s: torch.randn(*s, generator=gd, device=dev)
    mask = (torch.arange(t, device=dev)[None] < torch.randint(1, t + 1, (r, 1), generator=gd, device=dev)).float()
    with precision(policy):
        ctx = make_decode_context(dec, torch.tanh(rn(r, t, 2 * h)), torch.tanh(rn(r, 32)), mask)
        hd, cd = init_decoder_state(dec, torch.tanh(rn(r, 2 * h)))
        args = (dec, rn(r, e) * 0.1, hd, cd, ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask)
        for x, y in zip(attn_lstm_step_kernel(*args), attn_lstm_step_plain(*args)):
            close(x, y, tol)
    assert kernels.launch_counts()["attn_lstm"] == 1


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("r,hd,v,k,block_unk", [
    (35, 48, 300, 5, True), (9, 48, 2500, 3, False), (1280, 512, 10000, 5, False)])
def test_topk_tail_kernel(dev, policy, tol, r, hd, v, k, block_unk):
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk, logits_topk_plain

    _, gd = gen(dev)
    h = torch.tanh(torch.randn(r, hd, generator=gd, device=dev))
    w = torch.randn(hd, v, generator=gd, device=dev) * hd ** -0.5
    b = torch.randn(v, generator=gd, device=dev) * 0.1
    with precision(policy):
        vals, idx, lse = logits_topk(h, w, b, k, block_unk)
        rv, ri, rl = logits_topk_plain(h, w, b, k + 1, block_unk)
    close(vals, rv[:, :k], tol)
    close(lse, rl, tol)
    clear = rv[:, k - 1] - rv[:, k] > tol["atol"] + tol["rtol"] * rv[:, k - 1].abs()
    same = (idx.sort(1).values == ri[:, :k].sort(1).values).all(1)
    assert bool(same[clear].all())
    assert kernels.launch_counts()["topk_tail"] == 1


def test_topk_tail_kernel_breaks_ties_by_lower_index(dev):
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk

    # equal logits across vocab chunks and lanes: ids must come out ascending
    h = torch.ones(2, 8, device=dev)
    w = torch.zeros(8, 3000, device=dev)
    b = torch.zeros(3000, device=dev)
    b[[7, 40, 1500, 2999]] = 1.0
    vals, idx, _ = logits_topk(h, w, b, 4)
    assert idx.tolist() == [[7, 40, 1500, 2999]] * 2
    vals, idx, _ = logits_topk(h, w, torch.zeros(3000, device=dev), 5, block_unk=True)
    assert idx.tolist() == [[2, 4, 5, 6, 7]] * 2


def test_wrappers_raise_on_shapes_they_do_not_take(dev):
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel
    from controllable_xgating_torch.ops.xgate import init_xgate

    h = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="k <="):
        logits_topk(h, torch.randn(8, 100, device=dev), torch.zeros(100, device=dev), 9)
    w = init_xgate(torch.Generator().manual_seed(0), 8, 8, 1024).to(dev)  # too wide for smem
    with pytest.raises(ValueError, match="shared memory"):
        xgate_fuse_kernel(w, torch.randn(4, 8, device=dev), torch.randn(4, 8, device=dev))
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


@pytest.mark.parametrize("n,v", [(37, 257), (130, 2048), (1, 3), (8640, 10000)])
def test_xent_kernels(dev, n, v):
    """Forward and backward against the plain version (f32 only: the
    logits are f32 under either policy); rows not a multiple of the 8 rows
    a block takes, and V % 4 != 0 rows that start off 16-byte alignment."""
    from controllable_xgating_torch.ops.kernels.xent import (
        xent_bwd_kernel,
        xent_fwd_kernel,
        xent_row_stats_plain,
    )

    _, gd = gen(dev)
    tol = POLICIES[0][1]
    x = torch.randn(n, v, generator=gd, device=dev) * 3
    t = torch.randint(0, v, (n,), generator=gd, device=dev)
    cot = [torch.randn(n, generator=gd, device=dev) for _ in range(3)]
    xr = x.clone().requires_grad_(True)
    ref = xent_row_stats_plain(xr, t)
    (ref_dx,) = torch.autograd.grad(sum((c * r).sum() for c, r in zip(cot, ref)), xr)
    for a, r in zip(xent_fwd_kernel(x, t), ref):
        close(a, r.detach(), tol)
    close(xent_bwd_kernel(x, t, ref[0].detach(), *cot), ref_dx, tol)
    counts = kernels.launch_counts()
    assert counts["xent_fwd"] == counts["xent_bwd"] == 1


def test_xent_row_stats_autograd_on_the_card(dev):
    """Through the autograd.Function: unused statistics have no cotangent
    (treated as zero), int32 targets are taken, one launch each way."""
    from controllable_xgating_torch.ops.kernels.xent import xent_row_stats, xent_row_stats_plain

    _, gd = gen(dev)
    x = (torch.randn(100, 3000, generator=gd, device=dev) * 2).requires_grad_(True)
    t = torch.randint(0, 3000, (100,), generator=gd, device=dev, dtype=torch.int32)
    (dx,) = torch.autograd.grad(xent_row_stats(x, t)[0].sum(), x)
    (ref,) = torch.autograd.grad(xent_row_stats_plain(x, t)[0].sum(), x)
    close(dx, ref, POLICIES[0][1])
    assert kernels.launch_counts()["xent_fwd"] == kernels.launch_counts()["xent_bwd"] == 1


def test_xent_wrapper_raises_on_inputs_it_does_not_take(dev):
    from controllable_xgating_torch.ops.kernels.xent import xent_row_stats

    x = torch.randn(16, 512, device=dev)
    t = torch.zeros(16, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        xent_row_stats(x[:, ::2], t)
    with pytest.raises(TypeError, match="float32"):
        xent_row_stats(x.bfloat16(), t)
    with pytest.raises(ValueError, match="targets"):
        xent_row_stats(x, t[:8])
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


def test_xe_train_step_kernels_match_plain_path(dev):
    """One joint step at a small width through the xent kernels and through
    the plain path, f32, from the same state and batch, with label
    smoothing so that all three statistics carry a gradient. Adam's first
    moment after one step is 0.1 x the clipped gradient: all parameters'
    together are held within a relative norm of 1e-5 (a parameter whose
    gradient nearly cancels differs by ~1e-4 of its own norm from sum
    order alone)."""
    import numpy as np

    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 2500, "model.pos_vocab_size": 20, "model.num_frames": 6,
        "model.dropout": 0.3, "train.label_smoothing": 0.1,
    })
    rng = np.random.default_rng(0)
    caps = rng.integers(4, 2500, (4, 3, 9)).astype(np.int32)
    caps[..., 0], caps[..., 7], caps[..., 8] = 1, 2, 0
    pos = rng.integers(4, 20, (4, 3, 9)).astype(np.int32)
    pos[..., 0], pos[..., 6], pos[..., 7:] = 1, 2, 0
    batch = {"app": rng.standard_normal((4, 6, 40)).astype(np.float32),
             "motion": rng.standard_normal((4, 6, 24)).astype(np.float32),
             "caps": caps, "pos": pos, "frame_mask": np.ones((4, 6), np.float32)}
    out = []
    with precision("float32"):
        for fused in (None, False):
            try:
                set_fused_kernels(fused)
                state = create_train_state(init_captioner(cfg, seed=1, device=dev), cfg)
                state, m = make_xe_train_step(make_optimizer(cfg, 10), cfg)(state, batch)
            finally:
                set_fused_kernels(None)
            out.append((m, [p.detach().clone() for p in state.params.parameters()],
                        [state.opt_state.state[p]["exp_avg"] for p in state.params.parameters()]))
    (mk, pk, gk), (mp, pp, gp) = out
    for key in ("loss", "grad_norm", "cap_loss", "pos_loss"):
        close(mk[key], mp[key], dict(rtol=1e-4, atol=1e-6))
    for a, b in zip(pk, pp):
        close(a, b, dict(rtol=0.0, atol=1e-5))
    gk, gp = (torch.cat([m.flatten() for m in ms]) for ms in (gk, gp))
    assert (gk - gp).norm() <= 1e-5 * gp.norm()
    assert kernels.launch_counts()["xent_fwd"] == kernels.launch_counts()["xent_bwd"] == 1


@pytest.mark.parametrize("beam", [True, False], ids=["beam5", "greedy"])
def test_caption_path_kernels_match_plain_path(dev, beam):
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": 6,
    })
    params = init_captioner(cfg, seed=3, device=dev)
    gd = torch.Generator(device=dev).manual_seed(4)
    app = torch.randn(8, 6, 40, generator=gd, device=dev)
    mot = torch.randn(8, 6, 24, generator=gd, device=dev)
    fn = lambda: (make_beam_caption_fn(5, 8, 10) if beam else make_greedy_caption_fn(8, 10))(
        params, app, mot)
    with precision("float32"):
        tokens, tags = fn()
        try:
            set_fused_kernels(False)
            ptokens, ptags = fn()
        finally:
            set_fused_kernels(None)
    # same captions up to near-ties in the sums' order (7 of 8 rows)
    assert (tags == ptags).all(1).float().mean().item() >= 0.875
    assert (tokens == ptokens).all(1).float().mean().item() >= 0.875
    counts = kernels.launch_counts()
    assert counts["xgate"] == 1 and counts["pos_lstm"] >= 1 and counts["attn_lstm"] >= 1
    assert counts["topk_tail"] == (counts["attn_lstm"] if beam else 0)
