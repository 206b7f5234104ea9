"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `gpu`: every test skips without a CUDA device. The kernels build
from `controllable_xgating_torch/csrc` at first use (nvcc, sm_90a). This
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances: f32 operands rtol 1e-4, atol 1e-5 (the JAX package's CPU
kernel bound x10, for the card's other summation order); bf16 operands
2e-2, the JAX package's own bf16 kernel bound. The int8 vocab projection
takes bf16 operands under either policy and is held at the f32 bound:
kernel and plain version multiply the same operands.
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
@pytest.mark.parametrize("rows,da,dm,h", [(37, 40, 24, 136), (6656, 1536, 1024, 512),
                                          (6656, 1536, 4096, 512)])
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
    from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout, pos_lstm_step_plain

    g, gd = gen(dev)
    pos = init_pos_generator(g, 35, 2 * h, h, e, 64).to(dev)
    tok = torch.randint(0, 35, (b,), generator=gd, device=dev)
    hs, cs = torch.tanh(torch.randn(b, h, generator=gd, device=dev)), torch.randn(b, h, generator=gd, device=dev)
    with precision(policy):
        sg = _summary_gates(pos, torch.tanh(torch.randn(b, 2 * h, generator=gd, device=dev)))
        ref = pos_lstm_step_plain(pos, pos.embed[tok], sg, hs, cs)
        for a, r in zip(PosLstmRollout(pos, hs, sg).step(cs, tok), ref):
            close(a, r, tol)
    assert kernels.launch_counts()["pos_lstm"] == 1


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("r,t,h,e,a,g_dim", [(35, 7, 48, 20, 36, 44), (1280, 26, 512, 512, 512, 512),
                                             (1280, 26, 1024, 512, 512, 512)])
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
    (35, 48, 300, 5, True), (9, 48, 2500, 3, False), (1280, 512, 10000, 5, False),
    (1280, 1024, 10000, 5, False)])
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


# K3's and K4's bounds at the path's shapes: under bf16 a few times the
# largest |kernel - plain| of two H100 runs (both round the same operands
# and sum in f32, so they differ by summation order only)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
K3_TOL = {"float32": F32_TOL, "bfloat16": dict(rtol=0.0, atol=1e-4)}
K4_TOL = {"float32": F32_TOL, "bfloat16": dict(rtol=0.0, atol=1e-5)}


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 26])
@pytest.mark.parametrize("r,hd", [(1, 512), (5, 512), (20, 512), (37, 512), (256, 512),
                                  (1280, 512), (1280, 1024)])
def test_attn_lstm_kernel_redesign(dev, policy, r, hd, t):
    """K3 at MSR-VTT widths (decoder Hd 512, and config 5's 1024), rows
    ragged against the 64-row tiles (5 and 20: serving's buckets 1 and 4
    at beam 5), one or 26 frames, with rows whose mask leaves only frame 0
    live."""
    from controllable_xgating_torch.models.decoder import (
        init_decoder,
        init_decoder_state,
        make_decode_context,
    )
    from controllable_xgating_torch.ops.kernels.attn_lstm import (
        attn_lstm_step_kernel,
        attn_lstm_step_plain,
        attn_lstm_weights,
    )

    g, gd = gen(dev)
    dec = init_decoder(g, 300, 1024, hd, 512, 512, 512, guide_dim=512).to(dev)
    rn = lambda *s: torch.randn(*s, generator=gd, device=dev)
    live = torch.randint(1, t + 1, (r, 1), generator=gd, device=dev)
    live[::3] = 1  # every third row: frame 0 only
    mask = (torch.arange(t, device=dev)[None] < live).float()
    with precision(policy):
        ctx = make_decode_context(dec, torch.tanh(rn(r, t, 1024)), torch.tanh(rn(r, 512)), mask)
        hd, cd = init_decoder_state(dec, torch.tanh(rn(r, 1024)))
        args = (dec, dec.embed[torch.randint(4, 300, (r,), generator=gd, device=dev)], hd, cd,
                ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask)
        got = attn_lstm_step_kernel(*args, attn_lstm_weights(dec))
        ref = attn_lstm_step_plain(*args)
    for x, y in zip(got, ref):
        close(x, y, K3_TOL[policy])
    assert kernels.launch_counts()["attn_lstm"] == 1


def planted_tail(dev, r, v, seed=2, hd=512):
    """(h, w, b, tied rows): logits N(0, 1)-ish, and on every other row
    four equal winners at columns 127 | 128 (an N-tile edge, and K6's
    chunk edge under bf16) and CHUNK_COLS - 1 | CHUNK_COLS (K4's vocab
    chunk edge), where they exist. Their w columns are zero and their bias
    equal, so the logits tie exactly in any summation order."""
    from controllable_xgating_torch.ops.kernels.topk_tail import CHUNK_COLS

    gd = torch.Generator(device=dev).manual_seed(seed)
    h = torch.tanh(torch.randn(r, hd, generator=gd, device=dev))
    w = torch.randn(hd, v, generator=gd, device=dev) * hd ** -0.5
    b = torch.randn(v, generator=gd, device=dev) * 0.1
    cols = [c for c in (127, 128, CHUNK_COLS - 1, CHUNK_COLS) if c < v]
    tied = torch.arange(r, device=dev) % 2 == 0
    w[:, cols] = 0.0
    b[cols] = 6.0
    h[tied] *= 0.25  # the tie beats the rest on the tied rows
    return h, w, b, tied


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_unk", [False, True])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("r,v,hd", [(1, 129, 512), (65, 1000, 512), (1280, 10000, 512),
                                    (65, 10000, 512), (1280, 129, 512), (5, 10000, 512),
                                    (20, 10000, 512), (256, 10000, 512), (1280, 10000, 1024)])
def test_topk_tail_kernel_redesign(dev, policy, r, v, hd, k, block_unk):
    """K4 against its plain version: values and lse within the bounds,
    id sets equal on rows clear of ties, and on the rows with planted
    ties across an N-tile and a chunk edge, the ids in the plain order.
    Rows 5, 20, 256 and 1280: serving's buckets 1 and 4 at beam 5, greedy's
    and beam 5's rows over 256 videos; Hd 1024: config 5's decoder."""
    from controllable_xgating_torch.ops.kernels.topk_tail import (
        logits_topk,
        logits_topk_plain,
        topk_tail_weights,
    )

    h, w, b, tied = planted_tail(dev, r, v, hd=hd)
    tol = K4_TOL[policy]
    with precision(policy):
        vals, idx, lse = logits_topk(h, w, b, k, block_unk, topk_tail_weights(w))
        rv, ri, rl = logits_topk_plain(h, w, b, k + 1, block_unk)
    close(vals, rv[:, :k], tol)
    close(lse, rl, tol)
    clear = rv[:, k - 1] - rv[:, k] > tol["atol"] + tol["rtol"] * rv[:, k - 1].abs()
    same = (idx.sort(1).values == ri[:, :k].sort(1).values).all(1)
    assert bool(same[clear].all())
    assert torch.equal(idx[tied], ri[tied, :k])
    assert kernels.launch_counts()["topk_tail"] == 1


def test_redesigned_kernels_run_on_wgmma(dev):
    """The SASS of the built library: HGMMA in K3's pre-activation GEMM,
    K4's chunk kernel, K7, K2's bf16 kernel, K1's chain and K6's bf16
    kernel, and no TF32 product anywhere (the f32 policy's kernels stay
    full f32)."""
    import shutil
    import subprocess

    from controllable_xgating_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", build.build()], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    for kernel in ("pre_gemm_kernel", "topk_chunk_wgmma_kernel", "int8_vocab_kernel",
                   "pos_lstm_wgmma_kernel", "xgate_chain_kernel", "topk_extract_wgmma_kernel"):
        bodies = [body for name, body in funcs.items() if kernel in name]
        assert bodies and all("HGMMA" in body for body in bodies), kernel
    assert "TF32" not in sass


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


@pytest.mark.parametrize("policy,tol", POLICIES)
@pytest.mark.parametrize("r,hd,v,k", [(35, 48, 300, 5), (9, 48, 2500, 3), (1280, 512, 10000, 5)])
def test_topk_extract_kernel(dev, policy, tol, r, hd, v, k):
    """K6 against its plain version, and against the beam tail's kernel
    (K4) on the same inputs: the same ids on rows clear of ties."""
    from controllable_xgating_torch.ops.kernels.topk_extract import (
        logits_topk_extract_kernel,
        logits_topk_extract_plain,
    )
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk

    _, gd = gen(dev)
    h = torch.tanh(torch.randn(r, hd, generator=gd, device=dev))
    w = torch.randn(hd, v, generator=gd, device=dev) * hd ** -0.5
    b = torch.randn(v, generator=gd, device=dev) * 0.1
    with precision(policy):
        vals, idx, lse = logits_topk_extract_kernel(h, w, b, k)
        rv, ri, rl = logits_topk_extract_plain(h, w, b, k + 1)
        kv, ki, kl = logits_topk(h, w, b, k)
    close(vals, rv[:, :k], tol)
    close(lse, rl, tol)
    close(vals, kv, tol)
    close(lse, kl, tol)
    clear = rv[:, k - 1] - rv[:, k] > tol["atol"] + tol["rtol"] * rv[:, k - 1].abs()
    for ids in (ri[:, :k], ki):
        same = (idx.sort(1).values == ids.sort(1).values).all(1)
        assert bool(same[clear].all())
    assert kernels.launch_counts()["topk_extract"] == 1


def test_topk_extract_kernel_breaks_ties_by_lower_index(dev):
    from controllable_xgating_torch.ops.kernels.topk_extract import logits_topk_extract_kernel

    # equal logits across vocab chunks: ids come out ascending; PAD and BOS never win
    h = torch.ones(2, 8, device=dev)
    w = torch.zeros(8, 3000, device=dev)
    b = torch.zeros(3000, device=dev)
    b[[0, 1, 7, 40, 1500, 2999]] = 1.0
    vals, idx, _ = logits_topk_extract_kernel(h, w, b, 4)
    assert idx.tolist() == [[7, 40, 1500, 2999]] * 2
    vals, idx, _ = logits_topk_extract_kernel(h, w, torch.zeros(3000, device=dev), 5)
    assert idx.tolist() == [[2, 3, 4, 5, 6]] * 2


# K1's bound under bf16: one bf16 ulp of |out| in [0.5, 1), the top binade
# of its tanh (the output is itself rounded to bf16)
K1_TOL = {"float32": F32_TOL, "bfloat16": dict(rtol=0.0, atol=2.0 ** -8)}


def device_kernels(fn, tries=3) -> tuple[set, int]:
    """(names of the port's kernels (namespace cxg) that one call of fn
    launched, from torch.profiler; the calls made). The profiler now and
    then keeps no device event of a whole profile (ROADMAP M5): a profile
    with none of the port's kernels is taken again, up to `tries` calls."""
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if "cxg::" in e.key}
        if names:
            break
    return names, calls


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,da,dm,h", [(37, 40, 24, 136), (6656, 1536, 1024, 512),
                                          (37, 40, 24, 132), (70, 42, 24, 136),
                                          (6656, 1536, 4096, 512), (77, 40, 24, 136),
                                          (77, 40, 24, 132), (26, 1536, 1024, 512),
                                          (104, 1536, 1024, 512)])
def test_xgate_kernel_redesign(dev, policy, rows, da, dm, h):
    """K1 against its plain version: under bf16 the wgmma chain (three
    launches) where xgate_fits, the SIMT kernel at H % 8 != 0 or da % 8 !=
    0; under f32 always the SIMT kernel; operands from xgate_weights made
    once, as the encoder's call does. 6656, 26 and 104 rows: 256, 1 and 4
    videos of 26 frames (a split's batch, serving's buckets 1 and 4)."""
    from controllable_xgating_torch.ops.kernels.xgate import (
        xgate_fits,
        xgate_fuse_kernel,
        xgate_fuse_plain,
        xgate_weights,
    )
    from controllable_xgating_torch.ops.xgate import init_xgate

    g, gd = gen(dev)
    w = init_xgate(g, da, dm, h).to(dev)
    for b in (w.ba, w.bm, w.bga, w.bgm, w.bf):
        b.data = torch.randn(h, generator=gd, device=dev) * 0.1
    xa = torch.randn(rows, da, generator=gd, device=dev)
    xm = torch.randn(rows, dm, generator=gd, device=dev)
    with precision(policy):
        ops = xgate_weights(w)
        out = xgate_fuse_kernel(w, xa, xm, ops)
        close(out, xgate_fuse_plain(w, xa, xm), K1_TOL[policy])
        names, calls = device_kernels(lambda: xgate_fuse_kernel(w, xa, xm, ops))
    chain = policy == "bfloat16" and xgate_fits(da, dm, h)
    assert out.shape == (rows, h) and out.dtype == torch.float32
    assert sum("xgate_chain_kernel" in n for n in names) == (3 if chain else 0), names
    assert any("xgate_kernel" in n for n in names) != chain, names
    assert kernels.launch_counts()["xgate"] == 1 + calls


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("r,hd,v", [(37, 40, 257), (1280, 512, 10000), (65, 42, 1000)])
def test_topk_extract_kernel_redesign(dev, policy, r, hd, v, k):
    """K6 against its plain version on the beam tail's operand made once:
    values and lse within the bounds, id sets equal on rows clear of ties,
    and on the rows with planted ties across a 128-column chunk edge the
    ids in the plain order; Hd = 42 takes the zero-padded operand. K6
    against K4 on the same inputs: values and lse within the same bounds,
    the same id sets on rows clear of ties."""
    from controllable_xgating_torch.ops.kernels.topk_extract import (
        logits_topk_extract_kernel,
        logits_topk_extract_plain,
    )
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk, topk_tail_weights

    h, w, b, tied = planted_tail(dev, r, v, hd=hd)
    tol = K4_TOL[policy]
    with precision(policy):
        w_op = topk_tail_weights(w)
        vals, idx, lse = logits_topk_extract_kernel(h, w, b, k, w_op)
        rv, ri, rl = logits_topk_extract_plain(h, w, b, k + 1)
        kv, ki, kl = logits_topk(h, w, b, k, False, w_op)
    close(vals, rv[:, :k], tol)
    close(lse, rl, tol)
    close(vals, kv, tol)
    close(lse, kl, tol)
    clear = rv[:, k - 1] - rv[:, k] > tol["atol"] + tol["rtol"] * rv[:, k - 1].abs()
    for ids in (ri[:, :k], ki):
        same = (idx.sort(1).values == ids.sort(1).values).all(1)
        assert bool(same[clear].all())
    assert torch.equal(idx[tied], ri[tied, :k])
    assert kernels.launch_counts()["topk_extract"] == 1


@pytest.mark.parametrize("hd", [6, 42])
def test_topk_tail_kernel_pads_hd(dev, hd):
    """K4 under bf16 at Hd % 8 != 0: h and w_out^T go with zero columns to
    a multiple of 8, made by the wrapper or once by topk_tail_weights."""
    from controllable_xgating_torch.ops.kernels.topk_tail import (
        logits_topk,
        logits_topk_plain,
        topk_tail_weights,
    )

    h, w, b, tied = planted_tail(dev, 77, 1000, hd=hd)
    tol = K4_TOL["bfloat16"]
    with precision("bfloat16"):
        outs = [logits_topk(h, w, b, 5), logits_topk(h, w, b, 5, False, topk_tail_weights(w))]
        rv, ri, rl = logits_topk_plain(h, w, b, 6)
    for vals, idx, lse in outs:
        close(vals, rv[:, :5], tol)
        close(lse, rl, tol)
        assert torch.equal(idx[tied], ri[tied, :5])
    assert kernels.launch_counts()["topk_tail"] == 2


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_beam_keeps_the_lanes_tail_at_config_5s_decoder(dev, policy):
    """Config 5 (decoder Hd 1024 = 2 x 512, MSR-VTT widths, vocab 10000):
    beam 5 launches K4 at every step (lanes_fits(5, 1024): 181,248 B of
    shared memory under bf16), never the grouped tail, and K3 at Hd 1024.
    Under f32 >= 98% of its beams equal the grouped tail's through the
    same K3, with scores within the f32 bound (the two project in another
    sum order; under bf16 K4's bf16 projection and the grouped tail's
    `mm` round differently, so near-ties of random weights flip more
    often: 0.959 on an H100)."""
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
    from controllable_xgating_torch.ops.kernels.topk_tail import lanes_fits
    from controllable_xgating_torch.utils.config import load_config

    cfg = load_config("configs/msrvtt.json", {"model.vocab_size": 10000,
                                              "model.pos_vocab_size": 35,
                                              "model.decoder_hidden_mult": 2})
    params = init_captioner(cfg, seed=0, device=dev)
    assert params.decoder.init_h.shape[1] == 1024
    gd = torch.Generator(device=dev).manual_seed(4)
    app = torch.randn(64, 26, 1536, generator=gd, device=dev)
    mot = torch.randn(64, 26, 1024, generator=gd, device=dev)
    with precision(policy), torch.inference_mode():
        assert lanes_fits(5, 1024)
        ctx, summary, _ = encode_for_inference(params, app, mot, max_pos_len=28, fused=True)
        kernels.reset_launch_counts()
        got = beam_search(params.decoder, ctx, summary, 5, 28, fused=True, return_all=True)
        counts = kernels.launch_counts()
        want = beam_search(params.decoder, ctx, summary, 5, 28, fused=True, topk_mode="grouped",
                           return_all=True)
    assert counts["topk_tail"] == 28 and counts["attn_lstm"] == 28, counts
    assert torch.isfinite(got[1]).all()
    if policy == "float32":
        same = (got[0] == want[0]).all(-1)
        assert same.float().mean().item() >= 0.98, same.float().mean().item()
        close(got[1][same], want[1][same], dict(POLICIES)[policy])


def test_beam_wider_than_the_lanes_limit_takes_grouped(dev):
    """beam_search(beam_size=10, fused=True) on the card: the lanes tail is
    never launched, and the tokens and scores equal the grouped tail's
    through the same kernels."""
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
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
    with precision("bfloat16"), torch.inference_mode():
        ctx, summary, _ = encode_for_inference(params, app, mot, max_pos_len=8, fused=True)
        got = beam_search(params.decoder, ctx, summary, 10, 10, fused=True, return_all=True)
        counts = kernels.launch_counts()
        want = beam_search(params.decoder, ctx, summary, 10, 10, fused=True, topk_mode="grouped",
                           return_all=True)
    assert counts["topk_tail"] == 0 and counts["attn_lstm"] == 10
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def small_decoder_inputs(dev, policy):
    """A narrow captioner on the card and the decode context of 8 videos."""
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": 6,
    })
    params = init_captioner(cfg, seed=5, device=dev)
    gd = torch.Generator(device=dev).manual_seed(6)
    app = torch.randn(8, 6, 40, generator=gd, device=dev)
    mot = torch.randn(8, 6, 24, generator=gd, device=dev)
    with precision(policy), torch.inference_mode():
        ctx, summary, _ = encode_for_inference(params, app, mot, max_pos_len=8, fused=True)
    return params, ctx, summary


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_greedy_lanes_launches_the_tail_at_k1(dev, policy):
    """greedy_decode(lanes=True) on the card takes every step's projection
    and argmax through K4 at k = 1 and gives the tokens of the argmax over
    the projected logits through the same decoder-step kernel."""
    from controllable_xgating_torch.infer.greedy import greedy_decode

    params, ctx, summary = small_decoder_inputs(dev, policy)
    kernels.reset_launch_counts()
    with precision(policy), torch.inference_mode():
        got = greedy_decode(params.decoder, ctx, summary, 10, fused=True, lanes=True)
        counts = kernels.launch_counts()
        want = greedy_decode(params.decoder, ctx, summary, 10, fused=True)
    assert counts["topk_tail"] == counts["attn_lstm"] == 10
    assert torch.equal(got, want)


def test_sample_decode_on_the_card(dev):
    """sample_decode with a CUDA generator: the same seed gives the same
    tokens and logprobs; at temperature 1e-6, with the vocab projection
    scaled so that the logits spread over O(1), the tokens are greedy's
    (at init the logits lie within ~1e-3 of each other, and a temperature
    of 1e-4 still samples among them)."""
    from controllable_xgating_torch.infer.greedy import greedy_decode, sample_decode

    params, ctx, summary = small_decoder_inputs(dev, "bfloat16")
    with torch.no_grad():
        params.decoder.w_out.mul_(50.0)
    with precision("bfloat16"), torch.inference_mode():
        run = lambda seed, temp=1.0: sample_decode(
            params.decoder, ctx, summary, 10, torch.Generator(device=dev).manual_seed(seed), temp,
            fused=True)
        (a, la), (b, lb) = run(0), run(0)
        cold = run(1, 1e-6)[0]
        greedy = greedy_decode(params.decoder, ctx, summary, 10, fused=True)
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.isfinite(la).all()
    assert torch.equal(cold, greedy)


@pytest.mark.parametrize("m,k,n", [(24, 64, 1300), (256, 512, 10000), (1280, 512, 10000),
                                   (77, 96, 130), (1280, 1024, 10000)])
def test_int8_vocab_kernel(dev, m, k, n):
    """K7 against its plain version: both multiply the same bf16 operands
    and differ only in summation order (f32 tolerance). The plain version
    ignores the compute policy, so does the kernel."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_plain, int8_vocab_proj

    _, gd = gen(dev)
    q = quantize_vocab_proj(torch.randn(k, n, generator=gd, device=dev) * k ** -0.5,
                            torch.randn(n, generator=gd, device=dev) * 0.1)
    x = torch.tanh(torch.randn(m, k, generator=gd, device=dev))
    ref = int8_vocab_plain(x, q.wq, q.scale, q.bias)[:, :n]
    for policy, _ in POLICIES:
        with precision(policy):
            out = int8_vocab_proj(x, q.wq, q.scale, q.bias, n)
        assert out.shape == (m, n) and out.dtype == torch.float32
        close(out, ref, POLICIES[0][1])
    assert kernels.launch_counts()["int8_vocab"] == 2


@pytest.mark.parametrize("k", [6, 42, 100])
def test_int8_vocab_kernel_takes_any_depth(dev, k):
    """K7 at depths K % 8 != 0: the wrapper gives x zero columns to a
    multiple of 8 (16-byte TMA rows), against which the K-major weight is
    zero, and the kernel equals the plain version (f32 tolerance)."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_plain, int8_vocab_proj

    _, gd = gen(dev)
    q = quantize_vocab_proj(torch.randn(k, 1301, generator=gd, device=dev) * k ** -0.5,
                            torch.randn(1301, generator=gd, device=dev) * 0.1)
    x = torch.tanh(torch.randn(77, k, generator=gd, device=dev))
    out = int8_vocab_proj(x, q.wq, q.scale, q.bias, q.n)
    assert out.shape == (77, 1301)
    close(out, int8_vocab_plain(x, q.wq, q.scale, q.bias)[:, : q.n], POLICIES[0][1])
    assert kernels.launch_counts()["int8_vocab"] == 1


def test_wrappers_raise_on_shapes_they_do_not_take(dev):
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_proj
    from controllable_xgating_torch.ops.kernels.topk_extract import logits_topk_extract_kernel
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel
    from controllable_xgating_torch.ops.xgate import init_xgate

    h = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="k <="):
        logits_topk(h, torch.randn(8, 100, device=dev), torch.zeros(100, device=dev), 9)
    with precision("bfloat16"), pytest.raises(ValueError, match="k <="):
        logits_topk(h, torch.randn(8, 100, device=dev), torch.zeros(100, device=dev), 10)
    with pytest.raises(ValueError, match="k <="):
        logits_topk_extract_kernel(h, torch.randn(8, 100, device=dev), torch.zeros(100, device=dev), 9)
    q = quantize_vocab_proj(torch.randn(8, 102, device=dev), torch.zeros(102, device=dev))
    with pytest.raises(ValueError, match="padded width"):  # n past the padded width
        int8_vocab_proj(h, q.wq, q.scale, q.bias, q.wq.shape[1] + 1)
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


@pytest.mark.parametrize("cotangents", ["normal", "loss"])
def test_xent_kernels_at_the_step_shape(dev, cotangents):
    """K5 at the XE step's [8640, 10000] (64 videos x 5 captions x 27
    positions) with PAD targets on a tenth of the rows: the forward
    statistics within the f32 bound, and the backward at N(0, 1)
    cotangents (each term of dx at its own scale) or at those of the
    label-smoothed masked loss (eps 0.1), where most of dx is ~1/V: there
    the bound's atol is 1e-6 x max |dx| (at 1e-5 a kernel that halves the
    g_mean / V term passes)."""
    from controllable_xgating_torch.data.vocab import PAD
    from controllable_xgating_torch.ops.kernels.xent import (
        xent_bwd_kernel,
        xent_fwd_kernel,
        xent_row_stats_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    n, v, eps = 8640, 10000, 0.1
    x = torch.randn(n, v, generator=g, device=dev) * 3.0
    t = torch.randint(4, v, (n,), generator=g, device=dev)
    t[torch.rand(n, generator=g, device=dev) < 0.1] = PAD
    mask = (t != PAD).float()
    # d/d(lse, x[t], mean) of sum(mask * ((1 - eps)(lse - x[t]) + eps (lse - mean)))
    cot = ((mask, -(1.0 - eps) * mask, -eps * mask) if cotangents == "loss"
           else tuple(torch.randn(n, generator=g, device=dev) for _ in range(3)))
    xr = x.clone().requires_grad_(True)
    ref = xent_row_stats_plain(xr, t)
    with torch.no_grad():
        for a, r in zip(xent_fwd_kernel(x, t), ref):
            close(a, r.detach(), F32_TOL)
    (ref_dx,) = torch.autograd.grad(sum((c * r).sum() for c, r in zip(cot, ref)), xr)
    dx = xent_bwd_kernel(x, t, ref[0].detach(), *cot)
    close(dx, ref_dx, dict(rtol=F32_TOL["rtol"], atol=1e-6 * ref_dx.abs().max().item()))


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


@pytest.mark.parametrize("beam", [True, False], ids=["beam5", "greedy"])
def test_quantized_path_kernels_match_plain_path(dev, beam):
    """The vocab_q path, f32: the kernels (attn_lstm and int8_vocab, one
    launch each per step) against the plain path, from the same weights."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
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
    vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)

    def run(fused):
        ctx, summary, _ = encode_for_inference(params, app, mot, max_pos_len=8, fused=fused)
        if beam:
            return beam_search(params.decoder, ctx, summary, 5, 10, fused=fused, vocab_q=vq)[0]
        return greedy_decode(params.decoder, ctx, summary, 10, fused=fused, vocab_q=vq)

    with precision("float32"), torch.inference_mode():
        tokens = run(True)
        counts = kernels.launch_counts()
        try:
            set_fused_kernels(False)
            ptokens = run(False)
        finally:
            set_fused_kernels(None)
    assert (tokens == ptokens).all(1).float().mean().item() >= 0.875
    assert counts["int8_vocab"] == counts["attn_lstm"] == 10
    assert counts["topk_tail"] == 0
    assert kernels.launch_counts() == counts  # the plain path launched nothing


@pytest.mark.parametrize("m", [1, 77, 256, 1280])
@pytest.mark.parametrize("k,n", [(512, 10000), (96, 1300), (96, 1301), (40, 130), (90, 1301),
                                 (1024, 10000)])
def test_int8_vocab_kernel_redesign(dev, m, k, n):
    """K7 (TMA + wgmma with the widened weight in registers, persistent
    tiles) against its plain version, on the K-major operand made once
    (`int8_vocab_weights`): rows ragged against the 128-row tiles, depths
    not a multiple of 64 (90 nor of 8: x takes zero columns), widths not a
    multiple of 128 (nor of 4: the output rows off 16-byte alignment), and
    config 5's depth 1024. The plain version is held at the f32 bound:
    both multiply the same bf16 operands."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.ops.kernels.int8_vocab import (
        int8_vocab_plain,
        int8_vocab_proj,
        int8_vocab_weights,
    )

    _, gd = gen(dev)
    q = quantize_vocab_proj(torch.randn(k, n, generator=gd, device=dev) * k ** -0.5,
                            torch.randn(n, generator=gd, device=dev) * 0.1)
    x = torch.tanh(torch.randn(m, k, generator=gd, device=dev))
    wq_t = int8_vocab_weights(q.wq)
    assert wq_t.shape == (q.wq.shape[1], -(-k // 64) * 64)
    out = int8_vocab_proj(x, q.wq, q.scale, q.bias, n, wq_t)
    assert out.shape == (m, n)
    close(out, int8_vocab_plain(x, q.wq, q.scale, q.bias)[:, :n], F32_TOL)
    assert kernels.launch_counts()["int8_vocab"] == 1


K2_TOL = {"float32": F32_TOL, "bfloat16": dict(rtol=0.0, atol=1e-5)}


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4, 37, 77, 256])
@pytest.mark.parametrize("e,h", [(512, 512), (20, 48), (100, 72)])
def test_pos_lstm_kernel_redesign(dev, policy, b, e, h):
    """K2 through a rollout (`PosLstmRollout`): three steps on gathered
    tags, each against the plain step from the same state within the
    bound; rows ragged against the 64-row tiles, Ep and H not multiples of
    64 (Ep % 8 != 0 too). Under bf16 the kernel's own bf16 copy of h' (the
    next step's operand) is exactly h' rounded to nearest even."""
    from controllable_xgating_torch.models.pos_generator import _summary_gates, init_pos_generator
    from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout, pos_lstm_step_plain

    g, gd = gen(dev)
    pos = init_pos_generator(g, 35, 2 * h, h, e, 64).to(dev)
    hs = torch.tanh(torch.randn(b, h, generator=gd, device=dev))
    cs = torch.randn(b, h, generator=gd, device=dev)
    with precision(policy):
        sg = _summary_gates(pos, torch.tanh(torch.randn(b, 2 * h, generator=gd, device=dev)))
        cell = PosLstmRollout(pos, hs, sg)
        for _ in range(3):
            tok = torch.randint(0, 35, (b,), generator=gd, device=dev)
            ref = pos_lstm_step_plain(pos, pos.embed[tok], sg, hs, cs)
            hs, cs = cell.step(cs, tok=tok)
            for a, r in zip((hs, cs), ref):
                close(a, r, K2_TOL[policy])
            if policy == "bfloat16":
                assert torch.equal(cell.hb[cell.cur][:, :h], hs.bfloat16())
    assert kernels.launch_counts()["pos_lstm"] == 3


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("shape", [(1280, 10000), (256, 50000), (7, 129)])
def test_topk_keeps_the_stable_sort_order_on_the_card(dev, shape, k):
    """The beam tails' top-K on the card: the stable sort's indices and
    values exactly, on rows with planted ties across the whole row, +-0.0,
    -inf and -1e30."""
    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    gd = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(*shape, generator=gd, device=dev)
    x[::2] = torch.randint(-2, 3, (x[::2].shape), generator=gd, device=dev).float()
    x[:, ::7] = -0.0
    x[:, 1::11] = -1e30
    x[1::3, 2::13] = -float("inf")
    vals, idx = topk(x, k)
    ref_v, ref_i = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(idx, ref_i[:, :k])
    assert torch.equal(vals, ref_v[:, :k])


@pytest.mark.parametrize("k", [1, 5, 8])
def test_topk_keeps_the_stable_sort_order_on_beam_candidates(dev, k):
    """The beam tails' top-K on the quantized beam's candidate matrix
    [1280, 10000] (a beam's cumulative score plus a log-softmax): rows
    that repeat their own values, a tie for the top, finished rows (0 at
    PAD, -1e30 elsewhere: the top-K reaches into the -1e30 ties), -0.0 and
    a column of -inf give the stable sort's indices and values exactly."""
    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    g = torch.Generator(device=dev).manual_seed(17)
    r, v = 1280, 10000
    x = -torch.rand(r, 1, generator=g, device=dev) * 10 + torch.log_softmax(
        torch.randn(r, v, generator=g, device=dev) * 3, -1)
    x[::4, 100:140] = x[::4, 5:6]
    x[1::4, 17] = x[1::4, 9000] = x[1::4].amax(-1)
    x[2::4] = torch.where(torch.arange(v, device=dev) == 0, 0.0, -1e30)
    x[3::4, ::9] = -0.0
    x[:, 1] = -float("inf")
    vals, idx = topk(x, k)
    ref_v, ref_i = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(idx, ref_i[:, :k])
    assert torch.equal(vals, ref_v[:, :k])


def scst_corpus(n=300, s=20, length=28, vocab=10000, seed=0):
    """n videos x s seeded captions: BOS, 5-25 random ids, EOS, PAD."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = rng.integers(6, length - 1, (n, s))[..., None]
    col = np.arange(length)[None, None, :]
    caps = np.where(col <= words, rng.integers(4, vocab, (n, s, length)), 0)
    caps[..., 0] = 1
    np.put_along_axis(caps, words, 2, axis=-1)
    return caps.astype(np.int32), np.full(n, s, np.int32), rng


def test_cider_d_device_on_the_card_matches_the_cpu(dev):
    """The SCST reward on the card: the tables' hashes, df rows and
    lookups equal the CPU's bit for bit, the reward within atol 1e-5."""
    import numpy as np

    from controllable_xgating_torch.ops import cider_device as cd

    caps, ncaps, rng = scst_corpus()
    cpu = cd.build_reward_tables(caps, ncaps, range(200), device="cpu")
    card = cd.build_reward_tables(caps, ncaps, range(200), device=dev)
    for name in ("table_rows", "table_dir", "ref_h1", "ref_h2", "ref_valid", "ref_tf"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    close(card.ref_idf.cpu(), cpu.ref_idf, dict(rtol=1e-6, atol=1e-6))
    vids = rng.integers(0, 300, 256)
    cand = np.zeros((256, 28), np.int32)
    cand[::2, :27] = caps[vids[::2], 0, 1:]
    cand[1::2, :12] = rng.integers(4, 10000, (128, 12))
    cand[1::2, 12] = 2
    vi = torch.as_tensor(vids)
    got = cd.cider_d_device(card, torch.as_tensor(cand, device=dev), vi.to(dev))
    want = cd.cider_d_device(cpu, torch.as_tensor(cand), vi)
    close(got.cpu(), want, dict(rtol=0.0, atol=1e-5))
    assert (want[::2] > 0).all()


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_scst_baseline_tokens_kernels_match_plain_path(dev, paired):
    """The SCST baseline (and the paired rollout's greedy half) through the
    decoder-step kernel equals the plain path's tokens on 7 of 8 rows or
    more, f32; one kernel launch a step; the loss of a step is finite."""
    from controllable_xgating_torch.infer.greedy import greedy_decode, paired_rollout
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import cider_device as cd
    from controllable_xgating_torch.train.scst import scst_context, scst_loss
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 10000, "model.pos_vocab_size": 20, "model.num_frames": 6,
    })
    caps, ncaps, _ = scst_corpus()
    tables = cd.build_reward_tables(caps, ncaps, range(200), device=dev)
    params = init_captioner(cfg, seed=3, device=dev)
    gd = torch.Generator(device=dev).manual_seed(4)
    batch = {"app": torch.randn(8, 6, 40, generator=gd, device=dev),
             "motion": torch.randn(8, 6, 24, generator=gd, device=dev),
             "video_indices": torch.arange(8, device=dev)}
    with precision("float32"), torch.no_grad():
        ctx, summary = scst_context(params, batch, 10)
        if paired:
            run = lambda fused: paired_rollout(params.decoder, ctx, summary, 10,
                                               torch.Generator(device=dev).manual_seed(0),
                                               fused=fused)[0]
        else:
            run = lambda fused: greedy_decode(params.decoder, ctx, summary, 10, fused=fused)
        kernels.reset_launch_counts()
        tokens = run(True)
        assert kernels.launch_counts()["attn_lstm"] == 10
        plain = run(False)
    assert (tokens == plain).all(1).float().mean().item() >= 0.875
    params.requires_grad_(True)
    with precision("float32"):
        loss, aux = scst_loss(params, batch, tables, torch.Generator(device=dev).manual_seed(0), 10,
                              10, fused_baseline=True, paired=paired)
    assert torch.isfinite(loss) and all(torch.isfinite(v) for v in aux.values())


def a9_model(dev, seed=3, **over):
    """A small captioner on the card for the decode-science tests (greedy
    and beam run all 10 steps: random weights rarely emit EOS)."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": 6, **over,
    })
    return init_captioner(cfg, seed=seed, device=dev)


def a9_inputs(dev):
    gd = torch.Generator(device=dev).manual_seed(4)
    return torch.randn(8, 6, 40, generator=gd, device=dev), torch.randn(8, 6, 24, generator=gd,
                                                                          device=dev)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_ensemble_identity_with_the_kernels(dev, policy):
    """A [p, p] ensemble through the kernels gives the single model's tokens
    (beam 5 on the grouped tail, and greedy) exactly, and launches K1 and
    K3 once per member: the members' mean log-prob of identical members
    is the member's."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    p = a9_model(dev)
    app, mot = a9_inputs(dev)
    with precision(policy):
        single = make_beam_caption_fn(5, 8, 10, topk_mode="grouped", return_all=True,
                                      early_stop=False)(p, app, mot)
        kernels.reset_launch_counts()
        ens = make_ensemble_caption_fn(5, 8, 10, return_all=True, early_stop=False)(
            (p, p), app, mot)
        counts = kernels.launch_counts()
        g1 = make_greedy_caption_fn(8, 10)(p, app, mot)[0]
        g2 = make_ensemble_caption_fn(1, 8, 10)((p, p), app, mot)[0]
    assert torch.equal(ens[0], single[0]) and torch.equal(ens[2], single[2])
    torch.testing.assert_close(ens[1], single[1], rtol=1e-6, atol=0.0)
    assert torch.equal(g1, g2)
    assert counts["xgate"] == 2 and counts["attn_lstm"] == 2 * 10 and counts["topk_tail"] == 0


def test_diverse_beam_kernels_match_plain_path(dev):
    """Beam 6 in 3 groups, f32: the kernels (K1-K3, no top-K tail) against
    the plain path; G = 1 gives the plain beam's tokens."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels

    p = a9_model(dev)
    app, mot = a9_inputs(dev)
    fn = lambda g: make_beam_caption_fn(6, 8, 10, diversity_groups=g, diversity_penalty=0.5,
                                        early_stop=False)(p, app, mot)[0]
    with precision("float32"):
        kernels.reset_launch_counts()
        tokens = fn(3)
        counts = kernels.launch_counts()
        try:
            set_fused_kernels(False)
            ptokens = fn(3)
        finally:
            set_fused_kernels(None)
        assert torch.equal(fn(1), fn(0))
    assert (tokens == ptokens).all(1).float().mean().item() >= 0.875
    assert counts["attn_lstm"] == 10 and counts["xgate"] == 1 and counts["topk_tail"] == 0


def test_sequence_logprob_matches_the_kernels_nbest_scores(dev):
    """The n-best of beam 5 through K3 rescored by the plain teacher-forced
    decoder, f32: the beam's own scores within rtol 1e-4, lengths equal."""
    from controllable_xgating_torch.data.vocab import PAD
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.score import make_sequence_scorer

    p = a9_model(dev)
    app, mot = a9_inputs(dev)
    with precision("float32"):
        toks, scores, _ = make_beam_caption_fn(5, 8, 10, return_all=True)(p, app, mot)
        b, k, L = toks.shape
        rep = lambda x: x.repeat_interleave(k, dim=0)
        lp, n = make_sequence_scorer(8)(p, rep(app), rep(mot), None, toks.reshape(b * k, L))
    torch.testing.assert_close(lp.reshape(b, k), scores, rtol=1e-4, atol=0.0)
    assert torch.equal(n.reshape(b, k), (toks != PAD).sum(-1))
