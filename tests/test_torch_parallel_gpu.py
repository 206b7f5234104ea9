"""Data parallelism on the card (`controllable_xgating_torch/parallel/`).

Marked `gpu`: every test skips without a CUDA device.
  * one rank over NCCL equals the step without a process group bit for
    bit under f32 (the all-reduces of one rank change nothing);
  * two ranks on one card over gloo (which takes CUDA tensors) equal one
    rank on the global batch (loss rtol 1e-5; parameters rtol 2e-4, atol
    1e-5, the JAX package's bar), each rank launching the cross-entropy
    kernels (K5) once a step;
  * two cards over NCCL, the same: skipped below two cards;
  * a decode mesh of two entries on one card: each block's tokens equal
    the offline call at the block's batch, and a block's outputs are not
    overwritten by the next block's replay of the same decode graphs;
  * a decode mesh of two cards: each block equals the offline call on its
    card (skipped below two cards).
This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_gpu.py
"""

import numpy as np
import pytest
import torch

from controllable_xgating_torch.parallel import distributed, dryrun

pytestmark = pytest.mark.gpu
TIMEOUT = 120
STEPS = 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from controllable_xgating_torch.infer import graphs

    graphs.clear()
    return torch.device("cuda:0")


def setup(vocab: int = 2048):
    """Tiny widths at a vocab that takes K5 (V >= 2048), dropout 0.5."""
    cfg, _, _ = dryrun.tiny_setup(batch=8)
    cfg = cfg.replace_flat({"model.vocab_size": vocab, "model.dropout": 0.5})
    from controllable_xgating_torch import bridge
    from controllable_xgating_torch.models.captioner import init_captioner

    tree = bridge.to_numpy(init_captioner(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        caps = np.zeros((8, 2, 8), np.int64)
        for i in range(8):
            n = 2 if i < 4 else 6  # rank 0's rows short, rank 1's long
            caps[i, :, 0], caps[i, :, n + 1] = 1, 2
            caps[i, :, 1:n + 1] = rng.integers(4, vocab, (2, n))
        batches.append({
            "app": rng.standard_normal((8, 4, 12)).astype(np.float32),
            "motion": rng.standard_normal((8, 4, 8)).astype(np.float32),
            "caps": caps, "pos": np.minimum(caps, 11),
        })
    return cfg, tree, batches


def test_nccl_world_one_equals_no_process_group(dev):
    cfg, tree, batches = setup()
    want = dryrun.train_steps(tree, cfg, batches, device_type="cuda")
    (got,) = distributed.launch(dryrun.train_steps, 1, (tree, cfg, batches, "joint", "cuda"),
                                device_type="cuda", timeout=TIMEOUT)
    assert got["metrics"] == want["metrics"]
    for name in want["params"]:
        np.testing.assert_array_equal(got["params"][name], want["params"][name], err_msg=name)
    assert got["launches"]["xent_fwd"] == got["launches"]["xent_bwd"] == STEPS


def check_two_ranks(outs, want):
    for got in outs:
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        for name in want["params"]:
            np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=2e-4,
                                       atol=1e-5, err_msg=name)
        assert got["launches"]["xent_fwd"] == got["launches"]["xent_bwd"] == STEPS


def test_two_ranks_on_one_card_over_gloo_equal_one_rank(dev):
    cfg, tree, batches = setup()
    want = dryrun.train_steps(tree, cfg, batches, device_type="cuda")
    outs = distributed.launch(dryrun.train_steps, 2, (tree, cfg, batches, "joint", "cuda"),
                              device_type="cuda", backend="gloo", timeout=TIMEOUT,
                              env={"CUDA_VISIBLE_DEVICES": "0"})
    assert [o["device"] for o in outs] == ["cuda:0", "cuda:0"]
    check_two_ranks(outs, want)


def test_two_cards_over_nccl_equal_one_rank(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this machine has {torch.cuda.device_count()}")
    cfg, tree, batches = setup()
    want = dryrun.train_steps(tree, cfg, batches, device_type="cuda")
    outs = distributed.launch(dryrun.train_steps, 2, (tree, cfg, batches, "joint", "cuda"),
                              device_type="cuda", timeout=TIMEOUT)
    assert [o["device"] for o in outs] == ["cuda:0", "cuda:1"]
    check_two_ranks(outs, want)


def decode_setup(dev):
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner

    cfg, _, _ = dryrun.tiny_setup()
    cfg = cfg.replace_flat({"model.vocab_size": 64})
    params = init_captioner(cfg, seed=2, device=dev).requires_grad_(False)
    with torch.no_grad():
        params.decoder.w_out.mul_(5.0)  # peaked logits: captions differ by video
    rng = np.random.default_rng(3)
    app = rng.standard_normal((8, 4, 12)).astype(np.float32)
    mot = rng.standard_normal((8, 4, 8)).astype(np.float32)
    mask = np.ones((8, 4), np.float32)
    mask[5, 2:] = 0
    return params, make_beam_caption_fn(5, 8, 8), (app, mot, mask)


def test_mesh_blocks_equal_the_offline_call_at_the_block_batch(dev):
    from controllable_xgating_torch.infer.evaluator import sharded_call
    from controllable_xgating_torch.parallel.mesh import make_mesh, replicate

    params, fn, (app, mot, mask) = decode_setup(dev)
    mesh = make_mesh(devices=[dev, dev])
    tokens, tags = sharded_call(fn, replicate(params, mesh), mesh, app, mot, mask)
    for sl in (slice(0, 4), slice(4, 8)):
        put = lambda x: torch.as_tensor(x[sl], device=dev)
        want_tokens, want_tags = fn(params, put(app), put(mot), put(mask))
        assert torch.equal(tokens[sl], want_tokens.cpu())
        assert torch.equal(tags[sl], want_tags.cpu())


def test_mesh_over_two_cards_equals_the_offline_call_on_each(dev):
    """Each block on its own card, its kernels launched with that card
    current and their shared memory limits raised there (a second card
    starts from the default): the tokens of the offline call on the same
    block on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this machine has {torch.cuda.device_count()}")
    from controllable_xgating_torch.infer.evaluator import sharded_call
    from controllable_xgating_torch.parallel.mesh import device_scope, make_mesh, replicate

    params, fn, (app, mot, mask) = decode_setup(dev)
    mesh = make_mesh(2)
    reps = replicate(params, mesh)
    tokens, tags = sharded_call(fn, reps, mesh, app, mot, mask)
    for d, sl in zip(mesh.devices, (slice(0, 4), slice(4, 8))):
        with device_scope(d):
            want, want_tags = fn(reps[d], *(torch.as_tensor(x[sl], device=d)
                                            for x in (app, mot, mask)))
        assert torch.equal(tokens[sl], want.cpu()) and torch.equal(tags[sl], want_tags.cpu())


def test_repeated_device_mesh_keeps_each_blocks_outputs(dev):
    """Two blocks of one shape on one card share their decode graphs' keys
    and replay them in turn: the first block's outputs must survive the
    second's replay (the loops return clones of the static buffers)."""
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.infer.evaluator import sharded_call
    from controllable_xgating_torch.parallel.mesh import make_mesh, replicate

    params, fn, (app, mot, mask) = decode_setup(dev)
    mesh = make_mesh(devices=[dev, dev])
    reps = replicate(params, mesh)
    sharded_call(fn, reps, mesh, app, mot, mask)  # captures
    tokens, _ = sharded_call(fn, reps, mesh, app, mot, mask)
    assert len(graphs.cache_info()) >= 1
    alone = [fn(params, *(torch.as_tensor(x[sl], device=dev) for x in (app, mot, mask)))[0].cpu()
             for sl in (slice(0, 4), slice(4, 8))]
    assert torch.equal(tokens[:4], alone[0]) and torch.equal(tokens[4:], alone[1])
    assert not torch.equal(alone[0], alone[1])
