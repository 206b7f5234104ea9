"""Train steps on one process of a data-parallel run, and a dry run of
one full XE step over n local processes.

Counterpart of `__graft_entry__.py::dryrun_multichip`. `train_steps` is
what each rank of `parallel/distributed.py::launch` runs (and, outside a
process group, the one-device reference it is held against): the tests
on the CPU and on the card compare the two.

    python -m controllable_xgating_torch.parallel.dryrun [--ranks 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from controllable_xgating_torch import bridge
from controllable_xgating_torch.data.features import DevicePut, PrefetchIterator, put_now
from controllable_xgating_torch.parallel import distributed
from controllable_xgating_torch.parallel.mesh import make_parallel_train_step


def train_steps(params_tree: dict, cfg, batches: list, stage: str = "joint",
                device_type: str = "cpu", policy: str = "float32", scst=None,
                timed: int = 0) -> dict:
    """Steps from the weights `params_tree` ({dotted name: array}, or a
    seed of `init_captioner`; a fresh Adam and `train.seed`'s generator),
    one per global host batch of
    `batches`: in a process group, the data-parallel step on this
    process's rows (`make_parallel_train_step`); outside one, the
    one-device step on the whole batch. XE of `stage`, or SCST with `scst`
    = (reference caps [N, S, L], ncaps [N], train video indices), whose
    reward tables every process builds alike.

    The batches go through the train loop's prefetch
    (`data/features.py::PrefetchIterator` at `data.num_prefetch`, the
    put `DevicePut` after, in a group, `shard_process_local_batch`).

    Returns {"metrics": [{name: float} per step], "params": {name: f32
    numpy}, "launches": the kernel wrappers' launches in those steps,
    "device": str}; with `timed` > 0 also "step_ms" (host clock of
    `timed` more steps on the last batch, each put anew on the calling
    thread, synchronised, per step: the put's copy is inside the span),
    "allreduce_ms" (one all-reduce of the gradients' flat buffer, median
    of 5, 0 without a group) and "grad_bytes"."""
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer

    in_group = torch.distributed.is_initialized()
    dev = distributed.local_device(device_type) if in_group else torch.device(
        "cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    if isinstance(params_tree, int):
        from controllable_xgating_torch.models.captioner import init_captioner

        params = init_captioner(cfg, seed=params_tree, device=dev)
    else:
        params = bridge.from_numpy(params_tree, cfg).to(dev)
    state = create_train_state(params, cfg)
    tx = make_optimizer(cfg, 10, stage="joint" if scst else stage)
    if scst is None:
        from controllable_xgating_torch.train.xe import make_xe_train_step

        step = make_xe_train_step(tx, cfg, stage=stage)
    else:
        from controllable_xgating_torch.ops.cider_device import build_reward_tables
        from controllable_xgating_torch.train.scst import make_scst_train_step

        caps, ncaps, train_idx = scst
        step = make_scst_train_step(tx, cfg, build_reward_tables(
            np.asarray(caps), np.asarray(ncaps), list(train_idx), device=dev))
    put = DevicePut(dev)
    put_fn = put
    if in_group:
        step = make_parallel_train_step(step)
        put_fn = lambda b: put(distributed.shard_process_local_batch(b))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out: dict = {"metrics": [], "device": str(dev)}
    with precision(policy):
        kernels.reset_launch_counts()
        with PrefetchIterator(iter(batches), put_fn, cfg.data.num_prefetch) as staged:
            for batch in staged:
                _, m = step(state, batch)
                out["metrics"].append({k: float(v) for k, v in m.items()})
        sync()
        out["launches"] = kernels.launch_counts()
        if timed:
            t0 = time.perf_counter()
            for _ in range(timed):
                step(state, put_now(put_fn, batches[-1]))
            sync()
            out["step_ms"] = (time.perf_counter() - t0) / timed * 1e3
            n = sum(p.numel() for p in state.params.parameters())
            out["grad_bytes"] = 4 * n
            out["allreduce_ms"] = _allreduce_ms(n, dev, sync) if in_group else 0.0
    out["params"] = bridge.to_numpy(state.params)
    return out


def _allreduce_ms(n: int, dev, sync, reps: int = 5) -> float:
    flat = torch.ones(n, device=dev)
    times = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        distributed.all_reduce_sum(flat, torch.distributed.group.WORLD)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def tiny_setup(batch: int = 4, k: int = 2, seed: int = 0):
    """(config, weights {name: array}, one host batch) at tiny widths:
    captions of 2-6 words, so that the processes' rows differ in length."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.utils.config import Config

    t, length = 4, 8
    cfg = Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 8, "model.hidden_dim": 16,
        "model.embed_dim": 10, "model.attn_dim": 10, "model.pos_embed_dim": 10,
        "model.vocab_size": 30, "model.pos_vocab_size": 12, "model.num_frames": t,
        "model.max_caption_len": length, "model.max_pos_len": length, "model.dropout": 0.0,
        "data.batch_size": batch, "data.caps_per_video_train": k,
    })
    tree = bridge.to_numpy(init_captioner(cfg, seed=seed, device="cpu"))
    rng = np.random.default_rng(seed)

    def seqs(vocab):
        x = np.zeros((batch, k, length), np.int64)
        n = rng.integers(2, length - 1, (batch, k))
        for i in range(batch):
            for j in range(k):
                x[i, j, 0], x[i, j, n[i, j]] = 1, 2
                x[i, j, 1:n[i, j]] = rng.integers(4, vocab, n[i, j] - 1)
        return x

    host = {
        "app": rng.standard_normal((batch, t, 12)).astype(np.float32),
        "motion": rng.standard_normal((batch, t, 8)).astype(np.float32),
        "caps": seqs(30), "pos": seqs(12),
    }
    return cfg, tree, host


def dryrun(ranks: int = 2, device_type: str = "cpu") -> float:
    """One full XE step (loss, gradients, all-reduce, Adam) over `ranks`
    local processes at tiny widths; returns its loss (finite, and the same
    on every rank)."""
    cfg, tree, batch = tiny_setup(batch=2 * ranks)
    outs = distributed.launch(train_steps, ranks, (tree, cfg, [batch], "joint", device_type),
                              device_type=device_type)
    losses = [o["metrics"][0]["loss"] for o in outs]
    if not np.isfinite(losses[0]) or len(set(losses)) != 1:
        raise RuntimeError(f"dry run losses {losses}")
    return losses[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    print(json.dumps({"ranks": args.ranks, "loss": dryrun(args.ranks, args.device)}))


if __name__ == "__main__":
    main()
