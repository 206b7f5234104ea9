"""Multi-process data parallelism on `torch.distributed`.

Counterpart of `controllable_xgating_tpu/parallel/distributed.py`. The
PyTorch idiom is one process per card: process `r` of `n` holds a full
copy of the train state on its own device, takes rows
[r * B / n, (r + 1) * B / n) of every global batch (the loaders are
deterministic, so every process builds the same batch and no data is
exchanged), and joins the others in the train step's all-reduces
(`parallel/mesh.py::make_parallel_train_step`). Checkpoints, the val
eval and the logs are the primary's (`is_primary`); the early-stop
decision is broadcast from it (`broadcast_flag`).

`initialize_from_env()` keeps the JAX package's environment contract:

  CXG_COORDINATOR     host:port of process 0's rendezvous, or "auto"
                      (torchrun's MASTER_ADDR / MASTER_PORT / RANK /
                      WORLD_SIZE, which it also reads when CXG_COORDINATOR
                      is unset)
  CXG_NUM_PROCESSES   the number of processes
  CXG_PROCESS_ID      this process's rank
  LOCAL_RANK          the card this process takes (default: its rank)
  CXG_TIMEOUT_S       the collectives' timeout in seconds (DEFAULT_TIMEOUT_S)

The backend is NCCL for the card and gloo for the CPU, picked from the
device type the caller names; a backend that fails to start raises.
`launch` starts n local processes on a free localhost port, each joined
through the same variables.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from controllable_xgating_torch.utils.logging import get_logger

log = get_logger("cxg.parallel.distributed")

# The collectives' timeout. The peers of the primary wait in the next
# step's all-reduce while it runs the val eval and writes its checkpoints:
# an MSR-VTT val eval (497 videos, beam 5) takes seconds on the card and
# minutes on the CPU at full width, so 30 minutes leave a wide margin; a
# peer that died is reported by gloo and NCCL at once or at this timeout.
DEFAULT_TIMEOUT_S = 1800.0
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def timeout_s() -> float:
    return float(os.environ.get("CXG_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def initialize_from_env(device_type: str = "cuda", backend: str | None = None) -> bool:
    """Join the process group named by the environment (module docstring);
    else do nothing. Returns whether this process is in a process group.
    `backend` defaults to NCCL for `device_type` "cuda" and gloo for
    "cpu". Idempotent."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("CXG_COORDINATOR")
    if coord == "auto" or (not coord and "MASTER_ADDR" in os.environ
                           and "WORLD_SIZE" in os.environ):
        init, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    elif coord:
        init = f"tcp://{coord}"
        rank, world = int(os.environ["CXG_PROCESS_ID"]), int(os.environ["CXG_NUM_PROCESSES"])
    else:
        return False
    backend = backend or BACKENDS[device_type]
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s()))
    log.info("joined process group: process %d/%d over %s, %s", rank, world, backend,
             local_device(device_type))
    return True


def local_device(device_type: str) -> torch.device:
    """This process's device: the CPU, or `cuda:LOCAL_RANK` (default: the
    rank), which must exist."""
    if device_type != "cuda":
        return torch.device(device_type)
    index = int(os.environ.get("LOCAL_RANK", os.environ.get("CXG_PROCESS_ID", 0)))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} needs cuda:{index}, but this machine has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns side effects (checkpoints, eval, logs)."""
    return process_index() == 0


def process_slice(global_batch: int, group=None) -> slice:
    """Rows of the global batch this process feeds. Requires divisibility."""
    n = process_count(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    i = process_index(group)
    return slice(i * per, (i + 1) * per)


def shard_process_local_batch(batch: dict, group=None) -> dict:
    """This process's rows of a host batch every process holds alike: the
    train loop's put function under data parallelism, before
    `data/features.py::DevicePut` copies the rows to this process's card
    (JAX `shard_process_local_batch`, which lifts them into a global
    array instead)."""
    n = next(len(v) for v in batch.values() if v is not None)
    sl = process_slice(n, group)
    return {k: None if v is None else v[sl] for k, v in batch.items()}


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict().items():
            yield name, t
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            for name, t in _leaves(x):
                yield f"{i}.{name}", t
    elif isinstance(tree, torch.Generator):
        yield "gen", tree.get_state()
    else:
        yield "", tree


def fingerprint(tree) -> int:
    """blake2b over every leaf's name, dtype, shape and bytes (modules'
    state dicts, tensors, generators' states, numbers)."""
    h = hashlib.blake2b(digest_size=8)
    for name, leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(f"{name}:{arr.dtype}:{arr.shape}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return int.from_bytes(h.digest(), "little")


def assert_same_across_processes(tree, what: str = "state", group=None) -> None:
    """Raise if the processes hold different copies of `tree` (for
    example (params, step, generator)).

    Guards the resume path: without shared storage one process can restore
    a checkpoint while a peer starts fresh, and the processes would then
    train different models without a word. The fingerprints
    (`fingerprint`) are all-gathered as int64 and compared."""
    n = process_count(group)
    if n <= 1:
        return
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    mine = torch.tensor([fingerprint(tree) - 2 ** 63], dtype=torch.int64, device=device)
    fps = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(fps, mine, group=group)
    fps = [int(f.item()) + 2 ** 63 for f in fps]
    if len(set(fps)) > 1:
        raise RuntimeError(
            f"processes disagree on {what} (fingerprints {fps}): most likely one process "
            "restored a checkpoint another could not see. Multi-host resume requires "
            "checkpoint_dir on shared storage visible to every process."
        )


def replicate_to_global(tree, group=None):
    """Every process already holds its copy of `tree` (the same seed, or
    the same checkpoint): assert that the copies are the same and return
    `tree`. Nothing is moved (JAX lifts the copies into global arrays)."""
    assert_same_across_processes(tree, "replicated state", group)
    return tree


def broadcast_flag(flag: bool, group=None, src: int = 0) -> bool:
    """The primary's `flag` on every process (the early-stop decision,
    without which the peers would wait in the next step's all-reduce)."""
    if process_count(group) <= 1:
        return bool(flag)
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.broadcast(t, src=src, group=group)
    return bool(t.item())


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the group's processes, in place (unchanged without
    a group)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def rank_and_count(group) -> tuple:
    """(rank, processes) of this process in `group`; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# ------------------------------------------------------------- local launch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, args_path: str, rank: int, n: int, port: int, device_type: str, backend,
                timeout, env: dict, results) -> None:
    os.environ.update(env)  # before CUDA reads it (CUDA_VISIBLE_DEVICES)
    os.environ.update({
        "CXG_COORDINATOR": f"127.0.0.1:{port}", "CXG_NUM_PROCESSES": str(n),
        "CXG_PROCESS_ID": str(rank), "CXG_TIMEOUT_S": str(timeout),
        # ranks beyond the cards share them in turn (gloo takes that; NCCL
        # refuses two ranks on one card)
        "LOCAL_RANK": str(rank % max(torch.cuda.device_count(), 1)
                          if device_type == "cuda" else rank),
    })
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    try:  # an exception exits the process non-zero, with its traceback
        initialize_from_env(device_type, backend)
        results.put((rank, fn(*args)))
    finally:
        shutdown()


def launch(fn, nprocs: int, args: tuple = (), device_type: str = "cpu", backend=None,
           timeout: float | None = None, env: dict | None = None) -> list:
    """Run `fn(*args)` as ranks 0 .. nprocs - 1 of one process group on
    this machine and return their results in rank order.

    Each rank is a fresh `spawn` process, joined through the CXG_*
    variables on a free localhost port (the backend from `device_type`,
    unless given); `fn` must be importable, and its arguments and result
    picklable; `env` is set in each rank's environment first (for
    example CUDA_VISIBLE_DEVICES=0: the ranks share the first card, while
    this process keeps its view of the cards). The arguments go through a
    file in a temporary directory,
    not through the start-up pipe: a rank that dies while starting would
    leave a parent blocked writing a large pickle into it. The
    collectives time out after `timeout` seconds (default
    `CXG_TIMEOUT_S`). A rank that fails, or a run past twice the timeout,
    terminates the others and raises RuntimeError: no rank waits for a
    dead peer."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cxg-launch-") as tmp:
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        return _run_ranks(fn, args_path, nprocs, device_type, backend,
                          float(timeout or timeout_s()), dict(env or {}))


def _run_ranks(fn, args_path: str, nprocs: int, device_type: str, backend,
               timeout: float, env: dict) -> list:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=False,
                         args=(fn, args_path, r, nprocs, port, device_type, backend, timeout,
                               env, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    limit = 2 * timeout + 60
    deadline = time.monotonic() + limit
    try:
        while len(out) < nprocs:
            while not results.empty():
                rank, value = results.get()
                out[rank] = value
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0) and r not in out]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {nprocs} exited with code "
                                   f"{failed[0][1]}")
            if all(p.exitcode == 0 for p in procs) and len(out) < nprocs and results.empty():
                raise RuntimeError(f"{nprocs - len(out)} ranks exited without a result")
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks still running after {limit:.0f} s")
            time.sleep(0.05)
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [out[r] for r in range(nprocs)]
