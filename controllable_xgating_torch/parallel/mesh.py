"""Data parallelism over the devices of one process, and the data-parallel
train step (BASELINE.json config 5).

Counterpart of `controllable_xgating_tpu/parallel/mesh.py`. The JAX
package shards a batch over a 1-D `jax.sharding.Mesh` and lets XLA insert
the gradient all-reduce. The port keeps the two uses apart:

  * decoding (`infer/evaluator.py`, `serve/engine.py`) runs in one
    process over a `Mesh`, a tuple of devices: every batch is split into
    contiguous, equal blocks of rows, one per device, each decoded by the
    library calls (K1-K4 and the decode graphs) on its device's copy of
    the parameters, and the results come back in row order. A mesh may
    name a device twice (`[cpu] * 4` in the CPU tests, `[cuda:0] * 2` on a
    one-card machine): its blocks then run in turn on that device;
  * training runs one process per device (`parallel/distributed.py`):
    the train loop puts this process's rows of each global batch on its
    device (`distributed.shard_process_local_batch`, then
    `data/features.py::DevicePut`), and `make_parallel_train_step` feeds
    them to a step with the process group, over which the step
    all-reduces the non-PAD counts and the gradients itself
    (`train/xe.py`, `train/scst.py`).
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D data-parallel mesh and its axis name
    (`parallel.mesh_axis`)."""

    devices: tuple
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(num_devices: int = 0, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """The first `num_devices` (0: all) of `devices`, by default the
    visible cards `cuda:0 .. cuda:<count - 1>`. Raises `need N devices,
    have M` when they are short. `devices` may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if num_devices:
        if len(devices) < num_devices:
            raise ValueError(f"need {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("need 1 devices, have 0")
    return Mesh(tuple(devices), axis)


def device_scope(device: torch.device):
    """`device` current where it is a card (the kernels launch on the
    current device, and raise its shared memory limits there); nothing on
    the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_rows(rows: int, mesh: Mesh) -> list:
    """The contiguous, equal blocks of `rows` rows, one slice per device
    (JAX `batch_sharding`); raises where they do not divide."""
    if rows % mesh.size:
        raise ValueError(f"batch of {rows} rows not divisible by the {mesh.size}-device mesh")
    per = rows // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """A batch {name: array or tensor or None} -> one dict per device of
    its block of rows, as tensors on that device (None stays None)."""
    n = next(len(v) for v in batch.values() if v is not None)
    return [{k: None if v is None else torch.as_tensor(v[sl]).to(dev)
             for k, v in batch.items()}
            for sl, dev in zip(shard_rows(n, mesh), mesh.devices)]


def replicate(params, mesh: Mesh) -> dict:
    """{device: params there}: one copy per distinct device of the mesh,
    the parameters themselves on the device that already holds them.
    `params` is a module or an ensemble's tuple of members."""
    if isinstance(params, (tuple, list)):
        members = [replicate(p, mesh) for p in params]
        return {d: tuple(m[d] for m in members) for d in members[0]}
    home = next(params.parameters()).device
    return {d: params if d == home else copy.deepcopy(params).to(d)
            for d in dict.fromkeys(mesh.devices)}


def make_parallel_train_step(step: Callable, group=None) -> Callable:
    """(state, this process's rows of a global batch) -> step(state, rows,
    group=group) (JAX `make_parallel_train_step`, `:61`).

    The rows come from `distributed.shard_process_local_batch`, the
    train loop's put function (JAX `cli/train.py:146`; `train/loop.py`
    prefetches them onto this process's card). `step` is one of
    `make_xe_train_step` / `make_scst_train_step`'s: given a process group
    it computes the loss of the global batch, all-reducing the non-PAD
    counts before the loss and the gradients (SUM) before the global-norm
    clip and Adam, so every process applies the one-device step's update.
    Every process draws the same host batch (the loaders are
    deterministic). `group` None is the default group of
    `torch.distributed`, which must be initialised."""
    group = group or torch.distributed.group.WORLD

    def parallel_step(state, rows: dict):
        return step(state, rows, group=group)

    return parallel_step
