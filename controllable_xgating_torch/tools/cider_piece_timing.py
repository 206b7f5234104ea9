"""Sub-piece timing of `cider_d_device`, the SCST reward.

Counterpart of the JAX package's `tools/cider_piece_timing.py`, with its
flags and JSON report and `--device` in place of the platform. It times
the pieces inside one reward call and the one-call alternative:

  whole:   two_calls_B (two [B] calls, as `scst_loss` makes them) and
           one_call_2B (one call over both candidate sets)
  pieces:  ref_gather (the six per-video reference gathers), cand_hash,
           idf_lookup (the bucketed bisection), self_tf, match_dot (the
           [B, S, 4, Lc, L] equality, clip and dot reduction)

on reward tables of B videos x 20 seeded captions of 28 tokens (df over
the B videos) and seeded candidates, by `utils/timing.py::make_timed`:
`timings_ms` is the sustained ms per call (the module docstring there
says what that is on the card) and `device_ms` the device time of one
call under `torch.profiler`.

    python -m controllable_xgating_torch.tools.cider_piece_timing [--batch 256]
        [--reps 2,8] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given; a CPU
run times PyTorch's CPU kernels, not the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

L = 28
REFS = 20


def make_inputs(batch: int, seed: int = 11):
    """(caps [B, 20, L], ncaps [B], cand [B, L]) numpy draws, bit for bit
    the JAX tool's."""
    rng = np.random.default_rng(seed)
    ncaps = np.full((batch,), REFS, np.int64)
    caps = np.zeros((batch, REFS, L), np.int32)
    caps[:, :, 0] = 1
    caps[:, :, 1:-1] = rng.integers(4, 10000, (batch, REFS, L - 2))
    caps[:, :, -1] = 2
    cand = np.zeros((batch, L), np.int32)
    cand[:, :-1] = rng.integers(4, 10000, (batch, L - 1))
    cand[:, -1] = 2
    return caps, ncaps, cand


def _fold(x: torch.Tensor) -> torch.Tensor:
    return (x.sum() % 7).float() * 1e-6


def perturb(c, x):
    """A data-dependent no-op: (c > 1e30) is false, but read from the carry."""
    return x + (c > 1e30).to(x.dtype)


def two_calls(tables, cand, vidx):
    from controllable_xgating_torch.ops.cider_device import cider_d_device

    return cider_d_device(tables, cand, vidx), cider_d_device(tables, cand.flip(0), vidx)


def one_call(tables, cand, vidx):
    from controllable_xgating_torch.ops.cider_device import cider_d_device

    return cider_d_device(tables, torch.cat([cand, cand.flip(0)]), torch.cat([vidx, vidx]))


REF_FIELDS = ("ref_h1", "ref_h2", "ref_valid", "ref_tf", "ref_idf", "ref_norm")


def ref_gather(tables, v):
    """The six per-video reference statistics a reward call gathers."""
    return [getattr(tables, f)[v] for f in REF_FIELDS]


def match_dot(ch1, ch2, cv, rh1, rh2, rv, rtf, ridf):
    eq = ((ch1[:, None, :, :, None] == rh1[:, :, :, None, :])
          & (ch2[:, None, :, :, None] == rh2[:, :, :, None, :])
          & cv[:, None, :, :, None] & rv[:, :, :, None, :])
    c_in_r = eq.sum(3).float()
    return (torch.minimum(c_in_r, rtf) * ridf * ridf).sum(-1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", default="2,8")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.ops import cider_device as cd
    from controllable_xgating_torch.utils import timing
    from controllable_xgating_torch.utils.config import Config

    dev, _ = runtime_device(args.device, None, Config())
    b = args.batch
    reps = tuple(int(r) for r in args.reps.split(","))
    caps, ncaps, cand_np = make_inputs(b)
    tables = cd.build_reward_tables(caps, ncaps, list(range(b)), device=dev)
    cand = torch.as_tensor(cand_np, device=dev)
    vidx = torch.arange(b, dtype=torch.int32, device=dev)

    timings: dict = {}
    detail: dict = {}
    timed = timing.make_timed(timings, dev, reps, tag="cider", detail=detail)

    timed("two_calls_B", lambda c, cand: _fold(sum(r.sum() for r in two_calls(
        tables, perturb(c, cand), vidx))), cand)
    timed("one_call_2B", lambda c, cand: _fold(one_call(tables, perturb(c, cand), vidx)), cand)
    timed("ref_gather", lambda c, v: _fold(sum(r.sum() for r in ref_gather(
        tables, perturb(c, v).long()))), vidx)
    timed("cand_hash", lambda c, cand: _fold(sum(
        h.sum() for h in cd._device_hashes(perturb(c, cand))[:2])), cand)

    with torch.no_grad():
        ch1, ch2, cv = cd._device_hashes(cand)
    timed("idf_lookup", lambda c, h1: _fold(cd._idf_lookup(tables, perturb(c, h1), ch2, cv)), ch1)
    timed("self_tf", lambda c, h1: _fold(cd._self_tf(perturb(c, h1), ch2, cv)), ch1)

    refs = ref_gather(tables, vidx.long())[:5]
    c1, c2 = cd._as_int32(ch1), cd._as_int32(ch2)
    timed("match_dot", lambda c, h1: _fold(match_dot(perturb(c, h1), c2, cv, *refs)), c1)

    report = {
        "batch": b,
        "device": timing.device_name(dev),
        "df_table_size": int(tables.table_rows.shape[0]),
        "timings_ms": timings,
        "device_ms": {k: d["device_ms"] for k, d in detail.items()},
        "launches": {k: d["launches"] for k, d in detail.items()},
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
