"""Average ("soup") multiple trained checkpoints into one.

Post-hoc weight averaging: averaging the weights of runs trained from
different seeds — or interpolating an XE checkpoint with its SCST
fine-tune to trade CIDEr against fluency — often beats every individual
member at zero inference cost. All inputs must share one architecture
(the restore path's vocab, fusion and psi checks refuse the rest).

  python -m controllable_xgating_torch.tools.average_checkpoints --data_dir D \\
      --inputs ck/seed0:best ck/seed1:best --out ck/soup

  # 70/30 XE<->SCST interpolation
  python -m controllable_xgating_torch.tools.average_checkpoints --data_dir D \\
      --inputs ck/caption:best ck/scst:best --weights 0.7,0.3 --out ck/mix

Averaging is only meaningful for checkpoints that share a training
trajectory (fine-tunes of one init: XE<->SCST stages, an epoch window,
same-init runs differing in data order via `--data.shuffle_seed`).
Independently-initialized runs live in different loss basins and their
average is worse than every member; the tool does not try to detect this,
since the sidecars carry no init fingerprint.

Each input is `<checkpoint_dir>[:<name>]` (name defaults to `best`).
Architecture knobs are adopted from the FIRST input's saved config, so
ablation and scaled checkpoints average without re-passing flags;
explicit `--model.*` overrides still win. Writes a `best` slot with a
fresh Adam state, usable by every CLI (eval, caption, serve).

Counterpart of the JAX package's `tools/average_checkpoints.py`: the same
flags, arithmetic (float32, the members summed in order) and sidecar keys
(`averaged_from`, `weights`, `epoch: -1`, `best_score: null`). The JAX tool
defaults to `--platform cpu` because averaging is host arithmetic; here it
is always host arithmetic on CPU state dicts, so the tool takes no
`--device` and touches no card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from controllable_xgating_torch import bridge


def parse_inputs(specs: list[str]) -> list[tuple[str, str]]:
    from controllable_xgating_torch.cli.common import split_ckpt_spec

    return [split_ckpt_spec(spec) for spec in specs]


def average_params(trees: list[dict], weights) -> dict:
    """Weighted mean of {path: array} trees, accumulated in float32."""
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError(f"weights must be positive, got {weights}")
    w = (w / w.sum()).astype(np.float32)

    def mean(*leaves):
        acc = sum(wi * leaf.astype(np.float32) for wi, leaf in zip(w, leaves))
        return acc.astype(leaves[0].dtype)

    return {name: mean(*(t[name] for t in trees)) for name in trees[0]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True,
                   help="corpus dir (sizes the model: dims + vocab)")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="two or more '<ckpt_dir>[:<name>]' (name: best)")
    p.add_argument("--out", required=True, help="output checkpoint dir (writes 'best')")
    p.add_argument("--weights", default=None,
                   help="comma list, one per input (default: equal)")
    args, overrides = p.parse_known_args(argv)

    inputs = parse_inputs(args.inputs)
    if len(inputs) < 2:
        p.error("--inputs needs at least two checkpoints to average")
    if args.weights is not None:
        weights = [float(x) for x in args.weights.split(",")]
        if len(weights) != len(inputs):
            p.error(f"{len(weights)} weights for {len(inputs)} inputs")
    else:
        weights = [1.0] * len(inputs)

    from controllable_xgating_torch.cli.common import adopt_ckpt_model_config, load_corpus
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.state import CheckpointManager, create_train_state
    from controllable_xgating_torch.utils.config import load_config, parse_cli_overrides

    # first input's architecture, then explicit --model.* overrides on top
    cfg = load_config(None, {})
    cfg = adopt_ckpt_model_config(inputs[0][0], cfg, inputs[0][1])
    cfg = cfg.replace_flat(parse_cli_overrides(overrides))
    _, _, _, cfg = load_corpus(args.data_dir, cfg)

    trees, sources = [], []
    for d, name in inputs:
        mgr = CheckpointManager(d)
        if not mgr.exists(name):
            raise FileNotFoundError(f"no checkpoint named {name!r} under {d!r}")
        # the restore cross-checks vocab / fusion / pos_guidance against the
        # run's config, so a member trained with another architecture fails
        # loudly here instead of silently polluting the average
        params = init_captioner(cfg, seed=None, device="cpu")
        infos = mgr.restore_params(name, params)
        trees.append(bridge.to_numpy(params))
        sources.append({"dir": os.path.abspath(d), "name": name,
                        "epoch": infos.get("epoch"),
                        "best_score": infos.get("best_score")})

    averaged = average_params(trees, weights)
    out_params = init_captioner(cfg, seed=None, device="cpu")
    with torch.no_grad():
        for name, t in out_params.named_parameters():
            t.copy_(torch.from_numpy(averaged[name]))
    norm = np.asarray(weights, np.float64) / np.sum(weights)
    CheckpointManager(args.out).save("best", create_train_state(out_params, cfg), {
        "averaged_from": sources,
        "weights": list(norm),
        # best_score=None: no eval has scored the averaged weights yet
        "epoch": -1, "step": 0, "best_score": None,
        "config": cfg.to_dict(),
    })
    print(json.dumps({
        "out": args.out,
        "n_inputs": len(inputs),
        "weights": [round(float(w), 6) for w in norm],
        "sources": sources,
    }))


if __name__ == "__main__":
    main()
