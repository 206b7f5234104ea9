#!/usr/bin/env python3
"""Convert a checkpoint slot of the JAX package (orbax) into the PyTorch
port's slot (`<name>.pt` + `<name>.infos.json`).

    python convert_jax_checkpoint.py --checkpoint_dir checkpoints/joint \\
        --out checkpoints_torch/joint [--name best]

Restores slot `--name` of a checkpoint directory that the JAX package
wrote (its train, import or average tools) under the model config saved in
the slot's sidecar, with `controllable_xgating_tpu.train.state.CheckpointManager`'s
checks; flattens the parameters to numpy under their dotted paths
(`tools/import_torch_checkpoint.py::param_paths`); and writes them to the
port's slot of the same name through `controllable_xgating_torch.bridge.from_numpy`
and the port's `CheckpointManager`, with the JAX sidecar copied unchanged.
Every port CLI then restores the slot (`--checkpoint_dir OUT`).

Only the parameters are carried: the port's slot holds a fresh Adam state
at step 0, as the importer's does, so eval, caption, serve and
`cli.train --init_from` use it as they use any slot; training resumed from
a converted `last` slot starts its Adam moments anew.

This script imports JAX and orbax, so it runs where the JAX package is
installed, never on the card's machine (which has neither): convert there,
then copy OUT to the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def convert(checkpoint_dir: str, out: str, name: str = "best") -> dict:
    """JAX slot `name` of `checkpoint_dir` -> the port's slot `name` of
    `out`; returns the sidecar."""
    from controllable_xgating_tpu.cli.common import restore_params
    from controllable_xgating_tpu.train.state import CheckpointManager as JaxCheckpoints
    from controllable_xgating_tpu.utils.config import Config
    from controllable_xgating_torch import bridge
    from controllable_xgating_torch.train.state import CheckpointManager, create_train_state
    from tools.import_torch_checkpoint import param_paths

    infos = JaxCheckpoints.load_infos(checkpoint_dir, name)
    saved = (infos.get("config") or {}).get("model")
    if not saved:
        raise ValueError(f"checkpoint {name!r} in {checkpoint_dir!r} carries no model config "
                         "in its sidecar: the parameters' shapes are unknown")
    cfg = Config().replace_flat({f"model.{k}": v for k, v in saved.items()})
    params = restore_params(checkpoint_dir, cfg, name=name)
    tree = {path: np.asarray(leaf) for path, leaf in param_paths(params)}
    state = create_train_state(bridge.from_numpy(tree, cfg), cfg)
    CheckpointManager(out).save(name, state, infos)
    return infos


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", required=True, help="the JAX package's checkpoint dir")
    p.add_argument("--out", required=True, help="the port's checkpoint dir to write")
    p.add_argument("--name", default="best", help="the slot to convert (default: best)")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # the conversion is host work
    infos = convert(args.checkpoint_dir, args.out, args.name)
    print(json.dumps({"out": os.path.abspath(args.out), "name": args.name,
                      "epoch": infos.get("epoch"), "best_score": infos.get("best_score")}))


if __name__ == "__main__":
    main()
