"""Import PyTorch `.pth` weights of the reference into the port's checkpoint
format.

Migration path for users of the reference codebase (vsislab/
Controllable_XGating trains with torch.save): bring a trained
`model-best.pth` over instead of retraining. The reference's parameter
names cannot be verified here, so the importer is mapping-driven: the user
supplies a JSON file mapping the framework's parameter paths to the torch
state_dict keys, with an optional per-entry transform for layout
differences (torch nn.Linear stores [out, in]; the framework's matmuls are
[in, out]).

  # 1. see what needs mapping (dotted paths + shapes)
  python -m controllable_xgating_torch.tools.import_torch_checkpoint --data_dir D --dump_template

  # 2. write mapping.json:
  #    {"encoder.xgate.wa": {"key": "encoder.app_embed.weight",
  #                          "transform": "transpose"},
  #     "decoder.b_out": "logit.bias", ...}

  # 3. import -> a 'best' slot (.pt + .infos.json) usable by every CLI
  python -m controllable_xgating_torch.tools.import_torch_checkpoint --data_dir D \\
      --pth model-best.pth --mapping mapping.json --out checkpoints/imported

Partial imports (`--allow_missing`) keep fresh-initialized values for
unmapped parameters — e.g. to transplant only the encoder.

Counterpart of the JAX package's `tools/import_torch_checkpoint.py`: the
same flags, template (the paths in the JAX tree's order, so a mapping
written for the JAX tool works unchanged), transforms and errors; the
slot is the port's `CheckpointManager` format with the corpus config in
its sidecar. Host code only: it touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from controllable_xgating_torch import bridge

TRANSFORMS = {
    "none": lambda a: a,
    "transpose": lambda a: a.T,
}


def load_state_dict(path: str, unsafe_pickle: bool = False) -> dict:
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        # weights_only rejects checkpoints whose wrapper dict pickles
        # arbitrary objects (the reference era saved `infos` alongside).
        # Full unpickling executes code from the file, so it is opt-in:
        # a malicious third-party .pth otherwise gets code execution here.
        if not unsafe_pickle:
            raise ValueError(
                f"{path}: not loadable with torch weights_only=True ({e}). "
                "If you trust this checkpoint's origin, re-run with "
                "--unsafe_pickle to allow full unpickling (this executes "
                "code embedded in the file)."
            ) from e
        print(
            f"warning: {path}: falling back to full unpickling "
            "(--unsafe_pickle); only do this for checkpoints you trust",
            file=sys.stderr,
        )
        obj = torch.load(path, map_location="cpu", weights_only=False)
    # the reference era saved either the raw state_dict or a wrapper dict
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state_dict-like checkpoint")
    return {k: v for k, v in obj.items() if hasattr(v, "numpy")}


def import_params(template, state_dict: dict, mapping: dict, allow_missing: bool = False):
    """Fill `template` (`CaptionerParams`, in place) from the mapped torch
    tensors -> (template, report). Raises on unknown paths, missing keys
    and shape mismatches."""
    flat = bridge.param_paths(template)
    known = {name for name, _ in flat}
    unknown = [k for k in mapping if k not in known]
    if unknown:
        raise ValueError(
            f"mapping refers to unknown parameter paths {unknown[:5]}; "
            "run --dump_template for the valid list"
        )
    new, imported, missing = {}, [], []
    for name, leaf in flat:
        entry = mapping.get(name)
        if entry is None:
            missing.append(name)
            continue
        if isinstance(entry, str):
            key, transform = entry, "none"
        else:
            key, transform = entry["key"], entry.get("transform", "none")
        if key not in state_dict:
            raise KeyError(
                f"{name}: torch key {key!r} not in the checkpoint "
                f"(has {sorted(state_dict)[:5]}...)"
            )
        if transform not in TRANSFORMS:
            raise ValueError(f"{name}: unknown transform {transform!r}")
        arr = TRANSFORMS[transform](np.asarray(state_dict[key].numpy()))
        if arr.shape != leaf.shape:
            raise ValueError(
                f"{name}: shape {arr.shape} (after {transform}) != expected "
                f"{leaf.shape} — wrong key or missing transform?"
            )
        new[name] = arr.astype(leaf.dtype)
        imported.append(name)
    if missing and not allow_missing:
        raise ValueError(
            f"{len(missing)} parameters unmapped (e.g. {missing[:5]}); "
            "map them or pass --allow_missing to keep fresh-initialized "
            "values for them"
        )
    with torch.no_grad():
        for name, p in template.named_parameters():
            if name in new:
                p.copy_(torch.from_numpy(new[name]))
    return template, {"imported": imported, "kept_initialized": missing}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True,
                   help="corpus dir (sizes the model: dims + vocab)")
    p.add_argument("--dump_template", action="store_true",
                   help="print parameter paths + shapes and exit")
    p.add_argument("--pth", help="torch checkpoint to import")
    p.add_argument("--mapping", help="JSON {our.path: torch_key | {key, transform}}")
    p.add_argument("--out", help="output checkpoint dir (writes 'best')")
    p.add_argument("--allow_missing", action="store_true")
    p.add_argument("--unsafe_pickle", action="store_true",
                   help="permit full (code-executing) unpickling when "
                        "torch weights_only=True cannot load the file")
    p.add_argument("--seed", type=int, default=0, help="init seed for unmapped params")
    args, overrides = p.parse_known_args(argv)

    from controllable_xgating_torch.cli.common import load_corpus
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.state import CheckpointManager, create_train_state
    from controllable_xgating_torch.utils.config import load_config, parse_cli_overrides

    cfg = load_config(None, parse_cli_overrides(overrides))
    _, _, _, cfg = load_corpus(args.data_dir, cfg)
    template = init_captioner(cfg, seed=args.seed, device="cpu")

    if args.dump_template:
        for name, leaf in bridge.param_paths(template):
            print(json.dumps({"path": name, "shape": list(leaf.shape)}))
        return
    if not (args.pth and args.mapping and args.out):
        p.error("--pth, --mapping and --out are required (or --dump_template)")

    with open(args.mapping) as f:
        mapping = json.load(f)
    state_dict = load_state_dict(args.pth, unsafe_pickle=args.unsafe_pickle)
    params, report = import_params(template, state_dict, mapping,
                                   allow_missing=args.allow_missing)

    state = create_train_state(params, cfg)
    CheckpointManager(args.out).save("best", state, {
        "imported_from": os.path.abspath(args.pth),
        # best_score=None (json null, NOT NaN — bare NaN is invalid JSON
        # and breaks strict parsers): no eval has scored these weights yet
        "epoch": -1, "step": 0, "best_score": None,
        "config": cfg.to_dict(),
    })
    print(json.dumps({
        "out": args.out,
        "imported": len(report["imported"]),
        "kept_initialized": len(report["kept_initialized"]),
    }))


if __name__ == "__main__":
    main()
