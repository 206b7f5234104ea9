"""Free-run psi (POS-sequence) diversity probe for a trained checkpoint.

The corpus-v3 study's mechanism readout: for each test video, free-run
the POS generator (what `encode_for_inference(pos_tags=None)` does at
eval and serve time) and report how many DISTINCT tag sequences it emits
plus the most common ones. A healthy psi tracks the per-video syntax; a
collapsed psi emits a handful of templates.

  python -m controllable_xgating_torch.tools.psi_diversity --checkpoint_dir CK \\
      [--data_dir D] [--split test] [--limit 128] [--device cpu]

Counterpart of the JAX package's `tools/psi_diversity.py`, with its flags
and JSON, `--device` in place of `--platform`. The checkpoint's saved
model config sizes the model; as in the reference, the rollout runs
without frame masks. On the card the rollout is the POS generator's
kernel (K2, `PosRolloutLoop`, on replayed CUDA graphs) after the fusion
kernel (K1, for an xgate checkpoint).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

import numpy as np
import torch


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--data_dir", default="data/grid_v3")
    p.add_argument("--split", default="test")
    p.add_argument("--limit", type=int, default=128)
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import (
        load_corpus,
        restore_params,
        runtime_device,
    )
    from controllable_xgating_torch.data.loader import eval_batches
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.ops.dispatch import fused_enabled
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.train.state import CheckpointManager
    from controllable_xgating_torch.utils.config import Config

    saved = CheckpointManager.load_infos(args.checkpoint_dir, "best")["config"]["model"]
    cfg = Config().replace_flat({f"model.{k}": v for k, v in saved.items()})
    device, dtype = runtime_device(args.device, None, cfg)  # bf16 on the card, f32 on the CPU
    info, _, store, cfg = load_corpus(args.data_dir, cfg)
    idx = np.asarray(info.splits[args.split])[: args.limit]

    seqs = []
    with precision(dtype):
        # restored outside inference mode, as the controllability study's: the
        # rollout's CUDA graphs write buffers made from the parameters
        params = restore_params(args.checkpoint_dir, cfg, device)
        for batch in eval_batches(store, idx, 64):
            app, motion = (torch.as_tensor(batch[k], device=device) for k in ("app", "motion"))
            with torch.inference_mode():
                _, _, tags = encode_for_inference(params, app, motion, pos_tags=None,
                                                  max_pos_len=cfg.model.max_pos_len,
                                                  fused=fused_enabled(None))
            t = tags.cpu().numpy()
            for row in range(batch["num_valid"]):
                seqs.append(" ".join(info.pos_vocab.decode(t[row])))
    c = Counter(seqs)
    print(json.dumps({
        "checkpoint": args.checkpoint_dir,
        "videos": len(seqs),
        "distinct_tag_sequences": len(c),
        "top": [{"n": n, "tags": s} for s, n in c.most_common(args.top)],
    }, indent=2))


if __name__ == "__main__":
    main()
