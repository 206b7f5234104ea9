"""Train the captioner: with cross-entropy, the POS generator (`pos`), the
captioner with the POS branch frozen (`caption`) or both (`joint`); or
fine-tune it with self-critical sequence training (`scst`, the CIDEr-D
reward on the device, the POS branch frozen). Checkpoints (`best`,
`last`) and `train_log.jsonl` go to `<checkpoint_dir>/<stage>/`; a run
resumes from that directory's `last`. `train.scst_start_epoch` N >= 0
switches a `caption` or `joint` run to SCST after N epochs, with the same
parameters, optimizer state and step.

Counterpart of `controllable_xgating_tpu/cli/train.py` on one device. A
fresh start draws its weights with the port's
`init_captioner(cfg, seed=train.seed)`, which are not the JAX package's
for the same seed (another random stream), and SCST's samples are not
JAX's either; `--init_from` starts from a checkpoint's `best` with a
fresh optimizer.

  python -m controllable_xgating_torch.cli.train --data_dir D --stage pos
  python -m controllable_xgating_torch.cli.train --data_dir D --stage caption \\
      --init_from checkpoints/pos
  python -m controllable_xgating_torch.cli.train --data_dir D --stage scst \\
      --init_from checkpoints/caption
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from controllable_xgating_torch.cli.common import (
    apply_runtime_flags,
    base_parser,
    die,
    load_corpus,
    parse_with_overrides,
    restore_or_init,
    restore_params,
)
from controllable_xgating_torch.data.loader import TrainBatchIterator
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.train.loop import train_loop
from controllable_xgating_torch.train.scst import build_scst_reward_tables, make_scst_train_step
from controllable_xgating_torch.train.state import (
    CheckpointManager,
    create_train_state,
    make_optimizer,
)
from controllable_xgating_torch.train.xe import make_xe_train_step
from controllable_xgating_torch.utils.logging import JsonlLogger, get_logger

log = get_logger("cxg.cli.train")


def main(argv=None) -> None:
    p = base_parser(__doc__)
    p.add_argument("--stage", default="joint", choices=("pos", "caption", "joint", "scst"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--init_from", default=None,
                   help="checkpoint dir to initialize params from (its 'best')")
    # accepted so that it can be refused by name
    p.add_argument("--tensorboard", default=None, help=argparse.SUPPRESS)
    args, cfg = parse_with_overrides(p, argv)
    epochs = args.epochs or (cfg.train.pos_epochs if args.stage == "pos" else cfg.train.epochs)
    if args.tensorboard:
        die("--tensorboard is not ported: the port logs scalars to train_log.jsonl only")
    device, dtype = apply_runtime_flags(args, cfg)
    with precision(dtype):
        _train(args, cfg, epochs, device)


def _train(args, cfg, epochs: int, device) -> None:
    info, labels, store, cfg = load_corpus(args.data_dir, cfg)
    train_it = TrainBatchIterator(
        store, labels["caps"], labels["pos"], labels["ncaps"], np.asarray(info.splits["train"]),
        cfg.data.batch_size, cfg.data.caps_per_video_train, seed=cfg.data.shuffle_seed,
    )
    spe = train_it.steps_per_epoch()
    ckpt_dir = os.path.join(args.checkpoint_dir, args.stage)
    if args.init_from:
        # fresh optimizer for the new stage, warm params
        state = create_train_state(restore_params(args.init_from, cfg, device), cfg)
        mgr = CheckpointManager(ckpt_dir)
    else:
        state, infos, mgr = restore_or_init(ckpt_dir, cfg, device, name="last",
                                            init_seed=cfg.train.seed)
        if infos:
            log.info("resuming from %s at step %d", ckpt_dir, int(state.step))
    tx = make_optimizer(cfg, spe, stage=args.stage)
    scst_step = lambda: make_scst_train_step(tx, cfg, build_scst_reward_tables(info, labels, device))
    step_fn = scst_step() if args.stage == "scst" else make_xe_train_step(tx, cfg, stage=args.stage)
    infos_extra = {"stage": args.stage, "config": cfg.to_dict()}
    switch = cfg.train.scst_start_epoch
    with JsonlLogger(os.path.join(ckpt_dir, "train_log.jsonl"), echo=False) as jsonl:
        loop = lambda state, step_fn, epochs, infos_extra: train_loop(
            state, step_fn, train_it, store, labels, info, cfg, epochs=epochs, ckpt=mgr,
            jsonl=jsonl, infos_extra=infos_extra)
        if args.stage in ("caption", "joint") and 0 <= switch < epochs:
            # XE for `switch` epochs, then SCST on the same state and optimizer
            state, result_xe = loop(state, step_fn, switch, infos_extra)
            log.info("switching to SCST at epoch %d", switch)
            _, result = loop(state, scst_step(), epochs - switch, {**infos_extra, "stage": "scst"})
            result["best"] = max(result["best"], result_xe["best"])
        else:
            _, result = loop(state, step_fn, epochs, infos_extra)
    log.info("done: best %s = %.4f", cfg.train.keep_best_metric, result["best"])


if __name__ == "__main__":
    main()
