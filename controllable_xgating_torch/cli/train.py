"""Train the captioner: with cross-entropy, the POS generator (`pos`), the
captioner with the POS branch frozen (`caption`) or both (`joint`); or
fine-tune it with self-critical sequence training (`scst`, the CIDEr-D
reward on the device, the POS branch frozen). Checkpoints (`best`,
`last`) and `train_log.jsonl` go to `<checkpoint_dir>/<stage>/`; a run
resumes from that directory's `last`. `train.scst_start_epoch` N >= 0
switches a `caption` or `joint` run to SCST after N epochs, with the same
parameters, optimizer state and step.

Counterpart of `controllable_xgating_tpu/cli/train.py`. A fresh start
draws its weights with the port's `init_captioner(cfg, seed=train.seed)`,
which are not the JAX package's for the same seed (another random
stream), and SCST's samples are not JAX's either; `--init_from` starts
from a checkpoint's `best` with a fresh optimizer.

Data parallelism (config 5) runs one process per card:
`--parallel.num_devices N` (0, the default: every visible card) starts N
ranks of this command on a free localhost port, each on its own card
(`--device cpu`: N ranks on the CPU over gloo), where the batch divides
by N; otherwise it trains on one device. Processes started by the user
instead (the CXG_* variables of `parallel/distributed.py`, or torchrun's)
train as one run over all of them. Every rank takes its rows of each
batch and the update is the one-device step's on the whole batch; rank 0
alone evaluates, writes the checkpoints and `train_log.jsonl`.

  python -m controllable_xgating_torch.cli.train --data_dir D --stage pos
  python -m controllable_xgating_torch.cli.train --data_dir D --stage caption \\
      --init_from checkpoints/pos
  python -m controllable_xgating_torch.cli.train --data_dir D --stage scst \\
      --init_from checkpoints/caption
  python -m controllable_xgating_torch.cli.train --data_dir D --parallel.num_devices 4
  python -m controllable_xgating_torch.cli.train ... --profile prof/ --debug_nans
"""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import torch

from controllable_xgating_torch.cli.common import (
    apply_runtime_flags,
    base_parser,
    die,
    load_corpus,
    parse_with_overrides,
    restore_or_init,
    restore_params,
    runtime_scope,
)
from controllable_xgating_torch.data.loader import TrainBatchIterator
from controllable_xgating_torch.parallel import distributed
from controllable_xgating_torch.parallel.mesh import make_parallel_train_step
from controllable_xgating_torch.train.loop import train_loop
from controllable_xgating_torch.train.scst import build_scst_reward_tables, make_scst_train_step
from controllable_xgating_torch.train.state import (
    CheckpointManager,
    create_train_state,
    make_optimizer,
)
from controllable_xgating_torch.train.xe import make_xe_train_step
from controllable_xgating_torch.utils.logging import JsonlLogger, get_logger
from controllable_xgating_torch.utils.profiling import profile_trace

log = get_logger("cxg.cli.train")


def main(argv=None) -> None:
    p = base_parser(__doc__)
    p.add_argument("--stage", default="joint", choices=("pos", "caption", "joint", "scst"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--init_from", default=None,
                   help="checkpoint dir to initialize params from (its 'best')")
    p.add_argument("--tensorboard", default=None, metavar="LOGDIR",
                   help="also mirror scalars to a TensorBoard event file")
    args, cfg = parse_with_overrides(p, argv)
    epochs = args.epochs or (cfg.train.pos_epochs if args.stage == "pos" else cfg.train.epochs)
    device, dtype = apply_runtime_flags(args, cfg)
    ranks = ranks_to_launch(cfg, device)
    if ranks:
        log.info("launching %d ranks of data-parallel training on %s", ranks, device.type)
        try:
            # `main` by its module's import name, which a rank can import
            # also where this command runs as __main__
            rank_main = importlib.import_module("controllable_xgating_torch.cli.train").main
            distributed.launch(rank_main, ranks, (list(sys.argv[1:] if argv is None else argv),),
                               device_type=device.type)
        except RuntimeError as e:
            die(f"data-parallel training failed: {e}")
        return
    try:
        with runtime_scope(args, dtype):
            _train(args, cfg, epochs, device)
    finally:
        distributed.shutdown()


def ranks_to_launch(cfg, device) -> int:
    """How many ranks this command starts: `parallel.num_devices` (0: the
    visible cards; one on the CPU) where that is > 1, the batch divides by
    it and no process group is running; else 0 (train here). More than
    the visible cards exits 1."""
    if torch.distributed.is_initialized():
        return 0
    n = cfg.parallel.num_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if n <= 1:
        return 0
    if device.type == "cuda" and n > torch.cuda.device_count():
        die(f"parallel.num_devices={n}: need {n} devices, have {torch.cuda.device_count()}")
    if cfg.data.batch_size % n:
        log.info("batch_size %d not divisible by %d devices; running single-device "
                 "(set data.batch_size or parallel.num_devices)", cfg.data.batch_size, n)
        return 0
    return n


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
    finalize = lambda step: step
    if torch.distributed.is_initialized():
        world = distributed.process_count()
        if cfg.parallel.num_devices not in (0, world):
            raise ValueError("parallel.num_devices cannot subset the device list in "
                             "multi-process mode (every process must participate)")
        if cfg.data.batch_size % world:
            raise ValueError(f"batch_size {cfg.data.batch_size} must divide over {world} "
                             "devices in multi-process mode")
        # every process built its state alike (the same seed) or restored
        # the same checkpoint: a process that could not see the checkpoint
        # would otherwise train a model of its own
        distributed.replicate_to_global((state.params, state.step, state.gen))
        if distributed.is_primary():
            log.info("data-parallel over %d devices on %d processes", world, world)
        finalize = make_parallel_train_step
    tx = make_optimizer(cfg, spe, stage=args.stage)
    scst_step = lambda: finalize(make_scst_train_step(
        tx, cfg, build_scst_reward_tables(info, labels, device)))
    step_fn = scst_step() if args.stage == "scst" else finalize(
        make_xe_train_step(tx, cfg, stage=args.stage))
    infos_extra = {"stage": args.stage, "config": cfg.to_dict()}
    switch = cfg.train.scst_start_epoch
    # one writer of the log: the primary
    log_path = os.path.join(ckpt_dir, "train_log.jsonl") if distributed.is_primary() else None
    with JsonlLogger(log_path, echo=False,
                     tensorboard_dir=args.tensorboard if log_path else None) as jsonl:
        loop = lambda state, step_fn, epochs, infos_extra: train_loop(
            state, step_fn, train_it, store, labels, info, cfg, epochs=epochs, ckpt=mgr,
            jsonl=jsonl, infos_extra=infos_extra)
        # --profile traces the loops (with the switch's reward tables), as the JAX CLI's spans
        if args.stage in ("caption", "joint") and 0 <= switch < epochs:
            # XE for `switch` epochs, then SCST on the same state and optimizer
            with profile_trace(args.profile):
                state, result_xe = loop(state, step_fn, switch, infos_extra)
                log.info("switching to SCST at epoch %d", switch)
                _, result = loop(state, scst_step(), epochs - switch,
                                 {**infos_extra, "stage": "scst"})
            result["best"] = max(result["best"], result_xe["best"])
        else:
            with profile_trace(args.profile):
                _, result = loop(state, step_fn, epochs, infos_extra)
    if distributed.is_primary():
        log.info("done: best %s = %.4f", cfg.train.keep_best_metric, result["best"])


if __name__ == "__main__":
    main()
