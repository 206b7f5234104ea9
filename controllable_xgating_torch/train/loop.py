"""Training loop: epochs, eval on val, best-metric checkpoint retention.

Counterpart of `train_loop` in `controllable_xgating_tpu/train/loop.py`:
batches from the iterator -> train step -> eval every `eval_every_epochs`
through `evaluate_split` -> `last` always and `best` on the tracked
metric, per-epoch snapshots, early stop.

Batches come through `data/features.py::PrefetchIterator` at depth
`data.num_prefetch`: a thread draws the next batches and puts them with
`device_put_fn` (the train CLI's: `DevicePut`, pinned memory and a side
stream on the card; under data parallelism this process's rows first)
while the step runs. The prefetch is closed when the loop ends, and by
then its worker has drawn exactly `num_prefetch + 1` batches past the
last step, which is where the JAX loop's worker stands when it is
closed. That count matters beyond the loop: `TrainBatchIterator` draws
its permutations and caption choices from one random stream, and the
XE -> SCST switch (`train.scst_start_epoch`) runs a second loop over the
same iterator, whose batches depend on how far the first loop drew. A
count that followed the thread's timing, or no prefetch at all (fewer
draws), would give SCST other batches than the JAX package's.

Under data parallelism (`parallel/distributed.py`: one process per card,
the step a data-parallel one) every process runs the steps, and the side
effects are the primary's alone: the log lines, the epoch snapshots, the
val eval (on its own card, with its own copy of the parameters, which
every process holds alike) and the `last` / `best` saves. The peers go on
to the next epoch's step and wait in its all-reduce meanwhile (the
collective timeout, `distributed.DEFAULT_TIMEOUT_S`, outlasts a val
eval). The early-stop decision is broadcast from the primary, so that no
peer waits for a step the primary never takes.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from controllable_xgating_torch.data.features import PrefetchIterator
from controllable_xgating_torch.data.loader import TrainBatchIterator
from controllable_xgating_torch.infer.evaluator import evaluate_split
from controllable_xgating_torch.parallel.distributed import (
    broadcast_flag,
    is_multiprocess,
    is_primary,
)
from controllable_xgating_torch.train.state import CheckpointManager, TrainState
from controllable_xgating_torch.utils.logging import JsonlLogger, get_logger
from controllable_xgating_torch.utils.spans import count, installed, span

log = get_logger("cxg.train")


def train_loop(
    state: TrainState,
    step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]],
    train_iter: TrainBatchIterator,
    store,
    labels: dict,
    info,
    cfg,
    epochs: int,
    ckpt: Optional[CheckpointManager] = None,
    jsonl: Optional[JsonlLogger] = None,
    eval_split: str = "val",
    infos_extra: Optional[dict] = None,
    device_put_fn=None,
    track_metric: Optional[str] = None,
) -> tuple[TrainState, dict]:
    """Run `epochs` epochs. Returns (state, {"best": ..., "history": [...]});
    each history entry has the epoch's mean loss, samples/s and, on eval
    epochs, the val metrics under "eval". `device_put_fn` is the
    prefetch's put function (None: the host batches as they are)."""
    steps_per_epoch = train_iter.steps_per_epoch()
    jsonl = jsonl or JsonlLogger(echo=False)
    track_metric = track_metric or cfg.train.keep_best_metric
    best_score = -float("inf")
    epochs_since_improve = 0
    history = []
    start_step = int(state.step)
    caption_fn = _make_select_caption_fn(cfg)
    primary = is_primary()
    batches = PrefetchIterator(iter(train_iter), put_fn=device_put_fn,
                               depth=cfg.data.num_prefetch)
    try:
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for i in range(steps_per_epoch):
                with span("train.batch_wait"):
                    if installed() is not None:  # qsize() takes the queue's lock
                        count("prefetch.depth", batches.queued)
                    batch = next(batches)
                state, metrics = step_fn(state, batch)
                losses.append(metrics["loss"])
                step = start_step + epoch * steps_per_epoch + i + 1
                if step % cfg.train.log_every_steps == 0:
                    traced = _span_fields()
                    if primary:
                        jsonl.log(step, epoch=epoch, **{k: float(v) for k, v in metrics.items()},
                                  **traced)
            global_step = start_step + (epoch + 1) * steps_per_epoch
            # one transfer per epoch for the summary
            mean_loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
            dt = time.time() - t0
            samples = steps_per_epoch * train_iter.batch_size
            if primary:
                log.info("epoch %d loss %.4f (%.1f samples/s)", epoch, mean_loss, samples / dt)
            entry = {"epoch": epoch, "loss": mean_loss, "samples_per_sec": samples / dt}

            # per-epoch snapshot window ('epoch_<n>' slots, absolute numbering)
            if ckpt is not None and cfg.train.keep_epoch_snapshots > 0 and primary:
                abs_epoch = epoch + start_step // max(steps_per_epoch, 1)
                ckpt.save(f"epoch_{abs_epoch}", state, {
                    "epoch": abs_epoch, "step": global_step, "best_score": None,
                    "metric": track_metric, **(infos_extra or {}),
                })
                drop = abs_epoch - cfg.train.keep_epoch_snapshots
                if drop >= 0:
                    ckpt.delete(f"epoch_{drop}")

            stop = False
            eval_epoch = (epoch + 1) % cfg.train.eval_every_epochs == 0
            if eval_epoch and primary:
                metrics, _ = evaluate_split(
                    state.params, store, labels, info, split=eval_split,
                    batch_size=cfg.data.batch_size, max_len=cfg.eval.max_decode_len,
                    max_pos_len=cfg.model.max_pos_len, caption_fn=caption_fn,
                    metrics=cfg.eval.metrics,
                )
                entry["eval"] = metrics
                score = metrics.get(track_metric, metrics.get("CIDEr", 0.0))
                jsonl.log(global_step, epoch=epoch, **{f"val_{k}": v for k, v in metrics.items()})
                log.info("epoch %d val %s=%.4f", epoch, track_metric, score)
                infos = {
                    "epoch": epoch, "step": global_step, "best_score": max(best_score, score),
                    "metric": track_metric, **(infos_extra or {}),
                }
                improved = score > best_score
                if ckpt is not None:
                    ckpt.save_last(state, infos)
                    if improved:
                        ckpt.save_best(state, infos)
                if improved:
                    best_score = score
                    epochs_since_improve = 0
                else:
                    epochs_since_improve += 1
                stop = (cfg.train.early_stop_patience > 0
                        and epochs_since_improve >= cfg.train.early_stop_patience)
            if eval_epoch and cfg.train.early_stop_patience > 0 and is_multiprocess():
                stop = broadcast_flag(stop)
            history.append(entry)
            if stop and primary:
                log.info("early stop at epoch %d: no %s improvement in %d consecutive eval epochs",
                         epoch, track_metric, cfg.train.early_stop_patience)
            if stop:
                break
    finally:
        batches.close()
    return state, {"best": best_score, "history": history}


def _span_fields() -> dict:
    """With a span collector installed (`cli/train.py --profile`), the
    log line's share of it since the last line, which it then drops: the
    host ms a step waited for its batch, the all-reduce's ms a step (data
    parallel only; device time on the card, host time elsewhere) and the
    batches ready in the prefetch queue at a take, as means over the steps
    since the last line."""
    col = installed()
    if col is None:
        return {}
    got = col.summary()
    col.clear()
    waits, counters = got["spans"].get("train.batch_wait"), got["counters"]
    out = {}
    if waits:
        out["batch_wait_ms"] = waits["host_ms"] / waits["n"]
        out["prefetch_depth"] = counters.get("prefetch.depth", 0) / waits["n"]
    reduce = got["spans"].get("train.allreduce")
    if reduce:
        ms = reduce["device_ms"] if reduce["device_ms"] is not None else reduce["host_ms"]
        out["allreduce_ms"] = ms / reduce["n"]
    return out


def _make_select_caption_fn(cfg):
    """Decode fn for per-epoch model selection (`eval.select_decode`)."""
    if cfg.eval.select_decode == "beam":
        from controllable_xgating_torch.infer.beam import make_beam_caption_fn

        return make_beam_caption_fn(
            cfg.eval.beam_size, cfg.model.max_pos_len, cfg.eval.max_decode_len,
            length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk,
        )
    if cfg.eval.select_decode != "greedy":
        raise ValueError(
            f"eval.select_decode must be 'greedy' or 'beam', got {cfg.eval.select_decode!r}"
        )
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    return make_greedy_caption_fn(cfg.model.max_pos_len, cfg.eval.max_decode_len,
                                  block_unk=cfg.eval.block_unk)
