"""Cross-entropy training step: caption XE + POS XE with stage masking.

Counterpart of `controllable_xgating_tpu/train/xe.py`. The K-captions-per-
video trick encodes each video once and decodes K sequences against the
repeated encoder outputs. The step updates the train state in place (the
parameters, the optimizer's moments, the step and the generator) and
returns it with its metrics, which stay on the device until read.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from controllable_xgating_torch.data.vocab import PAD
from controllable_xgating_torch.models.captioner import CaptionerParams
from controllable_xgating_torch.models.decoder import decoder_forward, make_decode_context
from controllable_xgating_torch.models.encoder import encode
from controllable_xgating_torch.models.pos_generator import pos_forward
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.kernels.xent import xent_row_stats, xent_row_stats_plain
from controllable_xgating_torch.parallel.distributed import all_reduce_sum, rank_and_count
from controllable_xgating_torch.train.state import (
    Optimizer,
    TrainState,
    apply_grad_mask,
    stage_grad_mask,
)
from controllable_xgating_torch.utils.spans import span

# vocab width from which masked_xe_sum takes the row-statistics kernel
# (K5), as in the JAX package; the POS logits (35 tags) never do
XENT_KERNEL_MIN_V = 2048
_BATCH_KEYS = ("app", "motion", "caps", "pos", "frame_mask")


def masked_xe_sum(
    logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Summed NLL over non-PAD target positions (see masked_xe_loss).

    `label_smoothing` eps > 0 mixes in the uniform-target cross entropy:
    (1-eps)*(lse - logit[target]) + eps*(lse - mean(logits)), without a
    [B, L, V] log-prob array. At vocab widths >= XENT_KERNEL_MIN_V the
    per-row statistics come from `xent_row_stats` (the kernel pair on the
    card) unless the kernels are switched off (`ops/dispatch.py`), else
    from its plain version; the loss arithmetic below is the same either
    way."""
    v = logits.shape[-1]
    row_stats = xent_row_stats if fused_enabled() and v >= XENT_KERNEL_MIN_V \
        else xent_row_stats_plain
    lse, tgt, xmean = (s.reshape(targets.shape) for s in row_stats(
        logits.float().reshape(-1, v), targets.reshape(-1)))
    nll = lse - tgt
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - xmean)
    return (nll * (targets != PAD).float()).sum()


def masked_xe_loss(
    logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean NLL over non-PAD target positions; logits [B, L, V] predict
    targets [B, L] (already shifted by the caller)."""
    count = (targets != PAD).sum().float()
    return masked_xe_sum(logits, targets, label_smoothing) / torch.clamp(count, min=1.0)


def xe_losses(
    params: CaptionerParams,
    batch: dict,
    gen: Optional[torch.Generator],
    dropout_rate: float,
    remat: bool = False,
    reduction: str = "mean",
    label_smoothing: float = 0.0,
    shard: tuple = (0, 1),
) -> tuple[torch.Tensor, torch.Tensor]:
    """(caption XE, POS XE) on a train batch with caps [B, K, L].

    `reduction="sum"` returns un-normalised token-NLL sums, the form
    gradient accumulation and data parallelism need. `label_smoothing`
    applies to the caption term only. Dropout masks come from `gen`: the
    encoder's, then the decoder's; the batch is block `shard` (rank,
    ranks) of the global batch's rows, whose masks are drawn
    (`ops/dropout.py::keep_rows`)."""
    app, motion = batch["app"], batch["motion"]
    caps, pos = batch["caps"], batch["pos"]
    frame_mask = batch.get("frame_mask")
    b, k, length = caps.shape
    enc_out, summary = encode(params.encoder, app, motion, frame_mask, gen=gen,
                              dropout_rate=dropout_rate, shard=shard)
    caps_flat = caps.reshape(b * k, length)
    pos_flat = pos.reshape(b * k, -1)
    summary_k = summary.repeat_interleave(k, dim=0)
    enc_out_k = enc_out.repeat_interleave(k, dim=0)
    mask_k = None if frame_mask is None else frame_mask.repeat_interleave(k, dim=0)

    reduce = masked_xe_sum if reduction == "sum" else masked_xe_loss
    pos_logits, psi = pos_forward(params.pos, summary_k, pos_flat)
    pos_loss = reduce(pos_logits, pos_flat[:, 1:])
    ctx = make_decode_context(params.decoder, enc_out_k, psi, mask_k)
    cap_logits = decoder_forward(params.decoder, ctx, summary_k, caps_flat, gen, dropout_rate,
                                 remat=remat, shard=shard)
    cap_loss = reduce(cap_logits, caps_flat[:, 1:], label_smoothing)
    return cap_loss, pos_loss


def batch_to_device(batch: dict, device, keys: tuple = _BATCH_KEYS) -> dict:
    """The step's `keys` of a batch (numpy arrays or tensors) as tensors on
    `device`; keys the batch lacks (`frame_mask`) are left out."""
    return {k: torch.as_tensor(batch[k], device=device) for k in keys if k in batch}


def param_grads(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for each leaf; a leaf the loss does not reach (the
    concat ablation's gates, say) gets a zero gradient, as under jax.grad."""
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def reduce_over_group(grads: list, scalars: list, group) -> tuple[list, list]:
    """(gradients, scalars) summed over `group`'s processes in one
    all-reduce of a flat f32 buffer (the span `train.allreduce`, timed on
    the card); unchanged without a group."""
    if group is None:
        return grads, scalars
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([s.float() for s in scalars])])
    with span("train.allreduce", device=True):
        all_reduce_sum(flat, group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return out, list(flat[i:])


def make_xe_train_step(
    tx: Optimizer, cfg, stage: str = "joint"
) -> Callable[..., tuple[TrainState, dict]]:
    """Build the XE step for a stage ('pos' | 'caption' | 'joint').

    `step(state, batch, group=None)` takes a batch of numpy arrays or
    tensors (as `TrainBatchIterator` yields them), moves it to the
    parameters' device, and returns (state, {"loss", "grad_norm",
    "cap_loss", "pos_loss"}). The batch runs as `train.accum_steps`
    micro-batches, split interleaved (micro-batch m holds rows m, m +
    accum, ...), whose token-NLL sums are divided by the whole batch's
    non-PAD counts, so the summed gradient is the full-batch mean-loss
    gradient.

    With a process group (`parallel/mesh.py::make_parallel_train_step`)
    the batch is this process's block of the global batch's rows: the
    non-PAD counts are all-reduced first, so each process's sums are
    divided by the global counts (a mean of per-process means would weigh
    short captions wrongly), the dropout masks are the global batch's rows
    (`ops/dropout.py::keep_rows`), and the gradients and metrics are
    summed over the processes in one all-reduce before the clip and Adam:
    every process applies the one-device step's update of the global
    batch. A process's block must divide by `accum`."""
    cap_w = 0.0 if stage == "pos" else 1.0
    pos_w = 0.0 if stage == "caption" else 1.0
    dropout_rate = cfg.model.dropout
    remat = cfg.train.remat
    accum = max(int(getattr(cfg.train, "accum_steps", 1)), 1)
    smooth = float(getattr(cfg.train, "label_smoothing", 0.0))

    def step(state: TrainState, batch: dict, group=None) -> tuple[TrainState, dict]:
        named = list(state.params.named_parameters())
        leaves = [p for _, p in named]
        batch = batch_to_device(batch, leaves[0].device)
        b = batch["caps"].shape[0]
        if b % accum:
            raise ValueError(f"data.batch_size {b} must be divisible by train.accum_steps {accum}")
        shard = rank_and_count(group)
        counts = torch.stack([(batch["caps"][..., 1:] != PAD).sum(),
                              (batch["pos"][..., 1:] != PAD).sum()]).float()
        cap_n, pos_n = torch.clamp(all_reduce_sum(counts, group), min=1.0)
        grads, total, cap_loss, pos_loss = None, 0.0, 0.0, 0.0
        for m in range(accum):
            mb = {k: v[m::accum] for k, v in batch.items()}
            cap_sum, pos_sum = xe_losses(state.params, mb, state.gen, dropout_rate, remat,
                                         reduction="sum", label_smoothing=smooth, shard=shard)
            micro = cap_w * cap_sum / cap_n + pos_w * pos_sum / pos_n
            g = param_grads(micro, leaves)
            grads = g if grads is None else [a + c for a, c in zip(grads, g)]
            total = total + micro.detach()
            cap_loss = cap_loss + cap_sum.detach() / cap_n
            pos_loss = pos_loss + pos_sum.detach() / pos_n
        grads, (total, cap_loss, pos_loss) = reduce_over_group(
            grads, [total, cap_loss, pos_loss], group)
        grads = apply_grad_mask({n: g for (n, _), g in zip(named, grads)},
                                stage_grad_mask(state.params, stage))
        grad_norm = tx.apply(state, grads)
        metrics = {"loss": total, "grad_norm": grad_norm, "cap_loss": cap_loss,
                   "pos_loss": pos_loss}
        return state, metrics

    return step
