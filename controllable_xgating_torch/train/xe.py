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
from controllable_xgating_torch.train.state import (
    Optimizer,
    TrainState,
    apply_grad_mask,
    stage_grad_mask,
)

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
) -> tuple[torch.Tensor, torch.Tensor]:
    """(caption XE, POS XE) on a train batch with caps [B, K, L].

    `reduction="sum"` returns un-normalised token-NLL sums, the form
    gradient accumulation needs. `label_smoothing` applies to the caption
    term only. Dropout masks come from `gen`: the encoder's, then the
    decoder's."""
    app, motion = batch["app"], batch["motion"]
    caps, pos = batch["caps"], batch["pos"]
    frame_mask = batch.get("frame_mask")
    b, k, length = caps.shape
    enc_out, summary = encode(params.encoder, app, motion, frame_mask, gen=gen,
                              dropout_rate=dropout_rate)
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
                                 remat=remat)
    cap_loss = reduce(cap_logits, caps_flat[:, 1:], label_smoothing)
    return cap_loss, pos_loss


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k], device=device) for k in _BATCH_KEYS if k in batch}


def make_xe_train_step(
    tx: Optimizer, cfg, stage: str = "joint"
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the XE step for a stage ('pos' | 'caption' | 'joint').

    `step(state, batch)` takes a batch of numpy arrays or tensors (as
    `TrainBatchIterator` yields them), moves it to the parameters' device,
    and returns (state, {"loss", "grad_norm", "cap_loss", "pos_loss"}).
    With `train.accum_steps` > 1 the batch runs as that many micro-batches,
    split interleaved (micro-batch m holds rows m, m + accum, ...), whose
    token-NLL sums are divided by the whole batch's non-PAD counts, so the
    summed gradient is the full-batch mean-loss gradient."""
    cap_w = 0.0 if stage == "pos" else 1.0
    pos_w = 0.0 if stage == "caption" else 1.0
    dropout_rate = cfg.model.dropout
    remat = cfg.train.remat
    accum = max(int(getattr(cfg.train, "accum_steps", 1)), 1)
    smooth = float(getattr(cfg.train, "label_smoothing", 0.0))

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        named = list(state.params.named_parameters())
        leaves = [p for _, p in named]
        # a parameter the stage's loss does not reach (the concat ablation's
        # gates) gets a zero gradient, as under jax.grad
        grads_of = lambda loss: [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        batch = _to_device(batch, leaves[0].device)
        b = batch["caps"].shape[0]
        if b % accum:
            raise ValueError(f"data.batch_size {b} must be divisible by train.accum_steps {accum}")
        if accum == 1:
            cap_loss, pos_loss = xe_losses(state.params, batch, state.gen, dropout_rate, remat,
                                           label_smoothing=smooth)
            total = cap_w * cap_loss + pos_w * pos_loss
            grads = grads_of(total)
        else:
            cap_n = torch.clamp((batch["caps"][..., 1:] != PAD).sum().float(), min=1.0)
            pos_n = torch.clamp((batch["pos"][..., 1:] != PAD).sum().float(), min=1.0)
            grads, total, cap_loss, pos_loss = None, 0.0, 0.0, 0.0
            for m in range(accum):
                mb = {k: v[m::accum] for k, v in batch.items()}
                cap_sum, pos_sum = xe_losses(state.params, mb, state.gen, dropout_rate, remat,
                                             reduction="sum", label_smoothing=smooth)
                micro = cap_w * cap_sum / cap_n + pos_w * pos_sum / pos_n
                g = grads_of(micro)
                grads = g if grads is None else [a + c for a, c in zip(grads, g)]
                total = total + micro.detach()
                cap_loss = cap_loss + cap_sum.detach() / cap_n
                pos_loss = pos_loss + pos_sum.detach() / pos_n
        grads = apply_grad_mask({n: g for (n, _), g in zip(named, grads)},
                                stage_grad_mask(state.params, stage))
        grad_norm = tx.apply(state, grads)
        metrics = {
            "loss": total.detach(),
            "grad_norm": grad_norm,
            "cap_loss": cap_loss.detach(),
            "pos_loss": pos_loss.detach(),
        }
        return state, metrics

    return step
