"""Self-critical sequence training (SCST, Rennie et al. 2017) on one device.

Counterpart of `controllable_xgating_tpu/train/scst.py`: a greedy baseline
rollout, a multinomial sample rollout, CIDEr-D rewards for both from token
ids on the device (`ops/cider_device.py`), and the REINFORCE loss
-(reward_s - reward_g) * logp(sample), with no host sync in the step.

psi comes from the POS generator's own greedy rollout (the captioner is
trained for how it is used), and the POS branch is frozen. As in the JAX
package, the step draws no dropout, whatever `model.dropout` says, and the
encoder and the POS rollout take their plain paths: the gradient flows
through them. The baseline rollout (and the paired rollout) runs without
gradient on detached inputs, so it may take the decoder-step kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from controllable_xgating_torch.data.vocab import BOS, PAD
from controllable_xgating_torch.infer.greedy import (
    greedy_decode,
    mask_special_tokens,
    paired_rollout,
    sample_decode,
)
from controllable_xgating_torch.models.captioner import CaptionerParams
from controllable_xgating_torch.models.decoder import (
    DecodeContext,
    DecoderParams,
    decoder_forward,
    make_decode_context,
)
from controllable_xgating_torch.models.encoder import encode
from controllable_xgating_torch.models.pos_generator import pos_greedy_generate
from controllable_xgating_torch.ops.cider_device import (
    CiderRewardTables,
    build_reward_tables,
    cider_d_device,
)
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.train.state import (
    Optimizer,
    TrainState,
    apply_grad_mask,
    stage_grad_mask,
)
from controllable_xgating_torch.train.xe import batch_to_device, param_grads

_BATCH_KEYS = ("app", "motion", "video_indices", "frame_mask")


def build_scst_reward_tables(info, labels: dict, device="cuda") -> CiderRewardTables:
    """df over the train split, references for every video, on `device`."""
    return build_reward_tables(np.asarray(labels["caps"]), np.asarray(labels["ncaps"]),
                               list(info.splits["train"]), device=device)


def scst_context(params: CaptionerParams, batch: dict, max_pos_len: int):
    """(decode context, summary) of a batch of tensors, with gradient:
    the plain encoder, psi from the plain greedy POS rollout."""
    frame_mask = batch.get("frame_mask")
    enc_out, summary = encode(params.encoder, batch["app"], batch["motion"], frame_mask)
    _, psi = pos_greedy_generate(params.pos, summary, max_pos_len)
    return make_decode_context(params.decoder, enc_out, psi, frame_mask), summary


def reinforce_loss(tables: CiderRewardTables, video_indices: torch.Tensor,
                   greedy: torch.Tensor, sample: torch.Tensor, logps: torch.Tensor):
    """(loss, aux) from the two rollouts' tokens [B, L] and logp(sample)
    [B, L]: the advantage reward_s - reward_g carries no gradient, and the
    loss is its product with logp summed over the sample's non-PAD
    positions, over their count."""
    reward_s = cider_d_device(tables, sample, video_indices)
    reward_g = cider_d_device(tables, greedy, video_indices)
    advantage = (reward_s - reward_g).detach()
    mask = (sample != PAD).float()
    loss = -(advantage[:, None] * logps * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    aux = {"reward_sample": reward_s.mean(), "reward_greedy": reward_g.mean(),
           "advantage": advantage.mean()}
    return loss, aux


def paired_loss(decoder: DecoderParams, ctx: DecodeContext, summary: torch.Tensor,
                tables: CiderRewardTables, video_indices: torch.Tensor,
                greedy: torch.Tensor, sample: torch.Tensor):
    """The paired realization's loss at given tokens: logp(sample) teacher-
    forced through `decoder_forward` on [BOS, sample] (the sampled rows
    feed PAD after EOS, as the rollout did), masked as decoding masks and
    normalised in f32, then `reinforce_loss`."""
    b = sample.shape[0]
    caps_in = torch.cat([torch.full((b, 1), BOS, dtype=sample.dtype, device=sample.device),
                         sample], dim=1)
    logits = mask_special_tokens(decoder_forward(decoder, ctx, summary, caps_in).float())
    logps = logits.gather(-1, sample[:, :, None].long())[:, :, 0] - torch.logsumexp(logits, -1)
    return reinforce_loss(tables, video_indices, greedy, sample, logps)


def scst_loss(
    params: CaptionerParams,
    batch: dict,
    tables: CiderRewardTables,
    generator: torch.Generator,
    max_len: int,
    max_pos_len: int,
    fused_baseline: bool = False,
    paired: bool = False,
):
    """REINFORCE loss and aux of a batch of tensors, in either of two
    token-equivalent realizations. `paired=False`: the greedy baseline
    without gradient, then `sample_decode` with gradient, whose logps are
    the loss's. `paired=True`: one 2B-row `paired_rollout` without
    gradient, then `paired_loss`. `fused_baseline` takes the rollout
    without gradient through the decoder-step kernel."""
    ctx, summary = scst_context(params, batch, max_pos_len)
    vi = batch["video_indices"]
    fused = True if fused_baseline else None
    # the rollouts without gradient take detached inputs (JAX stops the
    # gradient there), so that the kernel never sees a tensor needing grad
    ctx_f = DecodeContext(*(None if x is None else x.detach() for x in ctx))
    if paired:
        greedy, sample = paired_rollout(params.decoder, ctx_f, summary.detach(), max_len,
                                        generator, fused=fused)
        return paired_loss(params.decoder, ctx, summary, tables, vi, greedy, sample)
    with torch.no_grad():
        greedy = greedy_decode(params.decoder, ctx_f, summary.detach(), max_len, fused=fused)
    sample, logps = sample_decode(params.decoder, ctx, summary, max_len, generator)
    return reinforce_loss(tables, vi, greedy, sample, logps)


def make_scst_train_step(
    tx: Optimizer, cfg, tables: CiderRewardTables
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The SCST step: `step(state, batch)` moves the batch's app, motion,
    frame mask and video indices to the parameters' device, takes the loss
    times `train.scst_cider_weight` (the realization from
    `train.scst_paired_rollout`, the samples from `state.gen`), masks the
    POS generator's gradients to zero and applies `tx`, in place. Metrics:
    loss, grad_norm (of the masked gradients), reward_sample,
    reward_greedy, advantage. The baseline takes the decoder-step kernel
    unless the kernels are switched off (`ops/dispatch.py`)."""
    max_len = cfg.eval.max_decode_len
    max_pos_len = cfg.model.max_pos_len
    reward_w = cfg.train.scst_cider_weight
    paired = cfg.train.scst_paired_rollout
    fused_baseline = fused_enabled()

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        named = list(state.params.named_parameters())
        leaves = [p for _, p in named]
        batch = batch_to_device(batch, leaves[0].device, _BATCH_KEYS)
        loss, aux = scst_loss(state.params, batch, tables, state.gen, max_len, max_pos_len,
                              fused_baseline=fused_baseline, paired=paired)
        loss = reward_w * loss
        grads = apply_grad_mask({n: g for (n, _), g in zip(named, param_grads(loss, leaves))},
                                stage_grad_mask(state.params, "caption"))
        grad_norm = tx.apply(state, grads)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       **{k: v.detach() for k, v in aux.items()}}

    return step
