"""Batched beam search, single model.

Counterpart of `controllable_xgating_tpu/infer/beam.py` (`beam_search`,
`make_beam_caption_fn`, `row_topk_block`) for one model without diversity
groups:

  * all B videos x K beams advance together as one [B*K] decoder batch;
  * per step, the candidate tail picks the K best continuations of each
    video; beam states are reordered by gathers;
  * finished beams survive by emitting PAD at zero cost, and a per-video
    best-finished register (score, tokens) is kept outside the pool, so a
    finished hypothesis evicted by later-decaying live beams is never lost;
  * only beam 0 is live at t=0, so the first step picks K distinct words.

Four candidate tails, output-identical up to float rounding of the scores
(the JAX package's names): `"lanes"` takes the row-local top-K straight
from the top-K kernel wrapper, which projects, masks and reduces without
writing the [B*K, V] logits; the other three form the full log-softmax in
PyTorch: `"grouped"` takes a row-local top-K and merges the K*K survivors
per video, `"block"` is grouped with the row stage prescreened by 128-wide
block maxima (`row_topk_block`; the port's `topk` prescreens long rows
itself, so the two run the same code), and `"flat"` takes one top-K over
the flattened [B, K*V] pool. `"auto"` picks lanes on the kernel path, and
grouped with `vocab_q` (the weight-only int8 projection, which lanes does
not take) or off it. Auto and an explicit `"lanes"` take grouped where
the top-K kernel does not take the shape (`lanes_fits`: a beam wider than
its `MAX_K`, or a decoder too wide for its shared memory), as the
reference routes on its own `lanes_fits`. Ensembles and diverse beam are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.experiments.int8_vocab_matmul import with_kernel_operand
from controllable_xgating_torch.infer.greedy import mask_special_tokens
from controllable_xgating_torch.models.captioner import CaptionerParams, encode_for_inference
from controllable_xgating_torch.models.decoder import (
    DecodeContext,
    DecoderParams,
    decode_step,
    init_decoder_state,
)
from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights
from controllable_xgating_torch.ops.kernels.topk_tail import (
    lanes_fits,
    logits_topk,
    topk,
    topk_tail_weights,
)

NEG_INF = -1e30


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...] -> x[b, idx[b, j], ...] for idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def row_topk_block(x: torch.Tensor, k: int):
    """Exact per-row top-k by a block-max prescreen (JAX `row_topk_block`):
    `topk` itself runs that prescreen, so this is `topk(x, k)`, kept under
    the `block` tail's name."""
    return topk(x, k)


def beam_search(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,  # [B, He]
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = False,
    topk_mode: str = "auto",
    return_all: bool = False,
    vocab_q=None,
):
    """Returns (tokens [B, max_len], scores [B]) for the best beam, or with
    `return_all=True` (tokens [B, K, max_len], scores [B, K]) best-first,
    where the best-finished register competes as a (K+1)-th candidate
    unless it duplicates a pool row. `early_stop=True` leaves the loop once
    every beam has finished (one host sync per step). `vocab_q` (a
    `QuantVocabProj`) takes every step's vocab projection through the
    weight-only int8 path; the lanes tail does not take it."""
    b = summary.shape[0]
    v = params.w_out.shape[-1]
    k = beam_size
    dev = summary.device
    if topk_mode == "auto":
        topk_mode = "lanes" if fused and vocab_q is None else "grouped"
    if topk_mode not in ("lanes", "grouped", "block", "flat"):
        raise ValueError(f"unknown topk_mode {topk_mode!r}")
    lanes = topk_mode == "lanes"
    if lanes and vocab_q is not None:
        raise ValueError('topk_mode="lanes" does not support vocab_q')
    if lanes and not lanes_fits(k, params.w_out.shape[0]):
        lanes, topk_mode = False, "grouped"
    is_pad = torch.arange(v, device=dev) == PAD
    # a finished row's candidates: the PAD continuation at zero cost
    cont = torch.where(is_pad, 0.0, NEG_INF)
    cont_v, cont_i = topk(cont, k)

    tile = lambda x: x.repeat_interleave(k, dim=0)
    ctx_k = DecodeContext(
        enc_proj=tile(ctx.enc_proj),
        keys=tile(ctx.keys),
        frame_mask=None if ctx.frame_mask is None else tile(ctx.frame_mask),
        psi_g=tile(ctx.psi_g),
    )
    h, c = init_decoder_state(params, tile(summary))  # [B*K, Hd]

    tok = torch.full((b, k), BOS, dtype=torch.long, device=dev)
    cum = torch.where(torch.arange(k, device=dev) == 0, 0.0, NEG_INF).repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.long, device=dev)
    hist = torch.full((b, k, max_len), PAD, dtype=torch.long, device=dev)
    reg_score = torch.full((b,), NEG_INF, device=dev)
    reg_tokens = torch.full((b, max_len), PAD, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    # the kernels' weight operands, cast once for every step
    kw = attn_lstm_weights(params) if fused else None
    w_op = topk_tail_weights(params.w_out) if lanes else None
    if fused and vocab_q is not None:
        vocab_q = with_kernel_operand(vocab_q)

    def final_score(cum, lengths):
        if length_penalty > 0.0:
            return cum / ((5.0 + lengths.float()) / 6.0) ** length_penalty
        return cum

    for t in range(max_len):
        if early_stop and bool(finished.all()):
            break
        fin_col = finished.reshape(b * k)[:, None]
        if lanes:
            h_out, h_new, c_new, _ = decode_step(
                params, ctx_k, tok.reshape(b * k), h, c, fused=fused, return_hidden=True,
                kernel_weights=kw,
            )
            top_v, top_i, lse = logits_topk(h_out, params.w_out, params.b_out, k, block_unk, w_op)
            logp_k = top_v - lse[:, None]
            s1_scores = cum.reshape(b * k)[:, None] + torch.where(fin_col, cont_v, logp_k)
            s1_idx = torch.where(fin_col, cont_i, top_i)
        else:
            logits, h_new, c_new, _ = decode_step(
                params, ctx_k, tok.reshape(b * k), h, c, fused=fused, kernel_weights=kw,
                vocab_q=vocab_q,
            )
            logp = torch.log_softmax(mask_special_tokens(logits.float(), block_unk), -1)
            logp = torch.where(fin_col, cont, logp)
            cand = cum.reshape(b * k)[:, None] + logp  # [B*K, V]
            if topk_mode == "flat":
                top_scores, top_idx = topk(cand.reshape(b, k * v), k)  # [B, K]
                beam_idx, new_tok = top_idx // v, top_idx % v
            else:
                s1_scores, s1_idx = (row_topk_block if topk_mode == "block" else topk)(cand, k)
        if topk_mode != "flat":
            # merge the K*K survivors per video
            top_scores, m_idx = topk(s1_scores.reshape(b, k * k), k)  # [B, K]
            beam_idx = m_idx // k
            new_tok = torch.gather(s1_idx.reshape(b, k * k), 1, m_idx)

        finished_g = torch.gather(finished, 1, beam_idx)
        lengths_g = torch.gather(lengths, 1, beam_idx)
        hist = _gather_rows(hist, beam_idx)
        flat_src = (rows[:, None] * k + beam_idx).reshape(b * k)
        h, c = h_new[flat_src], c_new[flat_src]

        now_finished = finished_g | (new_tok == EOS)
        emit = torch.where(finished_g, torch.full_like(new_tok, PAD), new_tok)
        hist[:, :, t] = emit
        lengths = torch.where(finished_g, lengths_g, lengths_g + 1)

        # best-finished register, from beams finishing this step
        just_finished = now_finished & ~finished_g
        cand = torch.where(
            just_finished, final_score(top_scores, lengths), torch.full_like(top_scores, NEG_INF)
        )
        row_best = torch.argmax(cand, dim=1)
        row_score = cand[rows, row_best]
        improve = row_score > reg_score
        reg_score = torch.where(improve, row_score, reg_score)
        reg_tokens = torch.where(improve[:, None], hist[rows, row_best], reg_tokens)

        tok, cum, finished = emit, top_scores, now_finished

    final = final_score(cum, lengths)
    if return_all:
        dup = (hist == reg_tokens[:, None, :]).all(-1).any(1)  # [B]
        all_scores = torch.cat(
            [final, torch.where(dup, torch.full_like(reg_score, NEG_INF), reg_score)[:, None]],
            dim=1,
        )
        all_hist = torch.cat([hist, reg_tokens[:, None, :]], dim=1)
        sorted_scores, order = topk(all_scores, k)
        return _gather_rows(all_hist, order), sorted_scores
    best = torch.argmax(final, dim=1)
    best_tokens = hist[rows, best]
    best_scores = final[rows, best]
    # an evicted finished hypothesis can still win; ties prefer the pool
    use_reg = reg_score > best_scores
    best_tokens = torch.where(use_reg[:, None], reg_tokens, best_tokens)
    best_scores = torch.where(use_reg, reg_score, best_scores)
    return best_tokens, best_scores


def make_beam_caption_fn(
    beam_size: int,
    max_pos_len: int,
    max_len: int,
    length_penalty: float = 0.0,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = True,
    topk_mode: str = "auto",
    return_all: bool = False,
):
    """(params, app, motion, frame_mask=None) -> (tokens [B, L], pos_tags);
    with `return_all=True` -> (tokens [B, K, L], scores [B, K], pos_tags).
    Inputs are tensors on the parameters' device."""
    from controllable_xgating_torch.ops.dispatch import fused_enabled

    fused = fused_enabled(fused)

    @torch.inference_mode()
    def fn(params: CaptionerParams, app, motion, frame_mask=None):
        ctx, summary, tags = encode_for_inference(
            params, app, motion, frame_mask, max_pos_len=max_pos_len, fused=fused,
            early_stop=early_stop,
        )
        tokens, scores = beam_search(
            params.decoder, ctx, summary, beam_size, max_len, length_penalty, fused=fused,
            block_unk=block_unk, early_stop=early_stop, topk_mode=topk_mode,
            return_all=return_all,
        )
        if return_all:
            return tokens, scores, tags
        return tokens, tags

    return fn
