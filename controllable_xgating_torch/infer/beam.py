"""Batched beam search: one model or an ensemble, with optional diversity
groups.

Counterpart of `controllable_xgating_tpu/infer/beam.py` (`beam_search`,
`make_beam_caption_fn`, `row_topk_block`):

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
not take), for an ensemble or diverse beam, or off the kernel path. Auto
and an explicit `"lanes"` take grouped where the top-K kernel does not
take the shape (`lanes_fits`: a beam wider than its `MAX_K`, or a decoder
too wide for its shared memory), as the reference routes on its own
`lanes_fits`.

An ensemble (`n_members > 0`) passes per-member sequences of parameters,
contexts and summaries: every member steps its own decoder (through the
decoder-step kernel on the kernel path) on the shared tokens, the
candidates come from the members' mean log-probabilities
(`infer/ensemble.py::combine_logp`), and every member's state follows the
same reordering. Members of one architecture and of different ones take
the same code: the JAX package keeps a stacked layout only to `vmap` it.
Diverse beam search (`diversity_groups > 1`) splits the beam into groups
that select in turn, each penalised by the tokens the earlier groups'
live beams chose at this step.

Every variant is one `BeamLoop`, split as the reference's scan and run
through `infer/graphs.py`: replayed CUDA graphs on the card, an eager
loop on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.experiments.int8_vocab_matmul import with_kernel_operand
from controllable_xgating_torch.infer import graphs as decode_graphs
from controllable_xgating_torch.infer.greedy import mask_special_tokens
from controllable_xgating_torch.models.captioner import CaptionerParams, encode_for_inference
from controllable_xgating_torch.models.decoder import (
    DecodeContext,
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
from controllable_xgating_torch.utils.spans import span

NEG_INF = -1e30


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...] -> x[b, idx[b, j], ...] for idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def row_topk_block(x: torch.Tensor, k: int):
    """Exact per-row top-k by a block-max prescreen (JAX `row_topk_block`):
    `topk` itself runs that prescreen, so this is `topk(x, k)`, kept under
    the `block` tail's name."""
    return topk(x, k)


class BeamLoop(decode_graphs.StepLoop):
    """Beam search split as the reference's scan (`infer/graphs.py`):
    inputs every member's context and summary tiled K times a video and
    the kernels' weight operands (made from the parameters on every call),
    carry (every member's h and c, the last tokens, the cumulative scores,
    finished, lengths, the token history and the best-finished register),
    one step of the chosen tail, finish = the best (or every) hypothesis."""

    kind = "beam"

    def __init__(self, members, ctxs, sums, k: int, max_len: int, length_penalty: float,
                 fused: Optional[bool], block_unk: bool, topk_mode: str, return_all: bool,
                 vocab_q, ens: int, groups: int, diversity_penalty: float):
        self.members, self.ctxs, self.sums = members, ctxs, sums
        self.k, self.max_len, self.length_penalty = k, max_len, length_penalty
        self.fused, self.block_unk, self.return_all = bool(fused), block_unk, return_all
        self.vocab_q, self.ens, self.groups = vocab_q, ens, groups
        self.diversity_penalty = diversity_penalty
        self.device = sums[0].device
        self.v = members[0].w_out.shape[-1]
        if topk_mode == "auto":
            topk_mode = "lanes" if fused and vocab_q is None and not ens and groups <= 1 \
                else "grouped"
        if topk_mode not in ("lanes", "grouped", "block", "flat"):
            raise ValueError(f"unknown topk_mode {topk_mode!r}")
        self.lanes = topk_mode == "lanes" and groups <= 1  # diversity ignores topk_mode
        if self.lanes and ens:
            raise ValueError('topk_mode="lanes" does not support ensembles')
        if self.lanes and vocab_q is not None:
            raise ValueError('topk_mode="lanes" does not support vocab_q')
        if self.lanes and not lanes_fits(k, members[0].w_out.shape[0]):
            self.lanes, topk_mode = False, "grouped"
        self.topk_mode = topk_mode

    def key_options(self) -> tuple:
        return (self.k, self.length_penalty, self.fused, self.block_unk, self.topk_mode,
                self.lanes, self.return_all, self.vocab_q is not None, self.ens, self.groups,
                self.diversity_penalty)

    def modules(self) -> list:
        return list(self.members)

    def key_tensors(self) -> list:
        q = self.vocab_q
        return [x for cx, s in zip(self.ctxs, self.sums) for x in (*cx, s)] + \
            ([] if q is None else [q.wq, q.scale, q.bias])

    def prepare(self) -> dict:
        tile = lambda x: None if x is None else x.repeat_interleave(self.k, dim=0)
        q = self.vocab_q
        if self.fused and q is not None:
            q = with_kernel_operand(q)
        return dict(
            ctx=[DecodeContext(*map(tile, cx)) for cx in self.ctxs],
            summary=[tile(s) for s in self.sums],
            # the kernels' weight operands, cast for every step (every member's)
            kw=[attn_lstm_weights(p) if self.fused else None for p in self.members],
            w_op=topk_tail_weights(self.members[0].w_out) if self.lanes else None,
            vocab_q=q,
        )

    def bind(self, inp: dict) -> None:
        super().bind(inp)
        dev, k = self.device, self.k
        # a finished row's candidates: the PAD continuation at zero cost
        self.cont = torch.where(torch.arange(self.v, device=dev) == PAD, 0.0, NEG_INF)
        self.cont_v, self.cont_i = topk(self.cont, k)
        self.rows = torch.arange(self.sums[0].shape[0], device=dev)

    def init(self) -> dict:
        b, k, dev = self.sums[0].shape[0], self.k, self.device
        h, c = map(list, zip(*(init_decoder_state(p, s)
                               for p, s in zip(self.members, self.inp["summary"]))))
        # row 0 live (of every group under diversity), so each group's first
        # step picks distinct words
        kg = k // self.groups if self.groups > 1 else k
        return dict(
            h=h, c=c, tok=torch.full((b, k), BOS, dtype=torch.long, device=dev),
            cum=torch.where(torch.arange(k, device=dev) % kg == 0, 0.0, NEG_INF).repeat(b, 1),
            finished=torch.zeros((b, k), dtype=torch.bool, device=dev),
            lengths=torch.zeros((b, k), dtype=torch.long, device=dev),
            hist=torch.full((b, k, self.max_len), PAD, dtype=torch.long, device=dev),
            reg_score=torch.full((b,), NEG_INF, device=dev),
            reg_tokens=torch.full((b, self.max_len), PAD, dtype=torch.long, device=dev),
        )

    def final_score(self, cum, lengths):
        if self.length_penalty > 0.0:
            return cum / ((5.0 + lengths.float()) / 6.0) ** self.length_penalty
        return cum

    def step(self, carry: dict, t: int) -> None:
        inp, members, b, k, v = self.inp, self.members, self.rows.shape[0], self.k, self.v
        cum, finished, rows = carry["cum"], carry["finished"], self.rows
        fin_col = finished.reshape(b * k)[:, None]
        flat_tok = carry["tok"].reshape(b * k)
        if self.lanes:
            h_out, h_new, c_new, _ = decode_step(
                members[0], inp["ctx"][0], flat_tok, carry["h"][0], carry["c"][0],
                fused=self.fused, return_hidden=True, kernel_weights=inp["kw"][0],
            )
            h_new, c_new = [h_new], [c_new]
            top_v, top_i, lse = logits_topk(
                h_out, members[0].w_out, members[0].b_out, k, self.block_unk, inp["w_op"])
            logp_k = top_v - lse[:, None]
            s1_scores = cum.reshape(b * k)[:, None] + torch.where(fin_col, self.cont_v, logp_k)
            s1_idx = torch.where(fin_col, self.cont_i, top_i)
        else:
            outs = [
                decode_step(p, cx, flat_tok, hh, cc, fused=self.fused, kernel_weights=w,
                            vocab_q=inp["vocab_q"])
                for p, cx, hh, cc, w in zip(members, inp["ctx"], carry["h"], carry["c"],
                                            inp["kw"])
            ]
            h_new, c_new = [o[1] for o in outs], [o[2] for o in outs]
            if self.ens:
                from controllable_xgating_torch.infer.ensemble import combine_logp

                logp = combine_logp([o[0] for o in outs], self.block_unk)
            else:
                logits = mask_special_tokens(outs[0][0].float(), self.block_unk)
                logp = torch.log_softmax(logits, -1)
            logp = torch.where(fin_col, self.cont, logp)
            cand = cum.reshape(b * k)[:, None] + logp  # [B*K, V]
            if self.groups > 1:
                top_scores, beam_idx, new_tok = _diverse_select(
                    cand.reshape(b, k, v), finished, self.groups, self.diversity_penalty)
            elif self.topk_mode == "flat":
                top_scores, top_idx = topk(cand.reshape(b, k * v), k)  # [B, K]
                beam_idx, new_tok = top_idx // v, top_idx % v
            else:
                s1_scores, s1_idx = (row_topk_block if self.topk_mode == "block" else topk)(cand, k)
        if self.groups <= 1 and self.topk_mode != "flat":
            # merge the K*K survivors per video
            top_scores, m_idx = topk(s1_scores.reshape(b, k * k), k)  # [B, K]
            beam_idx = m_idx // k
            new_tok = torch.gather(s1_idx.reshape(b, k * k), 1, m_idx)

        finished_g = torch.gather(finished, 1, beam_idx)
        lengths_g = torch.gather(carry["lengths"], 1, beam_idx)
        hist = _gather_rows(carry["hist"], beam_idx)
        # every member's state follows the same reordering
        flat_src = (rows[:, None] * k + beam_idx).reshape(b * k)

        now_finished = finished_g | (new_tok == EOS)
        emit = torch.where(finished_g, torch.full_like(new_tok, PAD), new_tok)
        hist[:, :, t] = emit
        lengths = torch.where(finished_g, lengths_g, lengths_g + 1)

        # best-finished register, from beams finishing this step
        just_finished = now_finished & ~finished_g
        cand = torch.where(
            just_finished, self.final_score(top_scores, lengths),
            torch.full_like(top_scores, NEG_INF),
        )
        row_best = torch.argmax(cand, dim=1)
        row_score = cand[rows, row_best]
        reg_score = carry["reg_score"]
        improve = row_score > reg_score
        carry.update(
            h=[x[flat_src] for x in h_new], c=[x[flat_src] for x in c_new],
            tok=emit, cum=top_scores, finished=now_finished, lengths=lengths, hist=hist,
            reg_score=torch.where(improve, row_score, reg_score),
            reg_tokens=torch.where(improve[:, None], hist[rows, row_best], carry["reg_tokens"]),
        )

    def done(self, carry: dict) -> torch.Tensor:
        return carry["finished"].all()

    def finish(self, carry: dict):
        hist, reg_score, reg_tokens, rows = (carry["hist"], carry["reg_score"],
                                             carry["reg_tokens"], self.rows)
        final = self.final_score(carry["cum"], carry["lengths"])
        if self.return_all:
            dup = (hist == reg_tokens[:, None, :]).all(-1).any(1)  # [B]
            all_scores = torch.cat(
                [final, torch.where(dup, torch.full_like(reg_score, NEG_INF), reg_score)[:, None]],
                dim=1,
            )
            all_hist = torch.cat([hist, reg_tokens[:, None, :]], dim=1)
            sorted_scores, order = topk(all_scores, self.k)
            return _gather_rows(all_hist, order), sorted_scores
        best = torch.argmax(final, dim=1)
        best_tokens = hist[rows, best]
        best_scores = final[rows, best]
        # an evicted finished hypothesis can still win; ties prefer the pool
        use_reg = reg_score > best_scores
        best_tokens = torch.where(use_reg[:, None], reg_tokens, best_tokens)
        best_scores = torch.where(use_reg, reg_score, best_scores)
        return best_tokens, best_scores


def beam_search(
    params,
    ctx,
    summary,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = False,
    topk_mode: str = "auto",
    return_all: bool = False,
    vocab_q=None,
    n_members: int = 0,
    diversity_groups: int = 0,
    diversity_penalty: float = 0.5,
    graphs: Optional[bool] = None,
):
    """Returns (tokens [B, max_len], scores [B]) for the best beam, or with
    `return_all=True` (tokens [B, K, max_len], scores [B, K]) best-first,
    where the best-finished register competes as a (K+1)-th candidate
    unless it duplicates a pool row. `early_stop=True` leaves the loop once
    every beam has finished. `vocab_q` (a `QuantVocabProj`) takes every
    step's vocab projection through the weight-only int8 path; the lanes
    tail does not take it. `graphs` overrides `set_decode_graphs` (None =
    auto: replayed CUDA graphs for CUDA tensors, the eager loop for CPU
    tensors; see `infer/graphs.py`).

    `params` is a `DecoderParams`, `ctx` a `DecodeContext` and `summary`
    [B, He]; with `n_members > 0` each is a sequence of that many members'
    (an ensemble; members may differ in architecture but not in vocab).

    `diversity_groups > 1` is diverse beam search (Vijayakumar et al.,
    arXiv:1610.02424): the K beams split into G contiguous groups of K/G,
    row 0 of every group is live at t=0, and group j selects with its
    candidates penalised by `diversity_penalty` x the count of live beams
    of groups < j that chose each token at this step. Stored scores stay
    the raw log-probabilities. Diversity ignores `topk_mode` (it takes the
    grouped selection within each group); G <= 1 is the plain beam.
    The loop runs inside the span `beam` (`utils/spans.py`, timed on the
    card)."""
    groups = int(diversity_groups or 0)
    if groups > 1:
        if beam_size % groups:
            raise ValueError(f"diversity_groups={groups} must divide beam_size={beam_size}")
        if diversity_penalty < 0.0:
            raise ValueError("diversity_penalty must be >= 0")
    ens = int(n_members or 0)
    if ens and vocab_q is not None:
        raise ValueError("vocab_q is not supported for ensemble decoding")
    if ens:
        members, ctxs, sums = tuple(params), tuple(ctx), tuple(summary)
        if len(members) != ens:
            raise ValueError(f"n_members={ens} but {len(members)} heterogeneous members")
        vs = {p.w_out.shape[-1] for p in members}
        if len(vs) != 1:
            raise ValueError(f"heterogeneous ensemble members disagree on vocab: {vs}")
    else:
        members, ctxs, sums = (params,), (ctx,), (summary,)
    with span("beam", device=True):
        loop = BeamLoop(members, ctxs, sums, beam_size, max_len, length_penalty, fused,
                        block_unk, topk_mode, return_all, vocab_q, ens, groups, diversity_penalty)
        return decode_graphs.run(loop, max_len, early_stop, graphs)


def _diverse_select(cand: torch.Tensor, finished: torch.Tensor, groups: int, penalty: float):
    """Diverse beam's selection on cand [B, K, V] -> (raw scores, beam
    rows, tokens), each [B, K]: group j takes the grouped two-stage top-K/G
    of its rows, penalised by `penalty` x the histogram of tokens that
    groups < j chose at this step from live (unfinished) rows. Each chosen
    pair's raw (unpenalised) score is gathered back."""
    b, k, _ = cand.shape
    kg = k // groups
    rows = torch.arange(b, device=cand.device)[:, None].expand(b, kg)
    pen = torch.zeros((b, cand.shape[2]), dtype=cand.dtype, device=cand.device)
    scores, beams, toks = [], [], []
    for j in range(groups):
        cj = cand[:, j * kg:(j + 1) * kg, :]  # [B, kg, V]
        sel = cj - penalty * pen[:, None, :] if j else cj
        s1_scores, s1_idx = topk(sel.reshape(b * kg, -1), kg)  # [B*kg, kg]
        _, m_idx = topk(s1_scores.reshape(b, kg * kg), kg)  # [B, kg]
        bj = m_idx // kg  # row within the group
        tj = torch.gather(s1_idx.reshape(b, kg * kg), 1, m_idx)
        if j + 1 < groups:
            # once per choosing beam: two beams on one token count twice
            live = ~torch.gather(finished[:, j * kg:(j + 1) * kg], 1, bj)
            pen.index_put_((rows, tj), live.to(pen.dtype), accumulate=True)
        scores.append(cj[rows, bj, tj])
        beams.append(j * kg + bj)
        toks.append(tj)
    return torch.cat(scores, 1), torch.cat(beams, 1), torch.cat(toks, 1)


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
    diversity_groups: int = 0,
    diversity_penalty: float = 0.5,
):
    """(params, app, motion, frame_mask=None) -> (tokens [B, L], pos_tags);
    with `return_all=True` -> (tokens [B, K, L], scores [B, K], pos_tags).
    Inputs are tensors on the parameters' device. `diversity_groups > 1`
    decodes by diverse beam search (see `beam_search`)."""
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
            return_all=return_all, diversity_groups=diversity_groups,
            diversity_penalty=diversity_penalty,
        )
        if return_all:
            return tokens, scores, tags
        return tokens, tags

    return fn
