"""Ensemble decoding: several checkpoints combined at decode time.

Counterpart of `controllable_xgating_tpu/infer/ensemble.py`. The
combination rule is the arithmetic mean of the members' log-probabilities
(the geometric mean of their distributions, the standard NMT ensemble),
summed over members and divided by M, so that identical members give the
single model's log-probabilities exactly and a `[p, p]` ensemble decodes
the single model's tokens.

The JAX package stacks same-architecture members along a leading axis to
`vmap` them, and keeps a second, tuple layout for members of different
architectures. The port has no `vmap` to serve: members are a tuple in
both cases and take the same code, one member after another. Each member
encodes, rolls out its POS sequence and steps its decoder on the
single-model path, so on the kernel path every member runs the XGating
fusion (K1, xgate-mode members), the POS step (K2) and the decoder step
(K3) with its own weight operands, made once per call. The bookkeeping
(argmax, beam top-K, state reorder) runs once on the combined
distribution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.infer import graphs as decode_graphs
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.greedy import mask_special_tokens
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.models.decoder import decode_step, init_decoder_state
from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights


def _structure(p) -> tuple:
    """A member's architecture as the JAX pytree structure sees it: its
    parameter names and its static fields (fusion mode, psi guidance)."""
    return (tuple(n for n, _ in p.named_parameters()), p.encoder.xgate.mode, p.decoder.use_psi)


def stack_params(params_list) -> tuple:
    """Check >= 2 same-architecture members and return them as a tuple
    (the port's member layout; the kernels take one member's weights at a
    time). Members that differ in structure (fusion mode, psi guidance, a
    unidirectional encoder) or in any parameter's shape are refused, as
    the JAX function refuses them."""
    params_list = tuple(params_list)
    if len(params_list) < 2:
        raise ValueError("an ensemble needs at least two members")
    structs = [_structure(p) for p in params_list]
    if any(s != structs[0] for s in structs[1:]):
        raise ValueError(
            "ensemble members differ in architecture (pytree structure mismatch — check "
            "model.fusion / model.pos_guidance / dims)"
        )
    shapes = [tuple(tuple(t.shape) for t in p.parameters()) for p in params_list]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            f"ensemble members differ in parameter shapes (different dims or vocab): {shapes}"
        )
    return params_list


def combine_logp(logits_m: Sequence[torch.Tensor], block_unk: bool = False) -> torch.Tensor:
    """M member logits [..., V] (a sequence, or a tensor [M, ..., V]) ->
    [..., V] ensemble log-probs: the mean over members of
    log_softmax(mask_special_tokens(f32 logits)), summed in member order
    and divided by M (unnormalised: a monotone transform of the
    normalised mean, so argmax and beam ranking are unaffected)."""
    total = None
    for logits in logits_m:
        lp = torch.log_softmax(mask_special_tokens(logits.float(), block_unk), -1)
        total = lp if total is None else total + lp
    return total / len(logits_m)


class EnsembleGreedyLoop(decode_graphs.StepLoop):
    """The ensemble's greedy rollout split as the reference's scan
    (`infer/graphs.py`): inputs every member's context and summary and
    the decoder-step kernel's weight operands (made from the parameters on
    every call), carry (every member's h and c, the shared last token, the
    alive rows, the tokens), one step of every member and the argmax of
    their mean log-probs, finish = the tokens."""

    kind = "ensemble_greedy"

    def __init__(self, params_m, ctx_m, summary_m, max_len: int, block_unk: bool,
                 fused: Optional[bool]):
        self.members, self.ctxs, self.sums = tuple(params_m), tuple(ctx_m), tuple(summary_m)
        self.max_len, self.block_unk, self.fused = max_len, block_unk, bool(fused)
        self.device = self.sums[0].device

    def key_options(self) -> tuple:
        return (self.block_unk, self.fused)

    def modules(self) -> list:
        return list(self.members)

    def key_tensors(self) -> list:
        return [x for cx, s in zip(self.ctxs, self.sums) for x in (*cx, s)]

    def prepare(self) -> dict:
        return dict(ctx=list(self.ctxs), summary=list(self.sums),
                    kw=[attn_lstm_weights(p) if self.fused else None for p in self.members])

    def init(self) -> dict:
        b, dev = self.sums[0].shape[0], self.device
        h, c = map(list, zip(*(init_decoder_state(p, s)
                               for p, s in zip(self.members, self.inp["summary"]))))
        return dict(
            h=h, c=c, tok=torch.full((b,), BOS, dtype=torch.long, device=dev),
            alive=torch.ones((b,), dtype=torch.bool, device=dev),
            tokens=torch.full((b, self.max_len), PAD, dtype=torch.long, device=dev),
        )

    def step(self, carry: dict, t: int) -> None:
        inp, tok, alive = self.inp, carry["tok"], carry["alive"]
        outs = [
            decode_step(p, cx, tok, hh, cc, fused=self.fused, kernel_weights=w)
            for p, cx, hh, cc, w in zip(self.members, inp["ctx"], carry["h"], carry["c"],
                                        inp["kw"])
        ]
        nxt = torch.argmax(combine_logp([o[0] for o in outs], self.block_unk), dim=-1)
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        carry.update(h=[o[1] for o in outs], c=[o[2] for o in outs], tok=nxt,
                     alive=alive & (nxt != EOS))
        carry["tokens"][:, t] = nxt

    def done(self, carry: dict) -> torch.Tensor:
        return ~carry["alive"].any()

    def finish(self, carry: dict) -> torch.Tensor:
        return carry["tokens"]


def ensemble_greedy_decode(
    params_m,
    ctx_m,
    summary_m,
    max_len: int,
    block_unk: bool = False,
    early_stop: bool = False,
    fused: Optional[bool] = None,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """Greedy argmax over the members' mean log-probs -> tokens [B, L].

    `params_m`, `ctx_m` and `summary_m` are sequences of the members'
    `DecoderParams`, `DecodeContext` and summaries [B, He]. Each member
    advances its own LSTM state on the shared chosen token; `fused=True`
    takes each member's steps through the decoder-step kernel on weights
    made once a call. `early_stop=True` leaves once every row has emitted
    EOS. `graphs` overrides `set_decode_graphs` (see `infer/graphs.py`)."""
    loop = EnsembleGreedyLoop(params_m, ctx_m, summary_m, max_len, block_unk, fused)
    return decode_graphs.run(loop, max_len, early_stop, graphs)


# one code path serves members of one architecture and of several
hetero_greedy_decode = ensemble_greedy_decode


def make_ensemble_caption_fn(
    beam_size: int,
    max_pos_len: int,
    max_len: int,
    length_penalty: float = 0.0,
    block_unk: bool = False,
    early_stop: bool = True,
    return_all: bool = False,
    diversity_groups: int = 0,
    diversity_penalty: float = 0.5,
):
    """(params_m, app, motion, frame_mask=None, pos_tags=None) ->
    (tokens [B, L], pos_tags [B, Lp]), where `params_m` is a tuple of >= 2
    members' `CaptionerParams` on one device (`stack_params`, or members
    of different architectures sharing the vocab).

    The signature of `make_beam_caption_fn`'s function, so `evaluate_split`
    drives it unchanged. `beam_size <= 1` is greedy. Each member encodes
    the video and rolls out its own POS sequence (its psi must match its
    decoder); the tags returned are member 0's. With `pos_tags` every
    member is guided by the same tags through its own psi projection.
    `return_all=True` (beam only) -> (tokens [B, K, L], scores [B, K],
    tags), best-first."""
    from controllable_xgating_torch.ops.dispatch import fused_enabled

    if return_all and not (beam_size and beam_size > 1):
        raise ValueError("return_all requires beam_size > 1")
    fused = fused_enabled()

    @torch.inference_mode()
    def fn(params_m, app, motion, frame_mask=None, pos_tags=None):
        if len(params_m) < 2:
            raise ValueError("an ensemble needs at least two members")
        enc = [
            encode_for_inference(p, app, motion, frame_mask, pos_tags=pos_tags,
                                 max_pos_len=max_pos_len, fused=fused, early_stop=early_stop)
            for p in params_m
        ]
        decoders = tuple(p.decoder for p in params_m)
        ctx_m, summary_m = tuple(e[0] for e in enc), tuple(e[1] for e in enc)
        tags0 = enc[0][2]
        if beam_size and beam_size > 1:
            tokens, scores = beam_search(
                decoders, ctx_m, summary_m, beam_size, max_len, length_penalty, fused=fused,
                block_unk=block_unk, early_stop=early_stop, return_all=return_all,
                n_members=len(params_m), diversity_groups=diversity_groups,
                diversity_penalty=diversity_penalty,
            )
            if return_all:
                return tokens, scores, tags0
        else:
            tokens = ensemble_greedy_decode(decoders, ctx_m, summary_m, max_len,
                                            block_unk=block_unk, early_stop=early_stop,
                                            fused=fused)
        return tokens, tags0

    return fn


# one code path serves members of one architecture and of several
make_hetero_ensemble_caption_fn = make_ensemble_caption_fn


def make_auto_ensemble_caption_fn(params, *args, **kwargs):
    """The ensemble caption function for `params` as
    `cli.common.restore_ensemble_params` returns them. The JAX package
    picks its stacked or its tuple path here; the port has one path for
    both, so this is `make_ensemble_caption_fn(*args, **kwargs)`, kept for
    callers written against the JAX name."""
    return make_ensemble_caption_fn(*args, **kwargs)
