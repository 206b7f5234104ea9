"""Greedy and multinomial caption decoding.

Counterpart of `controllable_xgating_tpu/infer/greedy.py` (`greedy_decode`,
`sample_decode` and `mask_special_tokens` on one shared rollout, and SCST's
`paired_rollout`). The rollout is split as the reference's scan
(`RolloutLoop`) and runs through `infer/graphs.py`: greedy's on the card
as replayed CUDA graphs of chunks of steps, on the CPU as an eager loop
that, with `early_stop=True`, leaves once every row has emitted EOS. The
multinomial rollouts stay eager loops (one host sync a step under
`early_stop`). Tokens after EOS are PAD.

`sample_decode` draws from a caller's `torch.Generator`, so its samples
are not JAX's for the same seed (another random stream); the same
generator state gives the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD, UNK
from controllable_xgating_torch.experiments.int8_vocab_matmul import with_kernel_operand
from controllable_xgating_torch.infer import graphs as decode_graphs
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
    topk_tail_weights,
)

_MASK_NEG = -1e30


def mask_special_tokens(logits: torch.Tensor, block_unk: bool = False) -> torch.Tensor:
    """Forbid PAD/BOS as outputs (and UNK with `block_unk`). Returns a copy."""
    out = logits.clone()
    out[..., PAD] = _MASK_NEG
    out[..., BOS] = _MASK_NEG
    if block_unk:
        out[..., UNK] = _MASK_NEG
    return out


class RolloutLoop(decode_graphs.StepLoop):
    """The shared rollout split as the reference's scan
    (`infer/graphs.py`): inputs ctx and summary (and the kernels' weight
    operands, made from the parameters on every call), carry (h, c, the
    last token, the alive rows, the tokens and their logprobs), one step,
    finish = (tokens [B, L] int64, logprobs [B, L] f32). Argmax without a
    generator (greedy's logprobs are 0), else multinomial draws from
    softmax(masked logits / temperature); a rollout with a generator runs
    the eager loop (its logprobs may carry gradient).

    `lanes=True` (None = off, as in the JAX package) takes pure-greedy
    steps through the top-K tail kernel's wrapper at k = 1, which projects,
    masks and reduces without writing the [B, V] logits; it needs no
    generator, no `vocab_q`, and a decoder width the kernel takes
    (`lanes_fits`)."""

    kind = "greedy"
    raw = ("ctx", "summary", "vocab_q")

    def __init__(self, params: DecoderParams, ctx: DecodeContext, summary: torch.Tensor,
                 max_len: int, generator: Optional[torch.Generator], temperature: float,
                 fused: Optional[bool], block_unk: bool, vocab_q, lanes: Optional[bool]):
        self.params, self.ctx, self.summary, self.vocab_q = params, ctx, summary, vocab_q
        self.max_len, self.generator, self.temperature = max_len, generator, temperature
        self.fused, self.block_unk = bool(fused), block_unk
        self.lanes = bool(lanes) and generator is None and vocab_q is None \
            and lanes_fits(1, params.w_out.shape[0])
        self.device = summary.device

    def key_options(self) -> tuple:
        return (self.fused, self.block_unk, self.lanes, self.vocab_q is not None)

    def modules(self) -> list:
        return [self.params]

    def prepare(self) -> dict:
        p, q = self.params, self.vocab_q
        if self.fused and q is not None:
            q = with_kernel_operand(q)  # the int8 kernel's K-major weight
        return dict(
            ctx=self.ctx, summary=self.summary, vocab_q=q,
            kw=attn_lstm_weights(p) if self.fused else None,
            w_op=topk_tail_weights(p.w_out) if self.lanes else None,
        )

    def init(self) -> dict:
        summary = self.inp["summary"]
        b, dev = summary.shape[0], summary.device
        h, c = init_decoder_state(self.params, summary)
        return dict(
            h=h, c=c, tok=torch.full((b,), BOS, dtype=torch.long, device=dev),
            alive=torch.ones((b,), dtype=torch.bool, device=dev),
            tokens=torch.full((b, self.max_len), PAD, dtype=torch.long, device=dev),
            logps=torch.zeros((b, self.max_len), dtype=torch.float32, device=dev),
        )

    def step(self, carry: dict, t: int) -> None:
        p, inp, alive = self.params, self.inp, carry["alive"]
        if self.lanes:
            h_out, h, c, _ = decode_step(p, inp["ctx"], carry["tok"], carry["h"], carry["c"],
                                         fused=self.fused, return_hidden=True,
                                         kernel_weights=inp["kw"])
            nxt = logits_topk(h_out, p.w_out, p.b_out, 1, self.block_unk, inp["w_op"])[1][:, 0]
        else:
            logits, h, c, _ = decode_step(p, inp["ctx"], carry["tok"], carry["h"], carry["c"],
                                          fused=self.fused, kernel_weights=inp["kw"],
                                          vocab_q=inp["vocab_q"])
            logits = mask_special_tokens(logits.float(), self.block_unk)
            if self.generator is None:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
                # logprob under the untempered model: gather - logsumexp
                logp = logits.gather(1, nxt[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
                carry["logps"][:, t] = torch.where(alive, logp, torch.zeros_like(logp))
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        carry.update(h=h, c=c, tok=nxt, alive=alive & (nxt != EOS))
        carry["tokens"][:, t] = nxt

    def done(self, carry: dict) -> torch.Tensor:
        return ~carry["alive"].any()

    def finish(self, carry: dict):
        return carry["tokens"], carry["logps"]


def _rollout(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,
    max_len: int,
    generator: Optional[torch.Generator],
    temperature: float,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = False,
    vocab_q=None,
    lanes: Optional[bool] = None,
    graphs: Optional[bool] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared rollout (`RolloutLoop`) -> (tokens [B, L] int64, logprobs
    [B, L] f32), through `infer/graphs.py`; with a generator always the
    eager loop."""
    loop = RolloutLoop(params, ctx, summary, max_len, generator, temperature, fused, block_unk,
                       vocab_q, lanes)
    return decode_graphs.run(loop, max_len, early_stop, graphs if generator is None else False)


def greedy_decode(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,
    max_len: int,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = False,
    vocab_q=None,
    lanes: Optional[bool] = None,
    graphs: Optional[bool] = None,
) -> torch.Tensor:
    """Deterministic argmax rollout -> tokens [B, max_len] int64. `vocab_q`
    (a `QuantVocabProj`) takes every step's vocab projection through the
    weight-only int8 path; `lanes=True` takes each step's projection and
    argmax through the top-K tail kernel at k = 1 (see `RolloutLoop`).
    `graphs` overrides `set_decode_graphs` (None = auto: replayed CUDA
    graphs for CUDA tensors, the eager loop for CPU tensors)."""
    tokens, _ = _rollout(params, ctx, summary, max_len, None, 1.0, fused, block_unk, early_stop,
                         vocab_q, lanes, graphs)
    return tokens


def sample_decode(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,
    max_len: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    block_unk: bool = False,
    fused: Optional[bool] = None,
    early_stop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multinomial rollout at `temperature` -> (tokens [B, L] int64,
    logprobs [B, L] f32, each under the untempered model; 0 where a row has
    finished). `generator` lives on the parameters' device. An eager loop
    on every device: one host sync a step under `early_stop`."""
    return _rollout(params, ctx, summary, max_len, generator, temperature, fused, block_unk,
                    early_stop)


def paired_rollout(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,
    max_len: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    fused: Optional[bool] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SCST's greedy baseline and multinomial sample as one rollout of 2B
    rows, without gradient -> (greedy tokens [B, L], sample tokens [B, L]).

    Rows :B take the argmax, rows B: draw one `torch.multinomial` a step on
    their [B, V] slice from `generator`, as `sample_decode` does, so the
    same generator state gives `greedy_decode`'s and `sample_decode`'s
    tokens. No logprobs: SCST recomputes logp(sample) teacher-forced.
    `fused=True` takes every step through the decoder-step kernel's
    wrapper at 2B rows, on weights packed once."""
    b = summary.shape[0]
    dev = summary.device
    with torch.no_grad():
        ctx2 = DecodeContext(*(None if x is None else torch.cat([x, x]) for x in ctx))
        h, c = init_decoder_state(params, torch.cat([summary, summary]))
        tok = torch.full((2 * b,), BOS, dtype=torch.long, device=dev)
        alive = torch.ones((2 * b,), dtype=torch.bool, device=dev)
        tokens = torch.full((2 * b, max_len), PAD, dtype=torch.long, device=dev)
        kw = attn_lstm_weights(params) if fused else None
        for t in range(max_len):
            logits, h, c, _ = decode_step(params, ctx2, tok, h, c, fused=fused, kernel_weights=kw)
            logits = mask_special_tokens(logits.float())
            probs = torch.softmax(logits[b:] / temperature, dim=-1)
            nxt = torch.cat([torch.argmax(logits[:b], dim=-1),
                             torch.multinomial(probs, 1, generator=generator)[:, 0]])
            nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
            alive = alive & (nxt != EOS)
            tokens[:, t] = nxt
            tok = nxt
    return tokens[:b], tokens[b:]
