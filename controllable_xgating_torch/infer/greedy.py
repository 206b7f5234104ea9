"""Greedy and multinomial caption decoding.

Counterpart of `controllable_xgating_tpu/infer/greedy.py` (`greedy_decode`,
`sample_decode` and `mask_special_tokens` on one shared rollout, and SCST's
`paired_rollout`). A Python
loop stands in for the scan; with `early_stop=True` it leaves once every
row has emitted EOS, which costs one host sync per step. Tokens after EOS
are PAD.

`sample_decode` draws from a caller's `torch.Generator`, so its samples
are not JAX's for the same seed (another random stream); the same
generator state gives the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD, UNK
from controllable_xgating_torch.experiments.int8_vocab_matmul import with_kernel_operand
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared rollout: argmax without a generator, else multinomial draws
    from softmax(masked logits / temperature). Returns (tokens [B, L]
    int64, logprobs [B, L] f32); greedy's logprobs are 0.

    `lanes=True` (None = off, as in the JAX package) takes pure-greedy
    steps through the top-K tail kernel's wrapper at k = 1, which projects,
    masks and reduces without writing the [B, V] logits; it needs no
    generator, no `vocab_q`, and a decoder width the kernel takes
    (`lanes_fits`)."""
    b = summary.shape[0]
    dev = summary.device
    h, c = init_decoder_state(params, summary)
    tok = torch.full((b,), BOS, dtype=torch.long, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    tokens = torch.full((b, max_len), PAD, dtype=torch.long, device=dev)
    logps = torch.zeros((b, max_len), dtype=torch.float32, device=dev)
    use_lanes = bool(lanes) and generator is None and vocab_q is None \
        and lanes_fits(1, params.w_out.shape[0])
    kw = attn_lstm_weights(params) if fused else None
    w_op = topk_tail_weights(params.w_out) if use_lanes else None
    if fused and vocab_q is not None:
        vocab_q = with_kernel_operand(vocab_q)  # the int8 kernel's K-major weight, once
    for t in range(max_len):
        if early_stop and not bool(alive.any()):
            break
        if use_lanes:
            h_out, h, c, _ = decode_step(
                params, ctx, tok, h, c, fused=fused, return_hidden=True, kernel_weights=kw
            )
            nxt = logits_topk(h_out, params.w_out, params.b_out, 1, block_unk, w_op)[1][:, 0]
        else:
            logits, h, c, _ = decode_step(
                params, ctx, tok, h, c, fused=fused, kernel_weights=kw, vocab_q=vocab_q
            )
            logits = mask_special_tokens(logits.float(), block_unk)
            if generator is None:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
                # logprob under the untempered model: gather - logsumexp
                logp = logits.gather(1, nxt[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
                logps[:, t] = torch.where(alive, logp, torch.zeros_like(logp))
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        alive = alive & (nxt != EOS)
        tokens[:, t] = nxt
        tok = nxt
    return tokens, logps


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
) -> torch.Tensor:
    """Deterministic argmax rollout -> tokens [B, max_len] int64. `vocab_q`
    (a `QuantVocabProj`) takes every step's vocab projection through the
    weight-only int8 path; `lanes=True` takes each step's projection and
    argmax through the top-K tail kernel at k = 1 (see `_rollout`)."""
    tokens, _ = _rollout(params, ctx, summary, max_len, None, 1.0, fused, block_unk, early_stop,
                         vocab_q, lanes)
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
    finished). `generator` lives on the parameters' device."""
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
