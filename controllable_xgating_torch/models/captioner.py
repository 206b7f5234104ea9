"""Full captioner: XGating encoder + POS generator + attention-LSTM decoder.

Counterpart of `controllable_xgating_tpu/models/captioner.py`. The
parameter tree is one `nn.Module` whose dotted parameter names equal the
JAX package's pytree paths (`encoder.xgate.wa`, `decoder.lstm.wih`, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.models.decoder import (
    DecoderParams,
    decoder_forward,
    init_decoder,
    make_decode_context,
)
from controllable_xgating_torch.models.encoder import EncoderParams, encode, init_encoder
from controllable_xgating_torch.models.pos_generator import (
    PosGeneratorParams,
    init_pos_generator,
    pos_forward,
    pos_greedy_generate,
)
from controllable_xgating_torch.utils.spans import span


class CaptionerParams(nn.Module):
    def __init__(self, encoder: EncoderParams, pos: PosGeneratorParams, decoder: DecoderParams):
        super().__init__()
        self.encoder = encoder
        self.pos = pos
        self.decoder = decoder


def init_captioner(cfg, seed: Optional[int] = 0, device="cuda") -> CaptionerParams:
    """Random f32 parameters with the JAX package's shapes and
    distributions, drawn on the CPU from a seeded `torch.Generator` (so the
    same seed gives the same weights on any device), then moved to
    `device`: the card unless the caller asks for the CPU. `seed=None`
    draws nothing: the parameters are uninitialised storage of the same
    shapes, for a checkpoint to fill. `cfg` is a `ModelConfig` or a `Config`."""
    with span("setup.init"):
        cfg = getattr(cfg, "model", cfg)
        if cfg.vocab_size <= 0 or cfg.pos_vocab_size <= 0:
            raise ValueError("cfg.vocab_size / cfg.pos_vocab_size must be set")
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        encoder = init_encoder(
            gen, cfg.app_dim, cfg.motion_dim, cfg.hidden_dim, cfg.encoder_bidirectional,
            fusion=cfg.fusion,
        )
        enc_dim = encoder.out_dim
        pos = init_pos_generator(
            gen, cfg.pos_vocab_size, enc_dim, cfg.hidden_dim, cfg.embed_dim, cfg.pos_embed_dim,
        )
        decoder = init_decoder(
            gen, cfg.vocab_size, enc_dim, cfg.hidden_dim * cfg.decoder_hidden_mult,
            cfg.embed_dim, cfg.attn_dim, cfg.pos_embed_dim, use_psi=cfg.pos_guidance,
        )
        return CaptionerParams(encoder, pos, decoder).to(device)


def xe_logits(
    params: CaptionerParams,
    app: torch.Tensor,       # [B, T, Da]
    motion: torch.Tensor,    # [B, T, Dm]
    captions: torch.Tensor,  # [B, L]
    pos_tags: torch.Tensor,  # [B, Lp] ground-truth tags (teacher psi)
    frame_mask: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
):
    """Teacher-forced caption + POS logits for joint or staged XE training:
    (cap_logits [B, L-1, V], pos_logits [B, Lp-1, Vp]). Dropout masks are
    drawn from `gen`, the encoder's first."""
    enc_out, summary = encode(params.encoder, app, motion, frame_mask, gen=gen,
                              dropout_rate=dropout_rate)
    pos_logits, psi = pos_forward(params.pos, summary, pos_tags)
    ctx = make_decode_context(params.decoder, enc_out, psi, frame_mask)
    cap_logits = decoder_forward(params.decoder, ctx, summary, captions, gen, dropout_rate)
    return cap_logits, pos_logits


def encode_for_inference(
    params: CaptionerParams,
    app: torch.Tensor,
    motion: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    pos_tags: Optional[torch.Tensor] = None,
    max_pos_len: int = 28,
    fused: Optional[bool] = None,
    early_stop: bool = False,
    use_tags: Optional[torch.Tensor] = None,
):
    """Shared inference prolog: encode, derive psi, build the decode context.

    psi comes from `pos_tags` when given (controllability), else from the
    greedy POS rollout; `use_tags` (bool [B], needs `pos_tags`) mixes the
    two per row. Returns (ctx, summary, pos_tags_out). Spans
    (`utils/spans.py`, all timed on the card): `encode` around the whole,
    with `encode.fuse` and `encode.bilstm` (in `encode`), `pos.rollout` or
    `pos.forward`, and `encode.context` inside it."""
    with span("encode", device=True):
        enc_out, summary = encode(params.encoder, app, motion, frame_mask, fused_kernels=fused)
        if use_tags is not None:
            if pos_tags is None:
                raise ValueError("use_tags requires pos_tags")
            with span("pos.rollout", device=True):
                tags_gen, psi_gen = pos_greedy_generate(
                    params.pos, summary, max_pos_len, early_stop=early_stop, fused=fused
                )
            with span("pos.forward", device=True):
                _, psi_user = pos_forward(params.pos, summary, pos_tags)
            psi = torch.where(use_tags[:, None], psi_user, psi_gen)
            tags_out = torch.where(use_tags[:, None], pos_tags.long(), tags_gen)
        elif pos_tags is not None:
            with span("pos.forward", device=True):
                _, psi = pos_forward(params.pos, summary, pos_tags)
            tags_out = pos_tags
        else:
            with span("pos.rollout", device=True):
                tags_out, psi = pos_greedy_generate(
                    params.pos, summary, max_pos_len, early_stop=early_stop, fused=fused
                )
        with span("encode.context", device=True):
            ctx = make_decode_context(params.decoder, enc_out, psi, frame_mask)
    return ctx, summary, tags_out
