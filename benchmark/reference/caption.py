"""The reference's side of the caption cell: judging served captions, and
a plain beam search.

`judge` runs the reference once over each video with the tags and the
caption the program served for it, and reads four numbers:

  tag_gap      the widest gap by which a served POS tag's logit lies
               below the reference's best at its position (the rollout is
               greedy, so the served tag is the best up to rounding);
  caption_gap  the widest gap by which a served word's logit lies below
               the reference's K-th best at its position: a beam of width
               K extends a hypothesis only by one of its K best words, so
               up to rounding every word of the best caption is among them;
  beam_differs the share of the videos whose served caption is not the
               one the reference's own beam search of width K picks for the
               video from the same tags: the beam's selection across its
               rows. Rounding flips a pruning between near-tied hypotheses
               on a minority of videos; a wrong selection rule, or a lower
               precision, moves nearly all. (A gap of log-probabilities
               tells neither apart: a flip can lose a finished short
               hypothesis worth tens, and a lower precision's pick lies
               above the reference's as often as below. Its mean and widest
               are reported beside it, as `beam_gap_mean` and
               `beam_gap_max`);
  score_gap    the widest gap between the score the program reported for
               its caption and the reference's log-probability of it: the
               cumulative scores the selection ranks by.

Positions after a row's EOS are not read. The program's own tags drive
the reference's POS pass (its psi is worked out from them), so that a
flip between near-tied tags does not move the caption's gaps.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M


@torch.no_grad()
def judge(w: dict, app, motion, tags, tokens, scores, beam: int, block: int = 256,
          mm=None) -> dict:
    """Gaps of served `tags` [N, Lp], `tokens` [N, L] and `scores` [N]
    (host or device tensors or arrays) for features `app`, `motion`
    [N, T, D] (f32)."""
    mm = mm or M.Matmul()
    dev = w["decoder.w_out"].device
    worst = dict(tag_gap=0.0, caption_gap=0.0, score_gap=0.0)
    sum_cap, n_cap, n_differ, shorts = 0.0, 0, 0, []
    for s in range(0, app.shape[0], block):
        a = torch.as_tensor(app[s:s + block], device=dev).float()
        m = torch.as_tensor(motion[s:s + block], device=dev).float()
        tg = torch.as_tensor(tags[s:s + block], device=dev).long()
        tk = torch.as_tensor(tokens[s:s + block], device=dev).long()
        sc = torch.as_tensor(scores[s:s + block], device=dev).float()
        enc_out, summary = M.encode(mm, w, a, m)
        z, alive, psi = M.pos_pass(mm, w, summary, tg, rollout=True)
        served = torch.gather(z, 2, tg[:, :, None])[..., 0]
        gap = (z.max(-1).values - served)[alive]
        if gap.numel():
            worst["tag_gap"] = max(worst["tag_gap"], float(gap.max()))
        ctx = M.decode_context(mm, w, enc_out, psi)
        h, c = M.decoder_init(mm, w, summary)
        prev = torch.full((a.shape[0],), M.BOS, dtype=torch.long, device=dev)
        live = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
        served_lp = torch.zeros(a.shape[0], device=dev)
        for t in range(tk.shape[1]):
            h, c = M.decoder_hidden(mm, w, ctx, w["decoder.embed"][prev], h, c)
            zc = M.mask_special(M.logits_out(mm, w, h))
            kth = torch.topk(zc, beam, dim=-1).values[:, -1]
            y = tk[:, t]
            live = live & (y != M.PAD)
            z_y = torch.gather(zc, 1, y[:, None])[:, 0]
            served_lp += torch.where(live, z_y - torch.logsumexp(zc, -1), 0.0)
            g = torch.clamp(kth - z_y, min=0.0)[live]
            if g.numel():
                worst["caption_gap"] = max(worst["caption_gap"], float(g.max()))
                sum_cap += float(g.sum())
                n_cap += int(g.numel())
            live = live & (y != M.EOS)
            prev = y
        best_tokens, best_lp = beam_search(mm, w, ctx, summary, beam, tk.shape[1])
        shorts.append(torch.clamp(best_lp - served_lp, min=0.0).cpu())
        worst["score_gap"] = max(worst["score_gap"], float((sc - served_lp).abs().max()))
        n_differ += int((best_tokens != tk).any(1).sum())
    short = torch.cat(shorts)
    return {**worst, "beam_differs": n_differ / short.numel(),
            "caption_gap_mean": sum_cap / max(n_cap, 1), "beam_gap_mean": float(short.mean()),
            "beam_gap_max": float(short.max()), "positions": n_cap}


def beam_search(mm, w: dict, ctx: dict, summary, beam: int, max_len: int) -> tuple:
    """(tokens [B, max_len], scores [B]) of a plain beam search of width
    `beam` over the decode context `ctx` of B videos: the PAD continuation
    at zero cost for finished beams, one top-K over every beam's candidates
    per video, and the best finished hypothesis kept beside the pool; the
    score is the caption's summed log-probability."""
    dev = summary.device
    b, k = summary.shape[0], beam
    rep = lambda x: x.repeat_interleave(k, 0)
    ctx = {n: rep(x) for n, x in ctx.items()}
    h, c = M.decoder_init(mm, w, rep(summary))
    v = w["decoder.w_out"].shape[1]
    cont = torch.where(torch.arange(v, device=dev) == M.PAD, 0.0, M.NEG)
    rows = torch.arange(b, device=dev)
    tok = torch.full((b, k), M.BOS, dtype=torch.long, device=dev)
    cum = torch.where(torch.arange(k, device=dev) == 0, 0.0, M.NEG).repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    hist = torch.full((b, k, max_len), M.PAD, dtype=torch.long, device=dev)
    reg_score = torch.full((b,), M.NEG, device=dev)
    reg_tokens = torch.full((b, max_len), M.PAD, dtype=torch.long, device=dev)
    for t in range(max_len):
        h, c = M.decoder_hidden(mm, w, ctx, w["decoder.embed"][tok.reshape(-1)], h, c)
        logp = torch.log_softmax(M.mask_special(M.logits_out(mm, w, h)), -1)
        logp = torch.where(finished.reshape(-1)[:, None], cont, logp)
        cand = (cum.reshape(-1)[:, None] + logp).reshape(b, k * v)
        top, idx = torch.topk(cand, k, dim=-1)
        src, new = idx // v, idx % v
        fin_g = torch.gather(finished, 1, src)
        hist = hist[rows[:, None], src]
        now_fin = fin_g | (new == M.EOS)
        emit = torch.where(fin_g, torch.full_like(new, M.PAD), new)
        hist[:, :, t] = emit
        just = now_fin & ~fin_g
        sc = torch.where(just, top, torch.full_like(top, M.NEG))
        best = sc.argmax(1)
        row_score = sc[rows, best]
        better = row_score > reg_score
        reg_score = torch.where(better, row_score, reg_score)
        reg_tokens = torch.where(better[:, None], hist[rows, best], reg_tokens)
        flat = (rows[:, None] * k + src).reshape(-1)
        h, c = h[flat], c[flat]
        tok, cum, finished = emit, top, now_fin
    best = cum.argmax(1)
    out, score = hist[rows, best], cum[rows, best]
    use_reg = reg_score > score
    return torch.where(use_reg[:, None], reg_tokens, out), torch.where(use_reg, reg_score, score)


@torch.no_grad()
def beam_decode(w: dict, app, motion, beam: int, max_len: int, max_pos_len: int, mm) -> tuple:
    """(tokens [B, max_len], tags [B, max_pos_len], scores [B]): the
    reference in the program's place, greedy POS rollout then beam search,
    every product through `mm`."""
    dev = w["decoder.w_out"].device
    a = torch.as_tensor(app, device=dev).float()
    m = torch.as_tensor(motion, device=dev).float()
    enc_out, summary = M.encode(mm, w, a, m)
    tags, psi = M.pos_greedy(mm, w, summary, max_pos_len)
    tokens, scores = beam_search(mm, w, M.decode_context(mm, w, enc_out, psi), summary, beam,
                                 max_len)
    return tokens, tags, scores
