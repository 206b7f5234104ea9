"""The plain reference of the captioner: XGating fusion, BiLSTM encoder, POS
generator and attention-LSTM decoder, written out in PyTorch from the
paper's equations (arXiv:1908.10072, section 3).

It imports torch only. Parameters are a dict of tensors keyed by the
dotted names in `weight_spec`; the benchmark draws them from the seed
(`make_weights`) and hands the same draw to the program and to this
reference. Every matrix product goes through `Matmul`: f32 with TF32
off, or, for the control, operands rounded to float8 e4m3 with one
scale per tensor (amax / 448) and f32 sums.
"""

from __future__ import annotations

import math

import torch

PAD, BOS, EOS = 0, 1, 2
NEG = -1e30
FP8_MAX = 448.0


def dims(model: dict) -> dict:
    h = int(model["hidden_dim"])
    hd = h * int(model.get("decoder_hidden_mult", 1))
    return dict(da=int(model["app_dim"]), dm=int(model["motion_dim"]), h=h, he=2 * h, hd=hd,
                e=int(model["embed_dim"]), a=int(model["attn_dim"]), p=int(model["pos_embed_dim"]),
                v=int(model["vocab_size"]), vp=int(model["pos_vocab_size"]),
                t=int(model["num_frames"]))


def weight_spec(model: dict) -> list:
    """[(name, shape, init)] of every parameter, init one of ("u", bound),
    ("n", std), ("zero",) or ("lstm_b",): the paper's LSTM with its forget
    gate bias at 1. Uniform bounds are 1/sqrt(fan in)."""
    d = dims(model)
    h, he, hd, e, a, p, g = d["h"], d["he"], d["hd"], d["e"], d["a"], d["p"], d["hd"]
    u = lambda fan: ("u", 1.0 / math.sqrt(fan))
    z = ("zero",)

    def lstm(prefix, din, hid):
        return [(f"{prefix}.wih", (din, 4 * hid), u(din)), (f"{prefix}.whh", (hid, 4 * hid), u(hid)),
                (f"{prefix}.b", (4 * hid,), ("lstm_b",))]

    spec = [
        ("encoder.xgate.wa", (d["da"], h), u(d["da"])), ("encoder.xgate.ba", (h,), z),
        ("encoder.xgate.wm", (d["dm"], h), u(d["dm"])), ("encoder.xgate.bm", (h,), z),
        ("encoder.xgate.uga", (h, h), u(h)), ("encoder.xgate.bga", (h,), z),
        ("encoder.xgate.ugm", (h, h), u(h)), ("encoder.xgate.bgm", (h,), z),
        ("encoder.xgate.wf", (2 * h, h), u(2 * h)), ("encoder.xgate.bf", (h,), z),
    ]
    spec += lstm("encoder.lstm_fwd", h, h) + lstm("encoder.lstm_bwd", h, h)
    spec += [
        ("pos.embed", (d["vp"], e), ("n", 0.1)),
        ("pos.init_h", (he, h), u(he)), ("pos.init_c", (he, h), u(he)),
        ("pos.w_out", (h, d["vp"]), u(h)), ("pos.b_out", (d["vp"],), z),
        ("pos.w_psi", (h, p), u(h)), ("pos.b_psi", (p,), z),
    ]
    spec += lstm("pos.lstm", e + he, h)
    spec += [
        ("decoder.embed", (d["v"], e), ("n", 0.1)),
        ("decoder.init_h", (he, hd), u(he)), ("decoder.init_c", (he, hd), u(he)),
        ("decoder.w_ctx", (he, g), u(he)), ("decoder.w_psi", (p, g), u(p)),
        ("decoder.w_gate", (hd + e, g), u(hd + e)), ("decoder.b_gate", (g,), z),
        ("decoder.w_out", (hd, d["v"]), u(hd)), ("decoder.b_out", (d["v"],), z),
        ("decoder.attn.wq", (hd, a), u(hd)), ("decoder.attn.wk", (he, a), u(he)),
        ("decoder.attn.b", (a,), z), ("decoder.attn.v", (a,), u(a)),
    ]
    spec += lstm("decoder.lstm", e + g, hd)
    return spec


def make_weights(model: dict, seed: int, device) -> dict:
    """The parameters for `seed`, drawn on `device` in two calls (one
    uniform, one normal draw) and cut into leaves, f32."""
    spec = weight_spec(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    n_u = sum(math.prod(s) for _, s, i in spec if i[0] == "u")
    n_n = sum(math.prod(s) for _, s, i in spec if i[0] == "n")
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2.0).sub_(1.0)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "u":
            out[name] = uni[iu:iu + n].view(shape).mul_(init[1])
            iu += n
        elif init[0] == "n":
            out[name] = nor[inn:inn + n].view(shape).mul_(init[1])
            inn += n
        else:
            t = torch.zeros(shape, device=device)
            if init[0] == "lstm_b":
                hid = shape[0] // 4
                t[hid:2 * hid] = 1.0
            out[name] = t
    return out


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor (amax / 448);
    the gradient passes through the rounding unchanged."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Matmul:
    """a [..., K] @ b [K, N] in f32 with TF32 off; `fp8=True` rounds both
    operands to float8 e4m3 first (the control's precision)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a.float(), b.float())


def lstm_cell(mm, w: dict, prefix: str, gates_in, h, c):
    """gates_in is x @ wih (or its parts); gate order i, f, g, o."""
    hid = h.shape[-1]
    gates = gates_in + mm(h, w[prefix + ".whh"]) + w[prefix + ".b"]
    i = torch.sigmoid(gates[:, :hid])
    f = torch.sigmoid(gates[:, hid:2 * hid])
    g = torch.tanh(gates[:, 2 * hid:3 * hid])
    o = torch.sigmoid(gates[:, 3 * hid:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def xgate(mm, w: dict, app, motion):
    """Cross-gated fusion [B, T, Da], [B, T, Dm] -> [B, T, H]."""
    p = "encoder.xgate."
    ea = mm(app, w[p + "wa"]) + w[p + "ba"]
    em = mm(motion, w[p + "wm"]) + w[p + "bm"]
    ga = torch.sigmoid(mm(em, w[p + "uga"]) + w[p + "bga"])
    gm = torch.sigmoid(mm(ea, w[p + "ugm"]) + w[p + "bgm"])
    h = w[p + "wf"].shape[0] // 2
    return torch.tanh(mm(ea * ga, w[p + "wf"][:h]) + mm(em * gm, w[p + "wf"][h:]) + w[p + "bf"])


def encode(mm, w: dict, app, motion, keep=None, rate: float = 0.0):
    """(enc_out [B, T, 2H], summary [B, 2H]); every frame valid. `keep`
    [B, T, H] is the dropout keep-mask of the fused features."""
    x = xgate(mm, w, app, motion)
    if keep is not None:
        x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    b, t, h = x.shape
    outs = []
    for prefix, order in (("encoder.lstm_fwd", range(t)), ("encoder.lstm_bwd", range(t - 1, -1, -1))):
        hs = [None] * t
        hh = x.new_zeros((b, h))
        cc = x.new_zeros((b, h))
        for s in order:
            hh, cc = lstm_cell(mm, w, prefix, mm(x[:, s], w[prefix + ".wih"]), hh, cc)
            hs[s] = hh
        outs.append(torch.stack(hs, 1))
    enc_out = torch.cat(outs, -1)
    return enc_out, enc_out.mean(1)


def pos_pass(mm, w: dict, summary, tags, rollout: bool):
    """The POS generator over tag inputs. `rollout=False` is the teacher-
    forced pass over tags [B, Lp] (BOS first): (logits [B, Lp-1, Vp], psi),
    psi pooled over the steps whose input is not PAD. `rollout=True` forces
    the greedy rollout's outputs tags [B, L] (BOS not included): (logits
    [B, L, Vp] with PAD and BOS masked, alive [B, L], psi), psi pooled over
    the steps taken before the row emitted EOS."""
    e_dim = w["pos.embed"].shape[1]
    wih = w["pos.lstm.wih"]
    h = torch.tanh(mm(summary, w["pos.init_h"]))
    c = torch.tanh(mm(summary, w["pos.init_c"]))
    s_gates = mm(summary, wih[e_dim:])
    b = summary.shape[0]
    if rollout:
        inputs = torch.cat([torch.full((b, 1), BOS, dtype=torch.long, device=tags.device),
                            tags[:, :-1].long()], 1)
    else:
        inputs = tags[:, :-1].long()
    steps = inputs.shape[1]
    alive = torch.ones(b, dtype=torch.bool, device=summary.device)
    hs, logits, mask = [], [], []
    for t in range(steps):
        e = w["pos.embed"][inputs[:, t]]
        h, c = lstm_cell(mm, w, "pos.lstm", mm(e, wih[:e_dim]) + s_gates, h, c)
        z = mm(h, w["pos.w_out"]) + w["pos.b_out"]
        if rollout:
            z = z.clone()
            z[:, PAD] = NEG
            z[:, BOS] = NEG
            mask.append(alive)
            alive = alive & (tags[:, t] != EOS)
        else:
            mask.append(inputs[:, t] != PAD)
        hs.append(h)
        logits.append(z)
    hs = torch.stack(hs, 1)
    m = torch.stack(mask, 1)
    mf = m.float()[:, :, None]
    pooled = (hs * mf).sum(1) / torch.clamp(mf.sum(1), min=1.0)
    psi = torch.tanh(mm(pooled, w["pos.w_psi"]) + w["pos.b_psi"])
    logits = torch.stack(logits, 1)
    return (logits, m, psi) if rollout else (logits, psi)


def pos_greedy(mm, w: dict, summary, max_len: int):
    """The greedy POS rollout: (tags [B, max_len], psi)."""
    e_dim = w["pos.embed"].shape[1]
    wih = w["pos.lstm.wih"]
    h = torch.tanh(mm(summary, w["pos.init_h"]))
    c = torch.tanh(mm(summary, w["pos.init_c"]))
    s_gates = mm(summary, wih[e_dim:])
    b = summary.shape[0]
    tok = torch.full((b,), BOS, dtype=torch.long, device=summary.device)
    alive = torch.ones(b, dtype=torch.bool, device=summary.device)
    tags, hs, mask = [], [], []
    for _ in range(max_len):
        mask.append(alive)
        h, c = lstm_cell(mm, w, "pos.lstm", mm(w["pos.embed"][tok], wih[:e_dim]) + s_gates, h, c)
        z = mm(h, w["pos.w_out"]) + w["pos.b_out"]
        z[:, PAD] = NEG
        z[:, BOS] = NEG
        nxt = torch.where(alive, z.argmax(-1), torch.full_like(tok, PAD))
        alive = alive & (nxt != EOS)
        tags.append(nxt)
        hs.append(h)
        tok = nxt
    hs = torch.stack(hs, 1)
    mf = torch.stack(mask, 1).float()[:, :, None]
    pooled = (hs * mf).sum(1) / torch.clamp(mf.sum(1), min=1.0)
    return torch.stack(tags, 1), torch.tanh(mm(pooled, w["pos.w_psi"]) + w["pos.b_psi"])


def decode_context(mm, w: dict, enc_out, psi):
    return dict(enc_proj=mm(enc_out, w["decoder.w_ctx"]), keys=mm(enc_out, w["decoder.attn.wk"]),
                psi_g=mm(psi, w["decoder.w_psi"]))


def decoder_init(mm, w: dict, summary):
    return torch.tanh(mm(summary, w["decoder.init_h"])), torch.tanh(mm(summary, w["decoder.init_c"]))


def decoder_hidden(mm, w: dict, ctx: dict, e, h, c):
    """Attention over the frames, the syntax gate and the LSTM cell on the
    embedded word e: (h', c')."""
    q = mm(h, w["decoder.attn.wq"])
    act = torch.tanh(q[:, None, :] + ctx["keys"] + w["decoder.attn.b"])
    alpha = torch.softmax((act * w["decoder.attn.v"]).sum(-1), -1)
    vis = torch.einsum("bt,btg->bg", alpha, ctx["enc_proj"])
    gate = torch.sigmoid(mm(torch.cat([h, e], -1), w["decoder.w_gate"]) + w["decoder.b_gate"])
    guide = gate * vis + (1.0 - gate) * ctx["psi_g"]
    x = torch.cat([e, guide], -1)
    return lstm_cell(mm, w, "decoder.lstm", mm(x, w["decoder.lstm.wih"]), h, c)


def logits_out(mm, w: dict, h):
    return mm(h, w["decoder.w_out"]) + w["decoder.b_out"]


def mask_special(z):
    z = z.clone()
    z[:, PAD] = NEG
    z[:, BOS] = NEG
    return z
