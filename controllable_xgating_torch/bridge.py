"""Weight bridge between the JAX package's parameter tree and the port's.

Keys are the dotted pytree paths of the JAX `CaptionerParams`, as
`tools/import_torch_checkpoint.py::param_paths` spells them
(`encoder.xgate.wa`, `pos.lstm.wih`, `decoder.attn.v`, ...). The port's
`nn.Module` tree has the same names and the same `[in, out]` layout, so
nothing is transposed. The two static fields come from the config:
`encoder.xgate.mode` from `model.fusion`, `decoder.use_psi` from
`model.pos_guidance`; a tree without `encoder.lstm_bwd.*` keys gives a
unidirectional encoder.

`param_paths` lists the port's parameters in the JAX tree's order, so a
tool prints them as the JAX tool does. The JAX side (flattening a pytree
to numpy) lives with the tests and `convert_jax_checkpoint.py`, where jax
is installed; this module needs only numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from controllable_xgating_torch.models.captioner import CaptionerParams
from controllable_xgating_torch.models.decoder import DecoderParams
from controllable_xgating_torch.models.encoder import EncoderParams
from controllable_xgating_torch.models.pos_generator import PosGeneratorParams
from controllable_xgating_torch.ops.attention import AttentionWeights
from controllable_xgating_torch.ops.lstm import LSTMWeights
from controllable_xgating_torch.ops.xgate import XGateWeights

_XGATE = ("wa", "ba", "wm", "bm", "uga", "bga", "ugm", "bgm", "wf", "bf")
_LSTM = ("wih", "whh", "b")
_POS = ("embed", "init_h", "init_c", "w_out", "b_out", "w_psi", "b_psi")
_DEC = ("embed", "init_h", "init_c", "w_ctx", "w_psi", "w_gate", "b_gate", "w_out", "b_out")


def from_numpy(tree: dict, cfg) -> CaptionerParams:
    """{dotted path: array} -> CaptionerParams (f32 copies on the CPU)."""
    m = getattr(cfg, "model", cfg)
    used = set()

    def get(name):
        if name not in tree:
            raise KeyError(f"weight tree has no {name!r}")
        used.add(name)
        return torch.from_numpy(np.array(tree[name], dtype=np.float32, copy=True))

    def lstm(prefix):
        return LSTMWeights(*(get(f"{prefix}.{n}") for n in _LSTM))

    bidirectional = "encoder.lstm_bwd.wih" in tree
    encoder = EncoderParams(
        xgate=XGateWeights(*(get(f"encoder.xgate.{n}") for n in _XGATE), mode=m.fusion),
        lstm_fwd=lstm("encoder.lstm_fwd"),
        lstm_bwd=lstm("encoder.lstm_bwd") if bidirectional else None,
    )
    p = {n: get(f"pos.{n}") for n in _POS}
    pos = PosGeneratorParams(
        p["embed"], p["init_h"], p["init_c"], lstm("pos.lstm"), p["w_out"], p["b_out"],
        p["w_psi"], p["b_psi"],
    )
    d = {n: get(f"decoder.{n}") for n in _DEC}
    attn = AttentionWeights(*(get(f"decoder.attn.{n}") for n in ("wq", "wk", "b", "v")))
    decoder = DecoderParams(
        d["embed"], d["init_h"], d["init_c"], attn, d["w_ctx"], d["w_psi"], d["w_gate"],
        d["b_gate"], lstm("decoder.lstm"), d["w_out"], d["b_out"], use_psi=m.pos_guidance,
    )
    extra = sorted(set(tree) - used)
    if extra:
        raise KeyError(f"weight tree has keys the port does not know: {extra[:5]}")
    return CaptionerParams(encoder, pos, decoder)


def to_numpy(params: CaptionerParams) -> dict:
    """CaptionerParams -> {dotted path: f32 numpy array}."""
    return {
        name: t.detach().to("cpu", torch.float32).numpy().copy()
        for name, t in params.named_parameters()
    }


def _lstm_paths(prefix: str) -> list:
    return [f"{prefix}.{n}" for n in _LSTM]


# the JAX tree's leaf order: each dataclass's fields in declaration order,
# where `named_parameters` lists a module's own tensors before its children
JAX_ORDER = (
    [f"encoder.xgate.{n}" for n in _XGATE] + _lstm_paths("encoder.lstm_fwd")
    + _lstm_paths("encoder.lstm_bwd")
    + [f"pos.{n}" for n in _POS[:3]] + _lstm_paths("pos.lstm") + [f"pos.{n}" for n in _POS[3:]]
    + [f"decoder.{n}" for n in _DEC[:3]] + [f"decoder.attn.{n}" for n in ("wq", "wk", "b", "v")]
    + [f"decoder.{n}" for n in _DEC[3:7]] + _lstm_paths("decoder.lstm")
    + [f"decoder.{n}" for n in _DEC[7:]]
)


def param_paths(params: CaptionerParams) -> list:
    """[(dotted path, f32 numpy array)] in the JAX tree's order, as
    `tools/import_torch_checkpoint.py::param_paths` lists the JAX
    package's parameters."""
    tree = to_numpy(params)
    return [(name, tree[name]) for name in JAX_ORDER if name in tree]
