"""`controllable_xgating_torch/utils/roofline.py` against the JAX package's
`utils/roofline.py`: every cost function counts the same FLOPs and bytes
for the same config (exactly), and the port holds the five cases of
`tests/test_roofline.py` at the H100's published peaks; an unknown
device raises instead of borrowing another card's numbers."""

import dataclasses
import os

import numpy as np
import pytest

from controllable_xgating_tpu.utils import roofline as j_roofline
from controllable_xgating_tpu.utils.config import ModelConfig as JModelConfig
from controllable_xgating_tpu.utils.config import load_config as j_load_config
from controllable_xgating_torch.utils import roofline
from controllable_xgating_torch.utils.config import ModelConfig, load_config

MSRVTT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "msrvtt.json")
REF = ModelConfig(vocab_size=10000, pos_vocab_size=35)
H100 = "NVIDIA H100 80GB HBM3"
SMALL = dict(app_dim=18, motion_dim=10, hidden_dim=20, embed_dim=12, attn_dim=12,
             pos_embed_dim=12, num_frames=5, vocab_size=40, pos_vocab_size=14,
             decoder_hidden_mult=2, encoder_bidirectional=False)


def configs():
    """(port, JAX) model configs: configs/msrvtt.json at vocab 10000 and
    35 tags, and a small one with the non-default knobs."""
    over = {"model.vocab_size": 10000, "model.pos_vocab_size": 35}
    return {
        "msrvtt": (load_config(MSRVTT, over).model, j_load_config(MSRVTT, over).model),
        "small": (ModelConfig(**SMALL), JModelConfig(**SMALL)),
    }


CALLS = {
    "encode": lambda r, m: r.encode_cost(m, 64),
    "context": lambda r, m: r.context_cost(m, 320, ws=4),
    "decode_step": lambda r, m: r.decode_step_cost(m, 1280),
    "decode_step_sampling": lambda r, m: r.decode_step_cost(m, 64, with_sampling_tail=True),
    "pos_step": lambda r, m: r.pos_step_cost(m, 256),
    "beam": lambda r, m: r.beam_workload_cost(m, 256, 5, 28, 28),
    "greedy": lambda r, m: r.greedy_workload_cost(m, 256, 28, 28, ws=4),
    "xe": lambda r, m: r.xe_step_cost(m, 64, 5, 28, 28),
    "xe_remat": lambda r, m: r.xe_step_cost(m, 64, 5, 28, 28, remat=True),
    "scst": lambda r, m: r.scst_step_cost(m, 64, 28, 28),
}


@pytest.mark.parametrize("config", ["msrvtt", "small"])
@pytest.mark.parametrize("name", list(CALLS))
def test_costs_equal_jax_exactly(config, name):
    t_cfg, j_cfg = configs()[config]
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    got, want = CALLS[name](roofline, t_cfg), CALLS[name](j_roofline, j_cfg)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    assert got.flops > 0 and got.hbm_bytes > 0


def test_decode_step_logits_dominate_flops():
    c_all = roofline.decode_step_cost(REF, rows=1280)
    c_nov = roofline.decode_step_cost(ModelConfig(vocab_size=1, pos_vocab_size=35), rows=1280)
    assert c_all.flops > 1.3 * c_nov.flops
    assert c_all.flops > 0 and c_all.hbm_bytes > 0


def test_costs_scale_linearly_in_rows_minus_weights():
    c1 = roofline.decode_step_cost(REF, rows=100)
    c2 = roofline.decode_step_cost(REF, rows=200)
    assert np.isclose(c2.flops, 2 * c1.flops)
    assert 2 * c1.hbm_bytes - c2.hbm_bytes > 0  # the weights' bytes


def test_beam_workload_composition():
    total = roofline.beam_workload_cost(REF, batch=256, beam=5, dec_steps=28, pos_steps=28)
    dec = roofline.decode_step_cost(REF, rows=1280).scaled(28)
    assert total.flops > dec.flops and total.hbm_bytes > dec.hbm_bytes


def test_xe_backward_multiplier_and_remat():
    base = roofline.xe_step_cost(REF, batch=256, k=5, length=28, pos_len=28)
    remat = roofline.xe_step_cost(REF, batch=256, k=5, length=28, pos_len=28, remat=True)
    assert remat.flops > base.flops


def test_utilization_fields_and_bounds_at_h100_peaks():
    cost = roofline.Cost(flops=989e12 * 0.5, hbm_bytes=3.35e12 * 0.1)
    u = roofline.utilization(cost, seconds=1.0, device_kind=H100)
    assert u == {"mfu": 0.5, "hbm_bw_util": 0.1, "bound": "compute", "roofline_seconds": 0.5,
                 "measured_seconds": 1.0, "headroom_x": 2.0, "peaks_device": "H100 SXM"}
    u2 = roofline.utilization(roofline.Cost(1e9, 3.35e12), 1.0, H100)
    assert u2["bound"] == "bandwidth" and u2["hbm_bw_util"] == 1.0
    # the FLOP peak follows the compute dtype: f32 runs off the tensor cores
    u3 = roofline.utilization(roofline.Cost(67e12 * 0.25, 0.0), 1.0, H100, dtype="float32")
    assert u3["mfu"] == 0.25 and u3["bound"] == "compute"
    assert roofline.device_peaks(H100, "float32") == (67e12, 3.35e12, "H100 SXM")


@pytest.mark.parametrize("kind", ["weird chip", "TPU v5 lite", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.device_peaks(kind)
    with pytest.raises(ValueError):
        roofline.utilization(roofline.Cost(1.0, 1.0), 1.0, kind)


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="float16"):
        roofline.device_peaks(H100, "float16")
