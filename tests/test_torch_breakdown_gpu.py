"""The measurement tools on the card, at MSR-VTT width with short loops.

Marked `gpu`: every test skips without a CUDA device. This file imports no
jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_breakdown_gpu.py

Each tool's `main` at `--reps 2,4` (bf16), with the launches the wrappers
counted in one call of a piece: K3 once a `decode_fused` repetition and
never in `decode_jnp`, K3 and K4 28 times each in the beam call; K4 in
`beam_topk_ab`'s lanes tail alone; K3 56 times a call of a two-member
ensemble and no K4; K5 in `xe_breakdown`'s `_KERNEL` rows alone; K3 28
times in `scst_breakdown`'s greedy rollout; the reward pieces launch no
kernel; `serve_bench` completes its points; `trace_ops` ranks the port's
kernels.
"""

import contextlib
import io

import pytest
import torch

from controllable_xgating_torch.tools import (
    beam_topk_ab,
    cider_piece_timing,
    ensemble_bench,
    profile_beam_step,
    scst_breakdown,
    serve_bench,
    trace_ops,
    xe_breakdown,
)

pytestmark = pytest.mark.gpu
REPS = ["--reps", "2,4"]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def test_profile_beam_step_launches():
    pieces = run(profile_beam_step.main, REPS)["pieces"]
    assert pieces["decode_fused"]["launches"] == {"attn_lstm": 1}
    assert pieces["decode_jnp"]["launches"] == {}
    assert pieces["full_beam_step(prod/28)"]["launches"] == {"attn_lstm": 28, "topk_tail": 28}
    assert all("mfu" in p for p in pieces.values())


def test_beam_topk_ab_launches():
    forms = run(beam_topk_ab.main, REPS)["forms"]
    assert forms["lanes"]["launches"]["topk_tail"] == 28
    assert not any("topk_tail" in forms[m]["launches"] for m in ("block", "grouped", "flat"))


def test_ensemble_bench_launches():
    points = run(ensemble_bench.main, REPS + ["--members", "1,2", "--repeats", "1"])["points"]
    m2 = points["M=2"]["launches"]
    assert m2["attn_lstm"] == 56 and "topk_tail" not in m2
    assert points["M=1"]["launches"]["topk_tail"] == 28


def test_xe_breakdown_launches():
    pieces = run(xe_breakdown.main, REPS)["pieces"]
    for name, row in pieces.items():
        if "derived" in name:
            continue
        want = ({} if "_KERNEL" not in name else {"xent_fwd": 1} if name.startswith("loss_lse")
                else {"xent_fwd": 1, "xent_bwd": 1})
        assert row["launches"] == want, name


def test_scst_and_cider_launches():
    report = run(scst_breakdown.main, REPS)
    assert report["launches"]["greedy_rollout"] == {"attn_lstm": 28}
    assert report["launches"]["cider_candidate"] == {}
    cider = run(cider_piece_timing.main, REPS)
    assert all(v > 0 for v in cider["timings_ms"].values())
    assert not any(cider["launches"].values())


def test_serve_bench_points():
    points = run(serve_bench.main, ["--rates", "100", "--duration", "1", "--deadline_ms", "1000"])
    assert points[0]["n"] >= 1 and points[0]["expired"] == 0
    assert points[0]["latency_ms_p50"] <= points[0]["latency_ms_p99"]


def test_trace_ops_ranks_port_kernels(tmp_path):
    report = run(trace_ops.main, ["--workload", "beam", "--reps", "1", "--out", str(tmp_path)])
    assert any("cxg::" in o["op"] for o in report["ops"])
    assert report["launches"]["attn_lstm"] == 28
