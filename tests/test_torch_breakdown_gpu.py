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
kernels. Every roofline share of `profile_beam_step` and `xe_breakdown`
is at most 1.05 (above it the cost model or the clock is wrong). The
pieces compute what they stand for: the decode step's K3 against the
plain steps, the loss's K5 rows against the plain rows, the reward in one
call against two.
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
ROOFLINE_MAX = 1.05


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def check_shares(name, row):
    """A row's roofline shares on its sustained ms, and on its device ms
    where the profile kept an event of every launch (a short event count
    inflates the share), at most ROOFLINE_MAX."""
    on_device = row.get("on_device") or {}
    for key in ("mfu", "hbm_bw_util"):
        assert row.get(key, 0.0) <= ROOFLINE_MAX, (name, key, row)
        assert on_device.get(key, 0.0) <= ROOFLINE_MAX or not row["events_complete"], (name, row)


def test_profile_beam_step_launches():
    pieces = run(profile_beam_step.main, REPS)["pieces"]
    assert pieces["decode_fused"]["launches"] == {"attn_lstm": 1}
    assert pieces["decode_jnp"]["launches"] == {}
    assert pieces["full_beam_step(prod/28)"]["launches"] == {"attn_lstm": 28, "topk_tail": 28}
    assert all("mfu" in p for p in pieces.values())
    for name, row in pieces.items():
        check_shares(name, row)


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
        check_shares(name, row)


def test_scst_and_cider_launches():
    report = run(scst_breakdown.main, REPS)
    assert report["launches"]["greedy_rollout"] == {"attn_lstm": 28}
    assert report["launches"]["cider_candidate"] == {}
    cider = run(cider_piece_timing.main, REPS)
    assert all(v > 0 for v in cider["timings_ms"].values())
    assert not any(cider["launches"].values())


def test_serve_bench_points():
    points = run(serve_bench.main, ["--rates", "100,800", "--duration", "2",
                                    "--deadline_ms", "1000"])
    assert len(points) == 2 and points[0]["expired"] == 0
    assert all(p["n"] >= 1 and p["latency_ms_p50"] <= p["latency_ms_p99"] for p in points)


def test_trace_ops_ranks_port_kernels(tmp_path):
    report = run(trace_ops.main, ["--workload", "beam", "--reps", "1", "--out", str(tmp_path)])
    assert any("cxg::" in o["op"] for o in report["ops"])
    assert report["launches"]["attn_lstm"] == 28


def test_decode_step_pieces_match_the_plain_steps():
    """`profile_beam_step`'s decode step at MSR-VTT width (256 videos x
    beam 5): K3 (`decode_fused`) against the path's plain step
    (`decode_jnp`) within the f32 bound under f32, and against its own
    plain version within its bf16 bound (atol 1e-4) under bf16, where the
    path's plain step rounds the attention context to bf16 and K3 does
    not."""
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_plain
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils import timing

    dev = torch.device("cuda:0")
    cfg, params = timing.build(device=dev)
    dec = params.decoder
    for policy in ("float32", "bfloat16"):
        with precision(policy), torch.no_grad():
            s = profile_beam_step.setup(cfg, params, timing.BATCH, dev)
            path, k3 = (profile_beam_step.decode_core(dec, s["ctx_k"], s["tok"], s["h"], s["c"], f)
                        for f in (False, True))
            own = attn_lstm_step_plain(dec, dec.embed[s["tok"]], s["h"], s["c"], s["ctx_k"].keys,
                                       s["ctx_k"].enc_proj, s["ctx_k"].psi_g)[:2]
        if policy == "float32":
            for a, b in zip(k3, path):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        else:
            assert max((a - b).abs().max().item() for a, b in zip(k3, own)) <= 1e-4


def test_loss_rows_through_k5_match_the_plain_rows():
    """`xe_breakdown`'s loss at its shape (1280 rows x 27 positions, f32
    logits over V = 10000) through K5 and through the plain row statistics:
    within rtol 1e-4."""
    from controllable_xgating_torch.train.xe import masked_xe_loss

    g = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn((256 * xe_breakdown.K, 27, 10000), generator=g, device="cuda")
    targets = torch.randint(4, 10000, (256 * xe_breakdown.K, 27), generator=g, device="cuda")
    losses = []
    for kernels in (False, True):
        with xe_breakdown.routed(kernels):
            losses.append(masked_xe_loss(logits, targets).item())
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)


def test_reward_of_one_call_equals_two_calls():
    """`cider_piece_timing`'s reward over 2 x 256 candidates in one call
    against two calls of 256: within atol 1e-6."""
    from controllable_xgating_torch.ops.cider_device import build_reward_tables

    caps, ncaps, cand = cider_piece_timing.make_inputs(256)
    tables = build_reward_tables(caps, ncaps, list(range(256)), device="cuda")
    cand, vidx = torch.as_tensor(cand, device="cuda"), torch.arange(256, device="cuda")
    two = torch.cat(cider_piece_timing.two_calls(tables, cand, vidx))
    assert (cider_piece_timing.one_call(tables, cand, vidx) - two).abs().max().item() <= 1e-6
