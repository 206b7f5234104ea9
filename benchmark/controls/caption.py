"""Readings that set the caption cell's limits, at the cell's size, and
the faults the cell can have.

    python3 benchmark/controls/caption.py --workload msrvtt.beam5_b256 \
        --seeds 1,2,...,12 --control_seeds 101,102,103 [--out FILE]

For each of `--seeds`: the program (weights and traffic from the seed as
a run makes them) captions `sample_calls` batches of the pool through the
window's own call (`entries/caption_beam.py::caption_call`), and the
plain reference judges them (`reference/caption.py::judge`): the lower
readings. For each of `--control_seeds`, the control and the program's
own lower-precision path are judged the same way: the reference put in
the program's place with every matrix product's operands in float8 e4m3
(`fp8`), and the program with its weight-only int8 vocabulary projection
(`vocab_q`); and so is the program with each fault of `FAULTS` planted
under the call. Prints one JSON line per seed and a summary; needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.reference import caption as ref_caption  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402

KEYS = ("caption_gap", "tag_gap", "score_gap", "beam_differs", "caption_gap_mean", "beam_gap_mean",
        "beam_gap_max")
FAULTS = ("token", "greedy", "lse")


class _MaxForLse:
    """`torch` as the port's beam module sees it, with a log-softmax that
    takes each row's max for its log-sum-exp."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def log_softmax(x, dim):
        return x - x.amax(dim, keepdim=True)


@contextlib.contextmanager
def planted(fault):
    """The port's beam search with `fault` planted under it, restored on
    leaving: "token" alters the fourth word of every caption where it is
    made; "greedy" decodes with one beam; "lse" ranks by logits less the
    row's max, not its log-sum-exp (the top-K kernel's path and the plain
    one). Decode graphs are dropped on entering and leaving, so none
    captured on one side replays on the other."""
    from controllable_xgating_torch.infer import beam as port_beam
    from controllable_xgating_torch.infer import graphs

    saved = {n: getattr(port_beam, n) for n in ("beam_search", "logits_topk", "torch")}
    search, lanes = saved["beam_search"], saved["logits_topk"]

    def token(params, *a, **k):
        tokens, scores = search(params, *a, **k)
        tokens = tokens.clone()
        tokens[:, 3] = (tokens[:, 3] + 1) % params.w_out.shape[-1]
        return tokens, scores

    def greedy(params, ctx, summary, beam_size, *a, **k):
        return search(params, ctx, summary, 1, *a, **k)

    def lse_max(*a, **k):
        top_v, top_i, _ = lanes(*a, **k)
        return top_v, top_i, top_v.amax(-1)

    patch = {None: {}, "token": {"beam_search": token}, "greedy": {"beam_search": greedy},
             "lse": {"logits_topk": lse_max, "torch": _MaxForLse()}}[fault]
    graphs.clear()
    try:
        for n, f in patch.items():
            setattr(port_beam, n, f)
        yield
    finally:
        for n, f in saved.items():
            setattr(port_beam, n, f)
        graphs.clear()


def readings(cell: dict, seeds: list, control_seeds: list, device: str = "cuda:0") -> dict:
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer import beam as port_beam
    from controllable_xgating_torch.ops.precision import set_compute_dtype

    from benchmark.entries.caption_beam import caption_call, port_params

    dev = torch.device(device)
    model, dec = cell["model_cfg"]["model"], cell["model_cfg"]["decode"]
    beam, max_len, max_pos = int(dec["beam_size"]), int(dec["max_len"]), int(dec["max_pos_len"])
    set_compute_dtype(model["dtype"])
    n = int(cell["sample_calls"])
    gen = core.traffic(cell)
    _, params = port_params(model, ref_model.make_weights(model, 0, dev), dev)
    call = caption_call(params, dec, int(cell["traffic_cfg"]["batch"]))

    def load(seed):
        w = ref_model.make_weights(model, core.derive(seed, "weights"), dev)
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(w[name])
        pool = gen.make(cell["traffic_cfg"], model, core.derive(seed, "traffic"))
        return w, [pool[i % len(pool)] for i in range(n)]

    def judged(w, batches, outs):
        cat = lambda j: torch.cat([torch.as_tensor(o[j]).cpu() for o in outs]).numpy()
        app = torch.cat([torch.as_tensor(b[0]) for b in batches]).numpy()
        mot = torch.cat([torch.as_tensor(b[1]) for b in batches]).numpy()
        got = ref_caption.judge(w, app, mot, cat(1), cat(0), cat(2), beam)
        return {k: got[k] for k in KEYS}

    def vocab_q_call(a, m):
        vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)
        with torch.inference_mode():
            c, s, tags = port_beam.encode_for_inference(
                params, torch.as_tensor(a, device=dev), torch.as_tensor(m, device=dev), None,
                max_pos_len=max_pos, fused=True, early_stop=True)
            tokens, scores = port_beam.beam_search(params.decoder, c, s, beam, max_len, fused=True,
                                                   early_stop=True, vocab_q=vq)
        return tokens, tags, scores

    out = {"program": {}, "fp8": {}, "vocab_q": {}, **{f: {} for f in FAULTS}}
    for seed in seeds:
        w, batches = load(seed)
        out["program"][seed] = judged(w, batches, [call(a, m) for a, m in batches])
        print(json.dumps({"program": seed, **out["program"][seed]}), flush=True)
    mm8 = ref_model.Matmul(fp8=True)
    for seed in control_seeds:
        w, batches = load(seed)
        outs = [ref_caption.beam_decode(w, a, m, beam, max_len, max_pos, mm8) for a, m in batches]
        out["fp8"][seed] = judged(w, batches, outs)
        if dev.type == "cuda":
            out["vocab_q"][seed] = judged(w, batches, [vocab_q_call(a, m) for a, m in batches])
        for fault in FAULTS:
            with planted(fault):
                out[fault][seed] = judged(w, batches, [call(a, m) for a, m in batches])
        print(json.dumps({"control": seed, **{side: out[side].get(seed)
                                              for side in ("fp8", "vocab_q", *FAULTS)}}),
              flush=True)
    out["summary"] = {side: {k: [min(r[k] for r in rs.values()), max(r[k] for r in rs.values())]
                             for k in KEYS} for side, rs in out.items() if rs}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="msrvtt.beam5_b256")
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 1
    parse = lambda s: [int(x) for x in s.split(",") if x]
    out = readings(core.cell_spec(args.workload), parse(args.seeds), parse(args.control_seeds))
    print(json.dumps({"summary": out["summary"], "card": torch.cuda.get_device_name(0)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    core.check_imports("after the readings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
