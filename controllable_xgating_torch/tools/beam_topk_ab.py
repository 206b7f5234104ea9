"""A/B the beam candidate-selection forms.

Counterpart of the JAX package's `tools/beam_topk_ab.py`: sustained
beam-5 captions/s over `utils/timing.py::random_batch(256)` at MSR-VTT
width (random weights from seed 0), by the timing harness
(`utils/timing.py`), in the four tails of `make_beam_caption_fn`:
`lanes` (the top-K kernel, K4, which never writes the [B*K, V] logits),
`block`, `grouped` and `flat` (the full log-softmax in PyTorch), each
printed as captions/s and ms per batch, then each form against `flat`.
The last line is one JSON object with each form's captions/s, the device
ms of one call (`torch.profiler`) and the launches that call counted.
The card runs the bf16 policy, the CPU f32.

    python -m controllable_xgating_torch.tools.beam_topk_ab [--batch 256]
        [--reps 2,10] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

MODES = ("lanes", "block", "grouped", "flat")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=None, help="videos per call (default 256)")
    p.add_argument("--reps", default="2,10", help="the two loop lengths differenced")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils import timing
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    batch_size = args.batch or timing.BATCH
    reps = tuple(int(r) for r in args.reps.split(","))
    out: dict = {"batch": batch_size, "beam": timing.BEAM, "max_len": timing.MAX_LEN,
                 "device": timing.device_name(dev), "compute_dtype": dtype, "forms": {}}
    with precision(dtype):
        cfg, params = timing.build(device=dev)
        app, mot = (timing.put(x, dev) for x in timing.random_batch(cfg, batch_size))
        for mode in MODES:
            fn = timing.make_fn(cfg, topk_mode=mode)
            cps = timing.time_caption_sustained(fn, params, (app, mot), dev, reps)
            d = timing.device_detail(lambda: fn(params, app, mot), dev)
            out["forms"][mode] = {"captions_per_sec": round(cps, 1), **d}
            print(f"{mode:>8}: {cps:.0f} captions/s  ({batch_size / cps * 1e3:.2f} ms/batch)",
                  flush=True)
    flat = out["forms"]["flat"]["captions_per_sec"]
    for mode in MODES[:3]:
        print(f"{mode} vs flat: {out['forms'][mode]['captions_per_sec'] / flat - 1.0:+.1%}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
