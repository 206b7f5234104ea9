"""Quantify POS controllability (the paper's §4 controllability study).

For each test video, caption twice: free-running (the POS generator picks
the syntax) and controlled (a user-supplied Penn tag template). Both
captions are re-tagged with the corpus tagger; the metric is per-position
tag agreement with the template. Controllability is real iff the
controlled agreement is much higher than the free-run agreement on the
SAME videos (the free run is the no-control baseline).

Counterpart of the JAX package's `tools/controllability_eval.py`, with the
same flags, agreement modes and JSON. Its device call (the reference's
jitted encode + greedy decode) is the port's `encode_for_inference` and
`greedy_decode` on the card, through the kernels and replayed CUDA graphs:
a free-run call launches the fusion, POS-step and decoder-step kernels, a
controlled one skips the POS rollout. As in the reference, the study
decodes without the corpus's frame masks. It runs on the card unless
`--device cpu` is given; `--rescore_captions` needs no model or device.

  python -m controllable_xgating_torch.tools.controllability_eval \\
      --data_dir D --checkpoint_dir CK --template "DT NN VBZ VBG IN DT NN"
  python -m controllable_xgating_torch.tools.controllability_eval ... \\
      --templates "EX VBZ DT NN VBG NN;DT NN VBZ NN"
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from controllable_xgating_torch.cli.common import load_corpus, restore_params, runtime_device
from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.data.postag import PennTagger
from controllable_xgating_torch.data.vocab import pad_encode
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.config import Config, parse_cli_overrides


def tag_agreement(caption: str, template: list[str], tagger: PennTagger,
                  mode: str = "position") -> float:
    """Agreement between the caption's tags and the template.

    `position` (the paper's §4 form): per-position match over the longer
    length — brittle to insertions (one early JJ shifts every later
    position). `lcs`: longest common subsequence over the longer length —
    credits structure that survives a shift, still 1.0 iff the sequences
    are identical."""
    words = caption.split()
    if not words:
        return 0.0
    tags = tagger.tag(words)
    if not tags or not template:
        return 0.0
    if mode == "position":
        n = min(len(tags), len(template))
        hits = sum(tags[i] == template[i] for i in range(n))
        # penalize length mismatch: divide by the longer of the two
        return hits / max(len(tags), len(template))
    # lcs
    m, n = len(tags), len(template)
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        for j in range(1, n + 1):
            cur[j] = (prev[j - 1] + 1 if tags[i - 1] == template[j - 1]
                      else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[n] / max(m, n)


def _summarize(captions: list[dict], template: list[str],
               tagger: PennTagger, primary_mode: str) -> dict:
    """Score a [{'free':.., 'controlled':..}] caption list under BOTH
    agreement modes; the top-level fields mirror `primary_mode`."""
    by_mode = {}
    for mode in ("position", "lcs"):
        free = [tag_agreement(c["free"], template, tagger, mode)
                for c in captions]
        ctrl = [tag_agreement(c["controlled"], template, tagger, mode)
                for c in captions]
        by_mode[mode] = {
            "free_run_tag_agreement": round(float(np.mean(free)), 4),
            "controlled_tag_agreement": round(float(np.mean(ctrl)), 4),
        }
    return {
        "template": " ".join(template),
        "agreement_mode": primary_mode,
        "videos": len(captions),
        **by_mode[primary_mode],
        "agreement_by_mode": by_mode,
        "examples": captions[:5],
        "captions": captions,
    }


def make_study_decoder(params, cfg):
    """The study's device call: (app, motion, pos_tags or None) -> tokens
    [B, max_decode_len], through the kernels where the tensors are on the
    card (the dispatcher's choice) and with early exit."""
    fused = fused_enabled(None)

    @torch.inference_mode()
    def run(app, motion, pos_tags):
        ctx, summary, _ = encode_for_inference(
            params, app, motion, pos_tags=pos_tags, max_pos_len=cfg.model.max_pos_len,
            fused=fused, early_stop=True,
        )
        return greedy_decode(params.decoder, ctx, summary, cfg.eval.max_decode_len,
                             fused=fused, early_stop=True)

    return run


def study(run, info, store, idx, template: list[str], batch_size: int, max_pos_len: int,
          device) -> list[dict]:
    """Free-run and controlled captions of the videos `idx`, in order."""
    tmpl_row = pad_encode(info.pos_vocab, template, max_pos_len)
    captions = []
    for batch in eval_batches(store, idx, batch_size):
        b = batch["app"].shape[0]
        app, motion = (torch.as_tensor(batch[k], device=device) for k in ("app", "motion"))
        tmpl = torch.as_tensor(np.array([tmpl_row] * b, np.int64), device=device)
        free_toks = run(app, motion, None).cpu().numpy()
        ctrl_toks = run(app, motion, tmpl).cpu().numpy()
        for row in range(batch["num_valid"]):
            captions.append({
                "video_id": info.video_ids[int(batch["video_indices"][row])],
                "free": info.vocab.decode_str(free_toks[row]),
                "controlled": info.vocab.decode_str(ctrl_toks[row]),
            })
    return captions


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir")
    p.add_argument("--checkpoint_dir")
    p.add_argument("--template", default="DT NN VBZ VBG IN DT NN")
    p.add_argument("--templates", default=None,
                   help="semicolon-separated Penn tag templates; when set, "
                        "the study runs per template and reports each plus "
                        "the mean (paper §4 uses several syntax patterns)")
    p.add_argument("--split", default="test")
    p.add_argument("--agreement", default="position",
                   choices=("position", "lcs"),
                   help="which mode fills the top-level agreement fields "
                        "(position = the paper's per-position form, brittle "
                        "to insertions; lcs = shift-tolerant). BOTH modes "
                        "are always computed into agreement_by_mode.")
    p.add_argument("--rescore_captions", default=None, metavar="JSON",
                   help="offline mode: re-score the full caption dump of a "
                        "previous run (its 'captions' list) without a model "
                        "or device; --template must match the capture")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to decode (default: the card; cpu only when asked)")
    p.add_argument("--compute_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="matmul operand dtype; default model.dtype on the card, "
                        "float32 on the CPU")
    args, rest = p.parse_known_args(argv)

    if args.rescore_captions:
        tagger = PennTagger()
        with open(args.rescore_captions) as f:
            prev = json.load(f)
        caps = prev.get("captions")
        if not caps:
            raise SystemExit(
                f"{args.rescore_captions} has no 'captions' dump (captures "
                "from before round 5 stored only 5 examples — re-decode)")
        template = prev.get("template", args.template).split()
        print(json.dumps(_summarize(caps, template, tagger,
                                    args.agreement), indent=2))
        return

    if not args.data_dir or not args.checkpoint_dir:
        raise SystemExit("--data_dir and --checkpoint_dir are required "
                         "unless --rescore_captions is given")
    cfg = Config().replace_flat(parse_cli_overrides(rest))
    device, dtype = runtime_device(args.device, args.compute_dtype, cfg)
    with precision(dtype):
        _study(args, cfg, device)


def _study(args, cfg, device) -> None:
    info, _, store, cfg = load_corpus(args.data_dir, cfg)
    params = restore_params(args.checkpoint_dir, cfg, device)
    tagger = PennTagger()
    run = make_study_decoder(params, cfg)
    idx = np.asarray(info.splits[args.split])

    def one(template: list[str]) -> dict:
        caps = study(run, info, store, idx, template, args.batch_size, cfg.model.max_pos_len,
                     device)
        return _summarize(caps, template, tagger, args.agreement)

    if args.templates:
        results = [one(t.split()) for t in args.templates.split(";") if t.strip()]
        print(json.dumps({
            "per_template": results,
            "mean_free_run_tag_agreement": round(float(np.mean(
                [r["free_run_tag_agreement"] for r in results])), 4),
            "mean_controlled_tag_agreement": round(float(np.mean(
                [r["controlled_tag_agreement"] for r in results])), 4),
        }, indent=2))
    else:
        print(json.dumps(one(args.template.split()), indent=2))


if __name__ == "__main__":
    main()
