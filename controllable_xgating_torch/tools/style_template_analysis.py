"""Offline per-style analysis of controllability caption dumps (corpus v3).

Corpus v3 ("syntax" map) gives every video a latent STYLE (0 =
progressive "the chef is driving a car in a room", 1 = simple-present
with fronted place "on the beach the woman draws a picture"). The
round-5 controllability finding is that forcing a tag template keeps the
SYNTAX but flips the CONTENT ("a cat ..." -> "a young boy ..."). This
tool measures that mechanism instead of anecdoting it: it joins a
controllability caption dump (tools/controllability_eval.py --templates,
which stores video_id + free/controlled caption per row) against the
corpus's fixture_meta styles and scene assignments, and reports, per
(template style x video style) bucket:

  * controlled tag agreement (position + lcs) with the forced template,
  * SUBJECT retention: does the caption name the video's true subject
    (any surface form's head noun from the fixture generator's bank)?
  * ACTION retention: the true verb (either realization) or its object.

free-run retention on the same videos is the no-control baseline, so
"the template costs X% of subject retention, and Y% more when its style
mismatches the video" is a measured statement.

  python -m controllable_xgating_torch.tools.style_template_analysis \\
      --capture checkpoints/grid_v3/xgate_pos/controllability_styles.json \\
      --meta data/grid_v3/fixture_meta.json

No model, no device: pure re-analysis of the capture. Counterpart of the
JAX package's `tools/style_template_analysis.py`, on the port's
`tools/controllability_eval.py::tag_agreement`, `data/postag.py` and
`data/fixtures.py`: the same buckets, table and JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from controllable_xgating_torch.data.fixtures import ACTIONS, SUBJECTS
from controllable_xgating_torch.data.postag import PennTagger
from controllable_xgating_torch.tools.controllability_eval import tag_agreement


def template_style(template: list[str]) -> int:
    """v3 realizations: style 1 always fronts the place phrase (IN ...),
    style 0 is subject-initial (DT/EX ...)."""
    return 1 if template and template[0] == "IN" else 0


def subject_words(subject_idx: int) -> set[str]:
    """Head nouns of every surface form ('a man'/'the man'/'a guy' ->
    {'man', 'guy'})."""
    return {form.split()[-1] for form in SUBJECTS[subject_idx]}


def action_words(action_idx: int) -> set[str]:
    """Verb realizations + object head noun ('is playing', 'plays',
    'guitar' -> {'playing', 'plays', 'guitar'})."""
    ing, third, obj = ACTIONS[action_idx]
    words = {ing.split()[-1], third}
    if obj:
        words.add(obj.split()[-1])
    return words


def analyze(studies: list[dict], meta_videos: dict, tagger: PennTagger
            ) -> list[dict]:
    """One row per (template, video-style) bucket."""
    rows = []
    for study in studies:
        template = study["template"].split()
        t_style = template_style(template)
        buckets: dict[int, list[dict]] = {0: [], 1: []}
        for cap in study["captions"]:
            v = meta_videos.get(cap.get("video_id"))
            if v is None or "style" not in v:
                continue
            buckets[int(v["style"])].append((cap, v))
        for v_style, pairs in buckets.items():
            if not pairs:
                continue
            agree_pos, agree_lcs = [], []
            subj_ctrl, subj_free, act_ctrl, act_free = [], [], [], []
            for cap, v in pairs:
                agree_pos.append(tag_agreement(
                    cap["controlled"], template, tagger, "position"))
                agree_lcs.append(tag_agreement(
                    cap["controlled"], template, tagger, "lcs"))
                sw = subject_words(v["subject"])
                aw = action_words(v["action"])
                cw = set(cap["controlled"].split())
                fw = set(cap["free"].split())
                subj_ctrl.append(bool(cw & sw))
                subj_free.append(bool(fw & sw))
                act_ctrl.append(bool(cw & aw))
                act_free.append(bool(fw & aw))
            rows.append({
                "template": study["template"],
                "template_style": t_style,
                "video_style": v_style,
                "style_match": t_style == v_style,
                "n": len(pairs),
                "controlled_agreement_position":
                    round(float(np.mean(agree_pos)), 4),
                "controlled_agreement_lcs":
                    round(float(np.mean(agree_lcs)), 4),
                "subject_retention_controlled":
                    round(float(np.mean(subj_ctrl)), 4),
                "subject_retention_free":
                    round(float(np.mean(subj_free)), 4),
                "action_retention_controlled":
                    round(float(np.mean(act_ctrl)), 4),
                "action_retention_free":
                    round(float(np.mean(act_free)), 4),
            })
    return rows


def render(rows: list[dict]) -> str:
    header = (
        "| template | t-style | v-style | n | ctrl agree (pos) | "
        "ctrl agree (lcs) | subj ret ctrl | subj ret free | "
        "act ret ctrl | act ret free |\n"
        "|---|---|---|---|---|---|---|---|---|---|"
    )
    lines = [header]
    for r in rows:
        lines.append(
            f"| `{r['template']}` | {r['template_style']} "
            f"| {r['video_style']}{' =' if r['style_match'] else ''} "
            f"| {r['n']} | {r['controlled_agreement_position']:.3f} "
            f"| {r['controlled_agreement_lcs']:.3f} "
            f"| {r['subject_retention_controlled']:.3f} "
            f"| {r['subject_retention_free']:.3f} "
            f"| {r['action_retention_controlled']:.3f} "
            f"| {r['action_retention_free']:.3f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--capture", required=True,
                   help="controllability JSON with a caption dump: either "
                        "a --templates run (per_template list) or a single "
                        "study")
    p.add_argument("--meta", required=True,
                   help="fixture_meta.json of the corpus the capture ran on")
    p.add_argument("--out", default=None, help="also write markdown here")
    args = p.parse_args(argv)

    with open(args.capture) as f:
        capture = json.load(f)
    studies = capture.get("per_template", [capture])
    for s in studies:
        if not s.get("captions") or "video_id" not in s["captions"][0]:
            raise SystemExit(
                "capture has no per-video caption dump with video_id "
                "(needs a round-5+ tools/controllability_eval.py run)")
    with open(args.meta) as f:
        meta_videos = json.load(f)["videos"]

    rows = analyze(studies, meta_videos, PennTagger())
    md = render(rows)
    print(md)
    print(json.dumps({"rows": rows}))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
