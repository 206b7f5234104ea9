"""Train and evaluate the paper's 2x2 ablation grid end-to-end.

The system's two novelties are cross-gated fusion and POS-sequence
guidance. The knobs (`model.fusion=concat`, `model.pos_guidance=false`)
exist and unit-test clean, but only a trained A/B demonstrates the
paper's §4 ablation claims — cross gating > concat fusion, psi guidance >
none — so this tool runs the full recipe (POS 8 epochs -> XE caption
40 -> SCST 15, then beam-5 test evals + the controllability study) for
every cell of {fusion: xgate, concat} x {pos_guidance: on, off} on the
600-video syntactically-diverse fixture corpus, with identical seeds and
hyperparameters across cells.

Resumable: each completed stage leaves a `.done` marker; re-running skips
finished work. Results land in <out>/grid_results.json.

  python -m controllable_xgating_torch.tools.ablation_grid --data_dir data/flagship \\
      --out checkpoints/ablation_grid

Counterpart of the JAX package's `tools/ablation_grid.py`: the same cells,
recipes, flags, retries, `grid_log.txt` and `grid_results.json`. Its stage
commands run the port's `cli.train`, `cli.eval` and
`tools.controllability_eval` (`python -m ...` from the checkout's root),
with `--device` in place of `--platform`: on the card by default, on the
CPU with `--device cpu` (the smoke recipe's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = "controllable_xgating_torch"

CELLS = [
    ("xgate", True),
    ("concat", True),
    ("xgate", False),
    ("concat", False),
]

# the flagship recipe's shared flags; MEDIUM is the corpus-v2 adjudication
# recipe (~4x cheaper than flagship — the grid compares cells against each
# other on one corpus, so absolute dims only need enough capacity); SMOKE
# (CPU plumbing check) shrinks dims/epochs but exercises every command
FLAGSHIP = {"dims": 512, "frames": 26, "batch": 64, "decode_len": 20,
            "epochs": (8, 40, 15), "extra": ["--compute_dtype", "bfloat16"]}
MEDIUM = {"dims": 256, "frames": 26, "batch": 64, "decode_len": 20,
          "epochs": (8, 40, 15), "extra": ["--compute_dtype", "bfloat16"]}
SMOKE = {"dims": 20, "frames": 5, "batch": 4, "decode_len": 12,
         "epochs": (1, 2, 1), "extra": ["--device", "cpu"]}
RECIPES = {"flagship": FLAGSHIP, "medium": MEDIUM, "smoke": SMOKE}
RECIPE = FLAGSHIP


def common_flags(data_dir: str) -> list[str]:
    d = str(RECIPE["dims"])
    return [
        "--data_dir", data_dir,
        "--model.hidden_dim", d, "--model.embed_dim", d,
        "--model.attn_dim", d, "--model.pos_embed_dim", d,
        "--model.num_frames", str(RECIPE["frames"]),
        "--data.batch_size", str(RECIPE["batch"]),
        "--data.caps_per_video_train", "4",
        "--train.lr_decay_every_epochs", "40",
        "--train.log_every_steps", "1000",
        "--eval.max_decode_len", str(RECIPE["decode_len"]),
        *RECIPE["extra"],
    ]


def cell_name(fusion: str, psi: bool) -> str:
    return f"{fusion}_{'pos' if psi else 'nopos'}"


def knob_flags(fusion: str, psi: bool) -> list[str]:
    return ["--model.fusion", fusion,
            "--model.pos_guidance", "true" if psi else "false"]


def run(cmd: list[str], log_path: str, retries: int = 1,
        capture_stdout: bool = False) -> str | None:
    """Run one stage command; stderr (and stdout unless captured) append to
    the cell's grid_log.txt. Returns stdout when capture_stdout=True."""
    print(f"[grid] $ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    for attempt in range(retries + 1):
        with open(log_path, "a") as log:
            log.write(f"\n=== {' '.join(cmd)}\n")
            log.flush()
            res = subprocess.run(
                cmd, cwd=REPO, text=capture_stdout,
                stdout=subprocess.PIPE if capture_stdout else log,
                stderr=log if capture_stdout else subprocess.STDOUT)
        if res.returncode == 0:
            break
        if capture_stdout and res.stdout:
            # a failed attempt's stdout is diagnostic, not a result —
            # preserve it in the grid log (and on the final error below)
            with open(log_path, "a") as log:
                log.write(res.stdout)
        # one retry: a training stage resumes from its own 'last' slot
        if attempt == retries:
            raise subprocess.CalledProcessError(
                res.returncode, cmd,
                output=res.stdout if capture_stdout else None)
        print(f"[grid]   rc={res.returncode}; retrying", flush=True)
        time.sleep(30)
    print(f"[grid]   done in {time.time() - t0:.0f}s", flush=True)
    return res.stdout if capture_stdout else None


def stage(marker_dir: str, name: str, cmd: list[str], log_path: str) -> None:
    marker = os.path.join(marker_dir, f"{name}.done")
    if os.path.exists(marker):
        print(f"[grid] skip {name} (marker exists)", flush=True)
        return
    run(cmd, log_path)
    with open(marker, "w") as f:
        f.write(str(time.time()))


def run_cell(data_dir: str, out: str, fusion: str, psi: bool) -> dict:
    name = cell_name(fusion, psi)
    ck = os.path.join(out, name)
    os.makedirs(ck, exist_ok=True)
    log_path = os.path.join(ck, "grid_log.txt")
    common = common_flags(data_dir)
    knobs = knob_flags(fusion, psi)
    py = [sys.executable, "-m"]

    stage(ck, "pos", py + [
        f"{PKG}.cli.train", "--stage", "pos",
        "--epochs", str(RECIPE["epochs"][0]), "--checkpoint_dir", ck,
        "--train.lr", "1e-3", *common, *knobs], log_path)
    stage(ck, "caption", py + [
        f"{PKG}.cli.train", "--stage", "caption",
        "--epochs", str(RECIPE["epochs"][1]), "--init_from", os.path.join(ck, "pos"),
        "--checkpoint_dir", ck, "--train.lr", "2e-3", *common, *knobs],
        log_path)
    stage(ck, "scst", py + [
        f"{PKG}.cli.train", "--stage", "scst",
        "--epochs", str(RECIPE["epochs"][2]), "--init_from", os.path.join(ck, "caption"),
        "--checkpoint_dir", ck, "--train.lr", "1e-4",
        "--model.dropout", "0.0", *common, *knobs], log_path)

    for ckpt_stage in ("caption", "scst"):
        stage(ck, f"eval_{ckpt_stage}", py + [
            f"{PKG}.cli.eval", "--split", "test",
            "--beam_size", "5",
            "--checkpoint_dir", os.path.join(ck, ckpt_stage),
            *common, *knobs], log_path)

    # controllability: run for every cell — for pos_guidance=off it is the
    # negative control (psi is ignored, so controlled ~= free agreement)
    ctrl_path = os.path.join(ck, "controllability.json")
    if not os.path.exists(ctrl_path):
        cmd = py + [f"{PKG}.tools.controllability_eval",
                    "--data_dir", data_dir,
                    "--checkpoint_dir", os.path.join(ck, "scst"),
                    *common, *knobs]
        # same retry + grid_log stderr capture as every other stage: this
        # runs after hours of training, so a transient failure must not
        # kill the cell silently
        stdout = run(cmd, log_path, capture_stdout=True)
        with open(ctrl_path, "w") as f:
            f.write(stdout)

    cell = {"fusion": fusion, "pos_guidance": psi}
    for ckpt_stage in ("caption", "scst"):
        with open(os.path.join(ck, ckpt_stage, "eval_test.json")) as f:
            cell[f"{ckpt_stage}_metrics"] = json.load(f)["metrics"]
    # prefer a re-capture (both agreement modes + caption dump) when one
    # exists next to the original single-mode capture
    ctrl_v2 = os.path.join(ck, "controllability_v2.json")
    with open(ctrl_v2 if os.path.exists(ctrl_v2) else ctrl_path) as f:
        ctrl = json.load(f)
    cell["controllability"] = {
        k: ctrl[k] for k in
        ("free_run_tag_agreement", "controlled_tag_agreement", "videos")
    }
    if "agreement_by_mode" in ctrl:
        cell["controllability"]["agreement_by_mode"] = (
            ctrl["agreement_by_mode"])
    return cell


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default="data/flagship")
    p.add_argument("--out", default="checkpoints/ablation_grid")
    p.add_argument("--cells", default=None,
                   help="comma list like xgate_pos,concat_nopos (default all)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny dims/epochs on the CPU: validates the plumbing "
                        "(every command runs) without card time")
    p.add_argument("--recipe", choices=sorted(RECIPES), default=None,
                   help="recipe scale (default flagship; --smoke is an "
                        "alias for --recipe smoke)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="forward --device to every stage command (default: the "
                        "recipe's; the stage CLIs run on the card unless told cpu)")
    args = p.parse_args(argv)
    global RECIPE
    if args.smoke:
        RECIPE = SMOKE
    elif args.recipe:
        RECIPE = RECIPES[args.recipe]
    if args.device:
        RECIPE = dict(RECIPE)
        RECIPE["extra"] = [f for f in RECIPE["extra"]
                           if f not in ("--device", "cpu", "cuda")]
        RECIPE["extra"] += ["--device", args.device]

    os.makedirs(args.out, exist_ok=True)
    want = set(args.cells.split(",")) if args.cells else None
    results = []
    for fusion, psi in CELLS:
        if want and cell_name(fusion, psi) not in want:
            continue
        print(f"[grid] ===== cell {cell_name(fusion, psi)} =====", flush=True)
        results.append(run_cell(args.data_dir, args.out, fusion, psi))
        # persist incrementally so a crash keeps finished cells
        with open(os.path.join(args.out, "grid_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    print("[grid] ALL_DONE", flush=True)


if __name__ == "__main__":
    main()
