"""Shared CLI plumbing: argument parsing, device and compute policy,
corpus and feature loading, parameters from checkpoints.

Counterpart of `controllable_xgating_tpu/cli/common.py`. `--device`
takes `--platform`'s place: the CLIs run on the card unless the caller
asks for the CPU, and without a CUDA device `--device cuda` exits with a
message instead of carrying on on the CPU; `--compile_cache` is refused,
as the port has no compile cache. The compute policy a CLI picks
is scoped to its `main` (`ops/precision.py::precision`), so an in-process
caller finds the policy as it left it.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from controllable_xgating_torch.data.corpus import CorpusInfo, load_labels
from controllable_xgating_torch.data.features import FEATURES_DIR, FeatureStore
from controllable_xgating_torch.models.captioner import CaptionerParams, init_captioner
from controllable_xgating_torch.parallel.distributed import initialize_from_env, local_device
from controllable_xgating_torch.train.state import (
    CheckpointManager,
    TrainState,
    create_train_state,
)
from controllable_xgating_torch.utils.config import Config, load_config, parse_cli_overrides


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "Any config field can be overridden with --<section>.<field> "
            "<value>, e.g. --model.hidden_dim 1024 --train.lr 1e-4"
        ),
    )
    p.add_argument("--data_dir", required=True,
                   help="corpus dir (info.json, labels.npz, features/)")
    p.add_argument("--config", default=None, help="optional config JSON")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    p.add_argument("--compute_dtype", default=None, choices=("float32", "bfloat16"),
                   help="matmul operand dtype (accumulation is always f32); default "
                        "model.dtype on the card, float32 on the CPU")
    # accepted so that they can be refused by name (see apply_runtime_flags)
    p.add_argument("--compile_cache", default=None, help=argparse.SUPPRESS)
    p.add_argument("--profile", default=None, metavar="LOGDIR", help=argparse.SUPPRESS)
    p.add_argument("--debug_nans", action="store_true", help=argparse.SUPPRESS)
    return p


def apply_runtime_flags(args, cfg: Config) -> tuple[torch.device, str]:
    """(device, compute dtype) for this run: `--compute_dtype` when given,
    else `model.dtype` (bf16) on the card and float32 on the CPU, as the
    JAX CLIs pick by backend. The caller runs under `precision(dtype)`.
    Refuses what the port does not run yet. Where the environment names a
    process group (`parallel/distributed.py::initialize_from_env`: the
    CXG_* variables or torchrun's), the process joins it (NCCL on the
    card, gloo on the CPU) and its device is its own card,
    `cuda:LOCAL_RANK`. `parallel.num_devices` is left to each CLI."""
    if args.compile_cache is not None:
        die("--compile_cache has no counterpart in the port: it keeps no XLA compile cache "
            "(its kernels are built once per checkout, under build/kernels)")
    if args.profile:
        die("--profile is not ported yet (ROADMAP A10, measurement); "
            "use python -m controllable_xgating_torch.utils.profiling")
    if args.debug_nans:
        die("--debug_nans is not ported yet (ROADMAP A10, measurement)")
    device, dtype = runtime_device(args.device, args.compute_dtype, cfg)
    if initialize_from_env(device.type):
        device = local_device(device.type)
    return device, dtype


def runtime_device(name: str, compute_dtype, cfg: Config) -> tuple[torch.device, str]:
    """(device, compute dtype) for `--device name` and `--compute_dtype`:
    without a CUDA device, `cuda` exits 1 instead of carrying on on the
    CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        die("--device cuda: no CUDA device is available; pass --device cpu to run on the CPU")
    dtype = compute_dtype or (cfg.model.dtype if device.type == "cuda" else "float32")
    return device, dtype


def parse_with_overrides(p: argparse.ArgumentParser, argv=None):
    """Split known args from --section.field overrides."""
    args, rest = p.parse_known_args(argv)
    overrides = parse_cli_overrides(rest)
    cfg = load_config(args.config, overrides)
    return args, cfg


def load_corpus(data_dir: str, cfg: Config):
    """Load info, labels and features; finalize the model dims from the
    corpus. Refuses a corpus whose features are only in the JAX package's
    HDF5 file, naming the converter."""
    feat = os.path.join(data_dir, FEATURES_DIR)
    if not os.path.isdir(feat) and os.path.exists(os.path.join(data_dir, "features.h5")):
        raise FileNotFoundError(
            f"{data_dir!r} holds features.h5 but no {FEATURES_DIR}/: the port reads no HDF5; "
            f"convert it first with: python -m controllable_xgating_torch.data.features {data_dir}"
        )
    info = CorpusInfo.load(os.path.join(data_dir, "info.json"))
    labels = load_labels(data_dir)
    cfg = cfg.replace_flat({
        "model.vocab_size": len(info.vocab),
        "model.pos_vocab_size": len(info.pos_vocab),
        "model.max_caption_len": info.max_caption_len,
        "model.max_pos_len": info.max_pos_len,
    })
    store = FeatureStore(feat, cfg.model.num_frames)
    if store.app_dim != cfg.model.app_dim or store.motion_dim != cfg.model.motion_dim:
        cfg = cfg.replace_flat({"model.app_dim": store.app_dim, "model.motion_dim": store.motion_dim})
    return info, labels, store, cfg


# model fields adopted by --use_ckpt_config. Corpus-derived fields (vocab
# sizes, caption/POS lengths) and feature widths stay with the corpus and
# store; dropout is a train-time knob.
CKPT_MODEL_FIELDS = (
    "hidden_dim", "embed_dim", "attn_dim", "pos_embed_dim", "num_frames",
    "encoder_bidirectional", "fusion", "pos_guidance",
    "decoder_hidden_mult", "dtype",
)


def add_ckpt_args(p: argparse.ArgumentParser) -> None:
    """--ckpt_name / --use_ckpt_config, shared by eval and caption."""
    p.add_argument("--ckpt_name", default="best")
    p.add_argument("--use_ckpt_config", action="store_true",
                   help="adopt the checkpoint's saved architecture knobs "
                        "(dims/fusion/pos_guidance) instead of flags")


def maybe_adopt_ckpt_config(args, cfg: Config) -> Config:
    """Apply --use_ckpt_config if set."""
    if args.use_ckpt_config:
        cfg = adopt_ckpt_model_config(args.checkpoint_dir, cfg, args.ckpt_name)
    return cfg


def adopt_ckpt_model_config(ckpt_dir: str, cfg: Config, name: str = "best") -> Config:
    """Apply the checkpoint's saved architecture knobs to `cfg`, so an
    ablation checkpoint evaluates without re-passing every override."""
    saved = saved_model_config(ckpt_dir, name)
    return cfg.replace_flat({f"model.{k}": saved[k] for k in CKPT_MODEL_FIELDS if k in saved})


def saved_model_config(ckpt_dir: str, name: str = "best") -> dict:
    """The model section of checkpoint `name`'s sidecar (refused when the
    sidecar is missing or carries none)."""
    try:
        infos = CheckpointManager.load_infos(ckpt_dir, name)
    except OSError as e:
        raise FileNotFoundError(
            f"no checkpoint infos for {name!r} in {ckpt_dir!r} ({e}); cannot adopt its config"
        ) from None
    saved = (infos.get("config") or {}).get("model")
    if not saved:
        raise ValueError(
            f"checkpoint {name!r} in {ckpt_dir!r} carries no model config; pass the "
            "architecture flags explicitly instead"
        )
    return saved


def add_ensemble_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--ensemble", nargs="+", default=None, metavar="CKPT_DIR[:NAME]",
        help="decode with a log-prob ensemble of 2+ checkpoints (NAME defaults to 'best'); "
             "members may differ in architecture (fusion, psi, dims) but share the corpus; "
             "the first member's saved model config is adopted and --checkpoint_dir is "
             "ignored",
    )


def split_ckpt_spec(spec: str) -> tuple[str, str]:
    """`<ckpt_dir>[:<name>]` -> (dir, name). Splits on the last colon, and
    only when the suffix holds no '/': a path separator after the colon
    means the colon belongs to the directory (`runs/2026:aug/ck1`)."""
    d, sep, name = spec.rpartition(":")
    if sep and "/" not in name:
        return d, (name or "best")
    return spec, "best"


def restore_ensemble_params(specs: list, cfg: Config, device) -> tuple[tuple, int]:
    """Restore >= 2 `<ckpt_dir>[:<name>]` checkpoints on `device` for
    ensemble decoding -> (tuple of members' `CaptionerParams`, count).

    Each member restores under its own saved model config (members may
    differ in fusion, pos_guidance or dims) through `restore_params`, so a
    missing checkpoint is refused, never replaced by random weights. A
    member trained on another vocab than the run's corpus, or fewer than
    two members, exit 1. Members of one architecture and of several come
    back alike: the port decodes both on one path
    (`infer/ensemble.py::make_ensemble_caption_fn`)."""
    if len(specs) < 2:
        die("--ensemble needs at least two checkpoints")
    members = []
    for spec in specs:
        d, name = split_ckpt_spec(spec)
        saved = saved_model_config(d, name)
        vocab = saved.get("vocab_size", cfg.model.vocab_size)
        if vocab != cfg.model.vocab_size:
            die(f"ensemble member {spec} was trained with vocab {vocab}, run corpus has "
                f"{cfg.model.vocab_size} — members must share the corpus")
        members.append(restore_params(d, adopt_ckpt_model_config(d, cfg, name), device, name=name))
    return tuple(members), len(members)


def adopt_run_config(args, cfg: Config) -> Config:
    """The run's architecture config: an ensemble run adopts its first
    member's saved model config (the members' saved shapes are the only
    ones that restore, so --model.* flags are replaced); a single
    checkpoint follows --use_ckpt_config."""
    if getattr(args, "ensemble", None):
        d, name = split_ckpt_spec(args.ensemble[0])
        return adopt_ckpt_model_config(d, cfg, name)
    return maybe_adopt_ckpt_config(args, cfg)


def _require(mgr: CheckpointManager, name: str) -> None:
    if not mgr.exists(name):
        raise FileNotFoundError(
            f"no checkpoint named {name!r} under {mgr.directory!r} (expected "
            f"{mgr._path(name)!r}.pt); refusing to fall back to randomly initialized parameters"
        )


def restore_or_init(
    ckpt_dir: str, cfg: Config, device, name: str, init_seed: int = 0,
) -> tuple[TrainState, dict, CheckpointManager]:
    """Restore train state `name` from ckpt_dir if present (a train run
    resuming on its own checkpoint_dir), else a fresh state from
    `init_captioner(cfg, seed=init_seed)` on `device`."""
    mgr = CheckpointManager(ckpt_dir)
    found = mgr.exists(name)
    params = init_captioner(cfg, seed=None if found else init_seed, device=device)
    template = create_train_state(params, cfg)
    if found:
        state, infos = mgr.restore(name, template)
        return state, infos, mgr
    return template, {}, mgr


def restore_params(ckpt_dir: str, cfg: Config, device, name: str = "best") -> CaptionerParams:
    """The parameters of checkpoint `name` on `device` (required: never a
    random fallback), for inference (no gradients). The checkpoint fills
    storage of the parameters' shapes; no random weights are drawn."""
    mgr = CheckpointManager(ckpt_dir)
    _require(mgr, name)
    params = init_captioner(cfg, seed=None, device=device)
    mgr.restore_params(name, params)
    return params.requires_grad_(False)


def die(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(1)
