"""Config system — one dataclass tree with CLI overrides.

The port's own copy of the JAX package's module of the same name (the port
imports nothing of that package); tests/test_torch_metrics.py holds the
two equal.

Rebuilds the reference's argparse `opts.py` / `myopts.py` per-stage flag
modules (SURVEY.md §2 "Config system") as a single typed tree. Flag *names*
mirror the reference's public surface where that surface is known from the
paper/BASELINE.json (hidden size, beam size, scst switch epoch, lr decay...).

Hyperparameter values that could not be confirmed against reference code
(empty mount, SURVEY.md §0) carry a REFERENCE_TBD note so they can be
corrected in minutes if the mount ever appears.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ModelConfig:
    # Feature streams: appearance = InceptionResNetV2 pool (1536-d),
    # motion = I3D RGB (1024-d).  [paper §4.2; BASELINE.json north_star]
    app_dim: int = 1536
    motion_dim: int = 1024
    # REFERENCE_TBD: hidden/embedding sizes recalled as 512 from the paper era.
    hidden_dim: int = 512
    embed_dim: int = 512
    attn_dim: int = 512
    # POS guidance vector psi dimension (paper §3.2 "global syntactic feature").
    pos_embed_dim: int = 512
    vocab_size: int = 0  # filled from corpus info at build time
    pos_vocab_size: int = 0
    num_frames: int = 26  # uniform frames per video [paper §4.2]
    max_caption_len: int = 28  # includes BOS/EOS positions
    max_pos_len: int = 28
    encoder_bidirectional: bool = True
    # paper §4 ablation knobs: fusion="concat" disables cross gating;
    # pos_guidance=False zeroes psi (decoder sees no syntactic signal)
    fusion: str = "xgate"  # xgate | concat
    pos_guidance: bool = True
    dropout: float = 0.5  # REFERENCE_TBD: typical for this codebase era
    dtype: str = "bfloat16"  # compute dtype on TPU; params stay f32
    # decoder variant for the scaled config 5 ("2x hidden-dim decoder")
    decoder_hidden_mult: int = 1


@dataclass
class DataConfig:
    # corpus location/layout is the CLI's --data_dir convention
    # (info.json + labels.npz + features.h5); no duplicate path knobs here
    batch_size: int = 64
    seqs_per_video: int = 20  # GT captions kept per video (pad/sample to this)
    caps_per_video_train: int = 5  # captions drawn per video per XE batch
    num_prefetch: int = 2  # double-buffered host->HBM prefetch depth
    shuffle_seed: int = 0


@dataclass
class TrainConfig:
    lr: float = 4e-4  # REFERENCE_TBD
    lr_decay_rate: float = 0.8  # REFERENCE_TBD
    lr_decay_every_epochs: int = 3  # REFERENCE_TBD
    # 'step' = the reference's epoch-staircase exponential decay;
    # 'cosine' = cosine anneal over train.epochs to lr*lr_final_frac
    # (extension, not in the reference)
    lr_schedule: str = "step"
    # warmup from 0 over this many epochs before either schedule
    # (0 = off, the reference behavior; fractional epochs allowed)
    warmup_epochs: float = 0.0
    lr_final_frac: float = 0.01  # cosine floor, as a fraction of lr
    grad_clip: float = 5.0  # REFERENCE_TBD (torch-era clip_grad norm)
    epochs: int = 50
    scst_start_epoch: int = -1  # -1 = pure XE; >=0 switches to SCST
    scst_cider_weight: float = 1.0
    # SCST rollout realization (train/scst.py): True = one 2B-row no-grad
    # rollout for baseline+sample plus a teacher-forced logp recompute
    # (halved decode weight reads, XE-path backward); False = the original
    # separate rollouts with gradient through the sampling scan. Token-
    # equivalent (parity-tested); the default follows the measured winner
    # on TPU (docs/RESULTS.md round 3).
    scst_paired_rollout: bool = False
    # 0 = off (the reference's plain NLL). >0 = uniform label smoothing on
    # the CAPTION XE term only (extension, not in the reference): loss =
    # (1-eps)*NLL(target) + eps*mean_v NLL(v), computed in lse form so no
    # [B, L, V] log-prob array is materialized
    label_smoothing: float = 0.0
    # seeds parameter init (fresh runs), dropout and SCST sampling; vary
    # it across runs for seed ensembles (tools/average_checkpoints.py)
    seed: int = 1234
    # 0 = off; keep the K most recent per-epoch snapshots as 'epoch_<n>'
    # slots — the trajectory window tools/average_checkpoints.py soups
    keep_epoch_snapshots: int = 0
    # 0 = off; stop when the tracked val metric has not improved for N
    # consecutive eval epochs (counted at eval_every_epochs cadence)
    early_stop_patience: int = 0
    eval_every_epochs: int = 1
    checkpoint_dir: str = "checkpoints"
    keep_best_metric: str = "CIDEr"
    log_every_steps: int = 20
    # POS-generator stage
    pos_lr: float = 4e-4
    pos_epochs: int = 20
    # checkpoint each decoder step in the XE backward (FLOPs-for-HBM trade,
    # enables much larger global batches on config 5)
    remat: bool = False
    # gradient accumulation: process the batch in this many sequential
    # micro-batches (XE stages; exact same update as the full batch at
    # dropout=0, activation memory / accum_steps)
    accum_steps: int = 1


@dataclass
class EvalConfig:
    beam_size: int = 5  # [baseline.json: beam-5 test decoding]
    max_decode_len: int = 28
    length_penalty: float = 0.0  # 0 = pure sum-logprob, like the reference era
    block_unk: bool = False  # suppress <unk> in decoded output (coco-era opt)
    # diverse beam search (arXiv:1610.02424): >1 splits the beam into that
    # many Hamming-penalized groups (must divide beam_size); 0/1 = plain
    # beam. Diversifies n-best pools for --nbest / MBR / reranking.
    diversity_groups: int = 0
    diversity_penalty: float = 0.5
    # decode mode used for per-epoch val eval / best-checkpoint selection.
    # REFERENCE_TBD divergence (SURVEY.md §0): the reference era selected on
    # greedy val decoding and ran beam-5 only at test time; "beam" makes
    # model selection match the test-time decoder at ~K x the eval cost.
    select_decode: str = "greedy"  # greedy | beam
    split: str = "test"
    metrics: tuple = ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


@dataclass
class ParallelConfig:
    num_devices: int = 0  # 0 = use all visible devices
    mesh_axis: str = "data"  # 1-D data-parallel mesh (SURVEY.md §2: DP only)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def replace_flat(self, overrides: dict[str, Any]) -> "Config":
        """Apply {"model.hidden_dim": 1024, ...} style dotted overrides."""
        cfg = self
        for key, value in overrides.items():
            parts = key.split(".")
            if len(parts) != 2:
                raise KeyError(f"override key must be 'section.field': {key!r}")
            section, fname = parts
            sub = getattr(cfg, section)
            if not hasattr(sub, fname):
                raise KeyError(f"unknown config field {key!r}")
            current = getattr(sub, fname)
            if current is not None and not isinstance(current, (list, tuple, dict)):
                value = _coerce(value, type(current))
            cfg = dataclasses.replace(
                cfg, **{section: dataclasses.replace(sub, **{fname: value})}
            )
        return cfg


def _coerce(value: Any, ty: type) -> Any:
    if isinstance(value, ty):
        return value
    if ty is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return ty(value)


def load_config(
    path: Optional[str] = None, overrides: Optional[dict[str, Any]] = None
) -> Config:
    """Load a config from a JSON file (optional) and apply dotted overrides."""
    cfg = Config()
    if path:
        with open(path) as f:
            raw = json.load(f)
        flat = {}
        for section, fields in raw.items():
            if isinstance(fields, dict):
                for fname, value in fields.items():
                    flat[f"{section}.{fname}"] = value
        cfg = cfg.replace_flat(flat)
    if overrides:
        cfg = cfg.replace_flat(overrides)
    return cfg


def parse_cli_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse ["--model.hidden_dim", "1024", "--train.lr=1e-3"] style args."""
    out: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected positional arg {arg!r}")
        body = arg[2:]
        if "=" in body:
            key, value = body.split("=", 1)
            i += 1
        else:
            key = body
            if i + 1 >= len(argv):
                raise ValueError(f"flag {arg!r} missing a value")
            value = argv[i + 1]
            i += 2
        out[key] = value
    return out
