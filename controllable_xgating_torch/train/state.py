"""Train state, optimizer, learning-rate schedules and checkpoints.

Counterpart of `controllable_xgating_tpu/train/state.py`:

- `TrainState` holds the parameters, the optimizer state (a
  `torch.optim.Adam`), the step and a `torch.Generator` in place of the
  JAX key. The train step updates it in place.
- `make_optimizer` is `optax.chain(clip_by_global_norm(grad_clip),
  adam(schedule))`, term for term: the clip is optax's (g * max / norm
  only when norm >= max, not `clip_grad_norm_`'s max / (norm + 1e-6)),
  and the learning rate is read at the count of updates before this one,
  as optax's `scale_by_schedule` does. Adam with that rate is optax's
  bias-corrected update: lr * m_hat / (sqrt(v_hat) + eps).
- Stage freezing is a gradient mask: frozen parameters get zero
  gradient, so their Adam moments stay 0 and the parameters unchanged.
- `CheckpointManager` writes a torch `state_dict` (params, optimizer,
  step, generator state) as `<name>.pt` beside the same `<name>.infos.json`
  sidecar, and keeps the JAX package's architecture checks on restore.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch

from controllable_xgating_torch.models.captioner import CaptionerParams

STAGES = ("pos", "caption", "joint")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults

Schedule = Callable[[int], float]


@dataclass
class TrainState:
    params: CaptionerParams
    opt_state: torch.optim.Adam
    step: int
    gen: torch.Generator


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, as optax.global_norm."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_lr_schedule(cfg, steps_per_epoch: int, stage: str = "joint") -> Schedule:
    """count -> lr(count), optax's schedules written out.

    'step' (default) is the epoch staircase: lr * decay_rate **
    floor(count / (decay_every_epochs * steps_per_epoch)); 'cosine' anneals
    to lr * lr_final_frac over the budget after warmup; `warmup_epochs > 0`
    prepends a linear 0 -> lr ramp, after which the schedule counts from
    the end of the warmup. The POS stage starts from `train.pos_lr`."""
    base_lr = cfg.train.pos_lr if stage == "pos" else cfg.train.lr
    kind = getattr(cfg.train, "lr_schedule", "step")
    warmup = float(getattr(cfg.train, "warmup_epochs", 0.0))
    wsteps = max(int(warmup * steps_per_epoch), 1) if warmup > 0.0 else 0
    if kind == "step":
        every = max(cfg.train.lr_decay_every_epochs * steps_per_epoch, 1)
        rate = cfg.train.lr_decay_rate

        def schedule(count):
            if count <= 0 or rate == 0:
                return base_lr
            return base_lr * rate ** math.floor(count / every)
    elif kind == "cosine":
        decay_steps = max(cfg.train.epochs * steps_per_epoch - wsteps, 1)
        alpha = float(getattr(cfg.train, "lr_final_frac", 0.01))

        def schedule(count):
            count = min(count, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return base_lr * ((1.0 - alpha) * cosine + alpha)
    else:
        raise ValueError(f"train.lr_schedule must be 'step' or 'cosine', got {kind!r}")
    if not wsteps:
        return schedule
    decay = schedule

    def warmed(count):
        if count < wsteps:  # optax.linear_schedule(0, lr, wsteps)
            return base_lr * min(max(count, 0), wsteps) / wsteps
        return decay(count - wsteps)

    return warmed


def init_adam(params: CaptionerParams) -> torch.optim.Adam:
    """optax.adam's state for `params`; the step sets its rate."""
    return torch.optim.Adam(list(params.parameters()), lr=0.0, betas=(ADAM_B1, ADAM_B2),
                            eps=ADAM_EPS)


class Optimizer:
    """Global-norm clip, then Adam (the train state's `init_adam`) at the
    scheduled rate."""

    def __init__(self, schedule: Schedule, max_norm: float):
        self.schedule = schedule
        self.max_norm = float(max_norm)

    def apply(self, state: TrainState, grads: dict) -> torch.Tensor:
        """One update of `state` in place from {name: gradient}; advances
        `state.step` and returns the gradients' global norm (before the
        clip)."""
        norm = global_norm(grads.values())
        keep = norm < self.max_norm
        opt = state.opt_state
        for name, p in state.params.named_parameters():
            g = grads[name]
            p.grad = torch.where(keep, g, g / norm * self.max_norm)
        for group in opt.param_groups:
            group["lr"] = float(self.schedule(state.step))
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return norm


def make_optimizer(cfg, steps_per_epoch: int, stage: str = "joint") -> Optimizer:
    """Adam + global-norm clip + the configured lr schedule. The POS stage
    uses its own base lr (`train.pos_lr`)."""
    return Optimizer(make_lr_schedule(cfg, steps_per_epoch, stage), cfg.train.grad_clip)


def stage_grad_mask(params: CaptionerParams, stage: str) -> dict:
    """{parameter name: 0.0 or 1.0}: which submodules train in this stage.

    pos stage:     encoder + POS generator (the reference's stage 1)
    caption stage: encoder + decoder, POS generator frozen (stage 2)
    joint:         everything
    """
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
    frozen = {"caption": "pos.", "pos": "decoder."}.get(stage)
    return {name: 0.0 if frozen and name.startswith(frozen) else 1.0
            for name, _ in params.named_parameters()}


def apply_grad_mask(grads: dict, mask: dict) -> dict:
    return {name: g * mask[name] for name, g in grads.items()}


def create_train_state(params: CaptionerParams, cfg, seed: Optional[int] = None) -> TrainState:
    """Switch the parameters to training (requires_grad on), give them an
    Adam state, and seed the dropout generator on their device from
    `train.seed` (or `seed`). Unlike the JAX state it holds no schedule, so
    it takes no steps per epoch: the step's `make_optimizer` reads the rate."""
    params.requires_grad_(True)
    dev = next(params.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed if seed is None else seed)
    return TrainState(params=params, opt_state=init_adam(params), step=0, gen=gen)


# ---------------------------------------------------------------- checkpoint


class CheckpointManager:
    """Save and restore train states as `<dir>/<name>.pt` plus the
    `<dir>/<name>.infos.json` sidecar; `best` and `last` slots."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    @staticmethod
    def load_infos(directory: str, name: str) -> dict:
        """Read the `<dir>/<name>.infos.json` sidecar (static: reading it
        needs no manager and makes no directory)."""
        with open(os.path.join(os.path.abspath(directory), name + ".infos.json")) as f:
            return json.load(f)

    def save(self, name: str, state: TrainState, infos: dict) -> None:
        path = self._path(name)
        blob = {
            "params": state.params.state_dict(),
            "opt_state": state.opt_state.state_dict(),
            "step": int(state.step),
            "gen": state.gen.get_state(),
        }
        torch.save(blob, path + ".pt.tmp")
        os.replace(path + ".pt.tmp", path + ".pt")
        with open(path + ".infos.json", "w") as f:
            json.dump(infos, f)

    def restore(self, name: str, template: TrainState) -> tuple[TrainState, dict]:
        """Load slot `name` into `template` (in place) and return it with
        the sidecar. A checkpoint written under another vocabulary, fusion
        mode or `pos_guidance` is refused with the flag to change."""
        path = self._path(name)
        infos = self.load_infos(self.directory, name)
        saved_model = (infos.get("config") or {}).get("model")
        if saved_model:
            dec = template.params.decoder
            if saved_model.get("vocab_size") not in (None, dec.vocab_size):
                raise ValueError(
                    f"checkpoint {path!r} was trained with vocab_size="
                    f"{saved_model['vocab_size']} but the current corpus has "
                    f"{dec.vocab_size} — the corpus changed under this "
                    "checkpoint_dir; point --checkpoint_dir somewhere fresh"
                )
            tmpl_fusion = template.params.encoder.xgate.mode
            saved_fusion = saved_model.get("fusion", "xgate")
            if saved_fusion != tmpl_fusion:
                raise ValueError(
                    f"checkpoint {path!r} was trained with model.fusion="
                    f"{saved_fusion!r} but this run is configured for "
                    f"{tmpl_fusion!r}; re-run with --model.fusion {saved_fusion}"
                )
            saved_psi = bool(saved_model.get("pos_guidance", True))
            if saved_psi != dec.use_psi:
                raise ValueError(
                    f"checkpoint {path!r} was trained with "
                    f"model.pos_guidance={saved_psi} but this run is "
                    f"configured for {dec.use_psi}; re-run with "
                    f"--model.pos_guidance {str(saved_psi).lower()}"
                )
        blob = torch.load(path + ".pt", map_location="cpu", weights_only=True)
        with torch.no_grad():
            template.params.load_state_dict(blob["params"])
        template.opt_state.load_state_dict(blob["opt_state"])
        template.step = int(blob["step"])
        template.gen.set_state(blob["gen"])
        return template, infos

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name) + ".infos.json")

    def delete(self, name: str) -> None:
        """Remove slot `name` if present (a missing slot is a no-op)."""
        for suffix in (".pt", ".infos.json"):
            try:
                os.remove(self._path(name) + suffix)
            except FileNotFoundError:
                pass

    def save_best(self, state: TrainState, infos: dict) -> None:
        self.save("best", state, infos)

    def save_last(self, state: TrainState, infos: dict) -> None:
        self.save("last", state, infos)
