"""Online serving engine: dynamic micro-batching into the big-batch decoder.

Counterpart of `controllable_xgating_tpu/serve/engine.py`. The decoder is
throughput-optimal at large batch, so the engine turns an online stream
of single-video requests into batched device dispatches without
unbounded queueing delay:

  * callers `submit()` a request and get a `concurrent.futures.Future`;
  * a dispatcher thread coalesces requests that arrive within
    `max_wait_ms` of the first queued one (or until the largest bucket
    fills) into ONE device call;
  * batches are padded up to a fixed set of batch-size *buckets*, so the
    decode loops' CUDA graphs (`infer/graphs.py`) are captured once per
    bucket, never per request count;
  * mixed free-run / POS-controlled requests share a batch: the call
    always rolls the POS generator and, where a row is controlled,
    teacher-forces the user tags and selects psi per row (`use_tags`),
    so controllability costs no extra dispatch (a batch without a
    controlled row skips the teacher-forced pass, whose psi no row would
    take: the same tokens, without its eager 27-step scan);
  * everything downstream of the queue is the library code the offline
    paths (`cli.eval`, `cli.caption`) call: `encode_for_inference`, then
    `greedy_decode` / `beam_search` (or the ensemble paths) with
    `early_stop`, on the port's kernels (K1-K3, and K4 for beam k <= 8).
    The engine builds no graph code of its own: each bucket gets its keys
    in the graph cache, held for the engine's life (`graphs.hold`).

Latency accounting (p50/p99 over a sliding window) and batch-occupancy
counters are exposed via `stats()` and served by `serve/server.py`.

Data-parallel serving (`mesh`, a `parallel/mesh.py::Mesh`): the
parameters (every ensemble member) are replicated, one copy per distinct
device, and every bucket batch is split into one contiguous block of rows
per device, each decoded by the same library calls on its device (its
graph keys held like the others). Each block's packed output is copied
into its rows of the batch's one pinned host buffer behind an event on
its device; the completion thread waits on every event.

Transfer discipline:

  * features are fed to the device in the COMPUTE dtype (bf16 under the
    bf16 policy: the encoder's first matmul rounds them there anyway, so
    this is bit-identical and halves the host-to-device bytes), staged in
    pinned memory and copied without blocking;
  * the device call packs tokens, tags and scores into ONE int32 tensor,
    copied without blocking into pinned memory behind a CUDA event that
    the completion thread waits on: one device-to-host transfer a batch;
  * dispatch and completion run on separate threads: the dispatcher
    assembles and enqueues batch N+1 while the completion thread drains
    batch N (bounded at `max_inflight` batches of backpressure).

Threads and the device. The dispatcher is the one thread that decodes
(`warmup` takes the same lock from its caller's thread). Every device call
runs under `torch.inference_mode()`, as the offline caption functions do
(grad mode is per thread, and a caller's parameters may require grad:
with grad on, `graphs.resolve_mode` would send every loop to the eager
path), and under the compute dtype the engine was built with, pinned for
the calling thread (`precision.thread_precision`), so a later change of
the process-global policy in another thread changes no served token. The
capture of a bucket's first batch may run while the completion thread
waits on an event: `infer/graphs.py` captures in `thread_local` mode for
that.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass
from queue import Empty, Full, Queue
from typing import Optional, Sequence

import numpy as np
import torch

from controllable_xgating_torch.data.features import _fit_frames
from controllable_xgating_torch.data.vocab import PAD, Vocab, pad_encode
from controllable_xgating_torch.infer import graphs
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.ensemble import ensemble_greedy_decode
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.precision import compute_dtype, thread_precision
from controllable_xgating_torch.parallel.mesh import device_scope, replicate, shard_rows
from controllable_xgating_torch.utils.config import Config


@dataclass
class CaptionResult:
    caption: str
    pos_sequence: str
    controlled: bool
    score: Optional[float]  # beam logprob (None for greedy)
    latency_ms: float
    batch_size: int  # bucket the request rode in
    # engine nbest>0 only: the full scored beam, best-first; nbest[0] is
    # always (caption, score)
    nbest: Optional[list] = None


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full."""


class DeadlineExceeded(EngineOverloaded):
    """Set on a request's Future when its deadline passed while it was
    still queued (shed at the queue head — the device never sees it).
    Subclasses EngineOverloaded so HTTP callers get the same 503/retry
    treatment: both mean 'the engine could not serve you in time'."""


@dataclass
class _Request:
    app: np.ndarray          # [T, Da] fitted to num_frames
    motion: np.ndarray       # [T, Dm]
    nframes: int
    pos_tags: Optional[np.ndarray]  # [Lp] int32, or None = free-run
    future: Future
    t_submit: float
    t_deadline: Optional[float] = None  # monotonic; None = no deadline


class ServingEngine:
    """Micro-batching caption server around the library decode calls.

    Thread-safe: any number of producer threads may `submit()`; one
    dispatcher thread owns the device. `close()` drains and joins.
    """

    def __init__(
        self,
        params,
        cfg: Config,
        vocab: Vocab,
        pos_vocab: Vocab,
        mode: str = "beam",
        buckets: Sequence[int] = (1, 4, 16, 64),
        max_wait_ms: float = 5.0,
        fused: Optional[bool] = None,
        latency_window: int = 2048,
        max_inflight: int = 2,
        mesh=None,
        max_queue: int = 0,
        n_members: int = 0,
        nbest: int = 0,
        shed_margin: float = 1.3,
        adaptive_margin: bool = False,
    ):
        """`params`: a `CaptionerParams` on the device that serves (the
        card, or the CPU where the caller put them there), or with
        `n_members` > 0 a tuple of that many members (`infer/ensemble.py`'s
        layout, as `cli.common.restore_ensemble_params` returns it): every
        batch then decodes with the mean-log-prob ensemble, each member on
        its own K1-K3 operands, as `cxg-eval --ensemble` does.

        `mesh`: serve data-parallel over its devices (module docstring);
        every bucket must divide by its size.

        `max_queue` > 0 bounds the request queue: submit() raises
        EngineOverloaded once that many requests are waiting (load
        shedding — under sustained overload an unbounded queue just turns
        every caller's latency into the backlog drain time; rejecting
        early lets clients back off / retry elsewhere). 0 = unbounded.

        `nbest` > 0 (beam mode only, <= eval.beam_size): every result
        additionally carries the `nbest` best hypotheses with scores
        (`CaptionResult.nbest`, best-first; the packed transfer grows by
        (nbest-1) token rows + nbest scores per request).

        `shed_margin` scales the predicted pipeline latency in the
        deadline-aware dispatcher (_dispatch_loop): > 1 sheds earlier and
        rides smaller buckets, trading goodput for fewer late
        completions. The default 1.3 is the JAX engine's, chosen there by
        a margin study on its own hardware; the margin only engages when
        a prediction approaches a deadline, so it is inert at low load.

        `adaptive_margin=True` makes that knob self-tuning: a slow
        feedback loop on the engine's own measured late-completion
        fraction (multiplicative increase when completed-with-deadline
        requests arrive late, slow decay toward the configured
        `shed_margin` floor when the tail clears — see _update_margin).
        The configured `shed_margin` is the starting value AND the
        floor.

        The compute dtype is the policy's at construction
        (`ops/precision.py`), for the engine's life."""
        if mode not in ("greedy", "beam"):
            raise ValueError(f"mode must be greedy|beam, got {mode!r}")
        if nbest:
            if mode != "beam":
                raise ValueError("nbest requires mode='beam'")
            if not 0 < nbest <= cfg.eval.beam_size:
                raise ValueError(
                    f"nbest must be in [1, eval.beam_size={cfg.eval.beam_size}]"
                )
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        if shed_margin <= 0:
            raise ValueError("shed_margin must be > 0")
        dg = int(getattr(cfg.eval, "diversity_groups", 0) or 0)
        if mode == "beam" and dg > 1 and cfg.eval.beam_size % dg:
            # fail at construction, not as a poisoned exception on every
            # dispatched batch (same convention as the nbest checks above)
            raise ValueError(
                f"eval.diversity_groups={dg} must divide "
                f"eval.beam_size={cfg.eval.beam_size}"
            )
        if mesh is not None:
            bad = [b for b in buckets if b % mesh.size]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the {mesh.size}-device mesh")
        ens = int(n_members or 0)
        if ens and (not isinstance(params, (tuple, list)) or len(params) != ens):
            raise ValueError(f"n_members={ens} needs a tuple of {ens} members' parameters")
        self.params = tuple(params) if ens else params
        self._mesh = mesh
        # {device: its copy of the parameters}, one per distinct device
        self._replicas = None if mesh is None else replicate(self.params, mesh)
        self.cfg = cfg
        self.vocab = vocab
        self.pos_vocab = pos_vocab
        self.mode = mode
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = max_wait_ms / 1e3
        self.shed_margin = float(shed_margin)
        self.adaptive_margin = bool(adaptive_margin)
        # the LIVE margin the dispatcher reads (== shed_margin when not
        # adaptive); float reads/writes are atomic under the GIL
        self._margin = float(shed_margin)
        self._late_ewma = 0.0
        self._t_last_late = 0.0   # monotonic time of the last late completion
        self._t_last_decay = 0.0
        self._n_late_completed = 0      # completed AFTER their own deadline
        self._n_deadline_completed = 0  # completed requests that had one
        self._queue: Queue[_Request] = Queue(maxsize=max(max_queue, 0))
        # (requests, host output, bucket, ...) in flight; bounded = backpressure
        self._completion: Queue = Queue(maxsize=max_inflight)
        self._closed = threading.Event()
        # serializes the closed-check+enqueue in submit() against close()
        # setting the flag, so no request can slip into the queue after the
        # dispatcher has decided it is drained (its Future would never
        # resolve)
        self._submit_lock = threading.Lock()
        self._lat = deque(maxlen=latency_window)
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded_rows = 0
        self._n_rejected = 0
        self._n_cancelled = 0   # Futures cancelled before dispatch
        self._n_expired = 0     # deadlines shed at the queue head
        self._n_shed_predicted = 0  # subset of expired: deadline was still
        # in the future at claim time but predicted unmeetable (see _claim)
        # PER-BUCKET EWMA of per-pipeline-slot service time: a batch's
        # claim->result latency divided by (batches ahead of it at claim
        # + 1), keyed by the bucket it rode. The dispatcher multiplies it
        # by the CURRENT in-flight depth, so the prediction falls the
        # moment shedding drains the pipeline — predicting with raw
        # claim->result latency instead death-spirals under overload
        # (everything shed -> nothing completes -> the stale estimate
        # never decays -> shed forever). Per-BUCKET because service time
        # grows with batch size: a request that no large-bucket batch can
        # serve within its deadline may still be servable in a smaller
        # one. One global estimate can only shed everything there; the
        # per-bucket table lets the dispatcher trade throughput for
        # meetable latency (see _dispatch_loop). Fed by the completion
        # thread, read lock-free; empty until the first batch completes,
        # so a cold engine never predictively sheds. Values are
        # (slot_seconds, monotonic time of last update) — see _SLOT_TTL_S.
        self._ewma_slot_s: dict[int, tuple[float, float]] = {}
        # requests the dispatcher is holding for a later batch (visible
        # to stats(): under overload this is where waiting requests live,
        # not the queue) + a completion signal so a full-carry dispatcher
        # waits for the event that actually changes the estimate instead
        # of polling
        self._n_deferred = 0
        self._progress = threading.Event()

        self.n_members = ens
        self._nbest = int(nbest or 0)
        # every member keeps its own K1-K3 (`infer/ensemble.py`): the JAX
        # engine's `fused=False if ens` belongs to its member vmap
        self._fused = fused_enabled(fused)
        self._device = next((params[0] if ens else params).parameters()).device
        # the compute dtype, fixed here for the engine's life; features are
        # fed in it (see the module docstring)
        self._dtype = compute_dtype()
        # the seam through which the dispatcher calls the device:
        # (params, app, motion, frame_mask, pos_tags, use_tags) -> packed
        self._fn = self._run
        # one device caller at a time (the dispatcher, or warmup)
        self._device_lock = threading.Lock()
        # the graph keys of this engine's batches, held until close()
        self._keys: set = set()
        graphs.hold(self._keys)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="cxg-serve-dispatch", daemon=True
        )
        self._finisher = threading.Thread(
            target=self._completion_loop, name="cxg-serve-finish", daemon=True
        )
        self._dispatcher.start()
        self._finisher.start()

    # ---------------------------------------------------------------- device

    def _run(self, params, app, motion, frame_mask, pos_tags, use_tags) -> torch.Tensor:
        """One bucket batch through the library calls -> the packed int32
        [bucket, nb*L + Lp + nb] (tokens | tags | scores' bits) on the
        device. Inputs are tensors on the device, features in the feed
        dtype; `pos_tags` and `use_tags` are None for a batch without a
        controlled row."""
        m, ev = self.cfg.model, self.cfg.eval
        # features arrive in the compute dtype (H2D economy); upcast on the
        # device so downstream dtypes match the offline path exactly
        app, motion = app.float(), motion.float()
        # the SAME prolog the offline paths use (per-row use_tags mixes
        # controlled and free-run requests in one batch); for an ensemble
        # each member runs its own encode and POS rollout
        members = params if self.n_members else (params,)
        enc = [
            encode_for_inference(
                p, app, motion, frame_mask, pos_tags=pos_tags, max_pos_len=m.max_pos_len,
                fused=self._fused, early_stop=True, use_tags=use_tags,
            )
            for p in members
        ]
        tags_out = enc[0][2]
        dec = tuple(p.decoder for p in members)
        ctx, summary = tuple(e[0] for e in enc), tuple(e[1] for e in enc)
        if not self.n_members:
            dec, ctx, summary = dec[0], ctx[0], summary[0]
        if self.mode == "greedy":
            if self.n_members:
                tokens = ensemble_greedy_decode(
                    dec, ctx, summary, ev.max_decode_len, block_unk=ev.block_unk,
                    early_stop=True, fused=self._fused,
                )
            else:
                tokens = greedy_decode(
                    dec, ctx, summary, ev.max_decode_len, fused=self._fused,
                    block_unk=ev.block_unk, early_stop=True,
                )
            scores = torch.zeros((tokens.shape[0], 1), dtype=torch.float32,
                                 device=tokens.device)
        else:
            tokens, scores = beam_search(
                dec, ctx, summary, ev.beam_size, ev.max_decode_len, ev.length_penalty,
                fused=self._fused, block_unk=ev.block_unk, early_stop=True,
                n_members=self.n_members, return_all=bool(self._nbest),
                diversity_groups=ev.diversity_groups,
                diversity_penalty=ev.diversity_penalty,
            )
            if self._nbest:
                # [B, K, L] best-first -> keep the nbest rows; flatten into
                # the packed row so completion stays one transfer
                tokens = tokens[:, :self._nbest].reshape(tokens.shape[0], -1)
                scores = scores[:, :self._nbest]
            else:
                scores = scores[:, None]
        # one packed int32 output = one device-to-host transfer
        return torch.cat([
            tokens.to(torch.int32),
            tags_out.to(torch.int32),
            scores.float().contiguous().view(torch.int32),
        ], dim=1)

    @contextlib.contextmanager
    def _on_device(self):
        """The scope of every device call: the device lock, no autograd,
        the engine's compute dtype pinned for this thread, its graph keys
        joining the held set."""
        with self._device_lock, torch.inference_mode(), thread_precision(self._dtype), \
                graphs.adding_to(self._keys):
            yield

    def _put(self, x: np.ndarray, dtype: Optional[torch.dtype] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
        """A host array on `device` (default: the engine's; in `dtype`):
        on the card staged through pinned memory and copied without
        blocking."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        dtype, device = dtype or t.dtype, device or self._device
        if device.type != "cuda":
            return t.to(dtype)
        staged = torch.empty(t.shape, dtype=dtype, pin_memory=True)
        staged.copy_(t)
        return staged.to(device, non_blocking=True)

    def _fetch(self, blocks: list):
        """(host tensor, CUDA events): the blocks' packed outputs, in row
        order, as one host tensor. On the card each block is copied
        without blocking into its rows of one pinned buffer, behind an
        event recorded on its device after the copy; the completion thread
        waits on them."""
        if blocks[0].device.type != "cuda":
            return torch.cat(blocks), []
        host = torch.empty((sum(b.shape[0] for b in blocks),) + tuple(blocks[0].shape[1:]),
                           dtype=blocks[0].dtype, pin_memory=True)
        events, row = [], 0
        for b in blocks:
            with device_scope(b.device):
                host[row:row + b.shape[0]].copy_(b, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            events.append(done)
            row += b.shape[0]
        return host, events

    def _device_batch(self, app, motion, mask, tags=None, use_tags=None):
        """The numpy batch through `self._fn`, once on the engine's device
        or once per block of rows on the mesh's devices -> _fetch's pair;
        `tags` and `use_tags` only where some row is controlled."""
        if self._mesh is None:
            parts = [(self.params, self._device, slice(None))]
        else:
            parts = [(self._replicas[d], d, sl)
                     for d, sl in zip(self._mesh.devices, shard_rows(app.shape[0], self._mesh))]
        with self._on_device():
            blocks = []
            for params, dev, sl in parts:
                put = lambda x, dtype=None: None if x is None else self._put(x[sl], dtype, dev)
                with device_scope(dev):
                    blocks.append(self._fn(params, put(app, self._dtype), put(motion, self._dtype),
                                           put(mask), put(tags), put(use_tags)))
            return self._fetch(blocks)

    # ------------------------------------------------------------- producers

    def submit(
        self,
        app: np.ndarray,
        motion: np.ndarray,
        nframes: Optional[int] = None,
        pos_tags: Optional[Sequence[str]] = None,
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Enqueue one video -> Future[CaptionResult].

        `app` [T, Da] / `motion` [T, Dm] may have any T: they are fitted to
        the model's num_frames exactly like the offline FeatureStore
        (uniform subsample or zero-pad + frame mask). `pos_tags` is an
        optional Penn tag sequence enforcing the caption's syntax.

        `deadline_ms`: drop the request (Future gets DeadlineExceeded) if
        it is still QUEUED this long after submit — under overload the
        queue head is exactly where requests whose caller already gave up
        pile up, and dispatching them wastes device rows. Cancelling the
        returned Future before dispatch frees its row the same way.
        """
        if self._closed.is_set():
            raise RuntimeError("ServingEngine is closed")
        app = np.asarray(app, np.float32)
        motion = np.asarray(motion, np.float32)
        if app.ndim != 2 or motion.ndim != 2 or app.shape[0] != motion.shape[0]:
            raise ValueError("app [T,Da] and motion [T,Dm] must share T")
        m_cfg = self.cfg.model
        if app.shape[1] != m_cfg.app_dim or motion.shape[1] != m_cfg.motion_dim:
            # reject HERE: a wrong-width row would otherwise fail at
            # dispatch and poison every other request riding its batch
            raise ValueError(
                f"feature dims ({app.shape[1]}, {motion.shape[1]}) != model "
                f"({m_cfg.app_dim}, {m_cfg.motion_dim})"
            )
        t_in = app.shape[0]
        nf = self.cfg.model.num_frames
        valid = min(int(nframes) if nframes is not None else t_in, t_in)
        if valid < 1:
            raise ValueError("nframes must be >= 1")
        app = _fit_frames(app[None], nf)[0]
        motion = _fit_frames(motion[None], nf)[0]
        if t_in > nf:  # subsample keeps validity a prefix (uniform, ordered)
            idx = np.linspace(0, t_in - 1, nf).round().astype(np.int64)
            valid = max(int((idx < valid).sum()), 1)
        else:
            valid = min(valid, nf)
        tags_row = None
        if pos_tags is not None:
            unknown = [t for t in pos_tags if t not in self.pos_vocab]
            if unknown:
                raise ValueError(f"unknown POS tags {unknown}")
            tags_row = np.array(
                pad_encode(self.pos_vocab, list(pos_tags),
                           self.cfg.model.max_pos_len),
                np.int32,
            )
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        fut: Future = Future()
        now = time.monotonic()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None else None
        with self._submit_lock:
            # re-check under the lock: close() takes the same lock to set
            # the flag, so a request can never land after the final drain
            if self._closed.is_set():
                raise RuntimeError("ServingEngine is closed")
            try:
                self._queue.put_nowait(_Request(
                    app, motion, valid, tags_row, fut, now, deadline
                ))
            except Full:
                with self._lock:
                    self._n_rejected += 1
                raise EngineOverloaded(
                    f"request queue full ({self._queue.maxsize} waiting); "
                    "retry with backoff"
                ) from None
        self._progress.set()  # wake a dispatcher parked on carry
        return fut

    def caption(self, app, motion, nframes=None, pos_tags=None,
                timeout: Optional[float] = None) -> CaptionResult:
        """Synchronous convenience wrapper around submit().

        `timeout` doubles as the queue deadline: a caller that would stop
        waiting must not consume a device-batch row after the fact.
        `timeout<=0` is rejected: this wrapper enqueues and then waits, so
        a zero-wait request could never be already done — it would only
        enqueue work and immediately shed it. Use submit() for
        asynchronous polling."""
        if timeout is not None and timeout <= 0:
            raise ValueError(
                "timeout must be positive (a just-enqueued request can "
                "never complete in zero time); use submit() for "
                "asynchronous use"
            )
        deadline_ms = timeout * 1e3 if timeout is not None else None
        fut = self.submit(app, motion, nframes, pos_tags,
                          deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        # concurrent.futures.TimeoutError is a DISTINCT class on py3.10
        # (aliased to the builtin only from 3.11); catch both or a timed-
        # out request stays queued and consumes a device-batch row
        except (TimeoutError, FutureTimeoutError):
            fut.cancel()  # frees the row if still queued; no-op if running
            raise

    # ------------------------------------------------------------ dispatcher

    def _collect(self, first_timeout: float = 0.1) -> list[_Request]:
        """Block up to `first_timeout` for the first request, then
        coalesce arrivals for up to max_wait_ms (or until the largest
        bucket fills)."""
        try:
            first = self._queue.get(timeout=first_timeout)
        except Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        cap = self.buckets[-1]
        while len(batch) < cap:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _claim(self, r: _Request) -> bool:
        """Take ownership of a request at dispatch time, or shed it.

        Returns False (row freed, Future resolved) when the caller already
        cancelled the Future or its queue deadline passed — the HARD
        checks. Predictive shedding and deadline-aware bucket choice live
        in _dispatch_loop (they need the whole batch, not one request).
        set_running_or_notify_cancel() both detects cancellation and locks
        the Future against late cancels once we commit it to the device."""
        if not r.future.set_running_or_notify_cancel():
            with self._lock:
                self._n_cancelled += 1
            return False
        if r.t_deadline is not None and time.monotonic() > r.t_deadline:
            r.future.set_exception(DeadlineExceeded(
                "deadline expired while queued; retry with backoff"))
            with self._lock:
                self._n_expired += 1
            return False
        return True

    def _shed_predicted(self, r: _Request, est: float) -> None:
        """Resolve a request whose deadline is predicted unmeetable even
        by the FASTEST bucket on an EMPTY pipeline — the one class that
        deferring can never save."""
        if not r.future.set_running_or_notify_cancel():
            with self._lock:
                self._n_cancelled += 1
            return
        r.future.set_exception(DeadlineExceeded(
            "deadline predicted unmeetable at dispatch "
            f"(~{est * 1e3:.0f} ms pipeline); retry with backoff"))
        with self._lock:
            self._n_expired += 1
            self._n_shed_predicted += 1

    # a slot measurement older than this is demoted to "cold" (rescaled
    # from the nearest FRESH bucket) in _predict_slot: a bucket the
    # dispatcher stopped riding can never refresh its own estimate, so
    # without a TTL one inflated measurement (host pause, a capture with
    # --no_warmup) would freeze that bucket out forever — the
    # stale-pessimism analog of the death spiral
    _SLOT_TTL_S = 30.0

    def _predict_slot(self, bucket: int) -> float:
        """Per-slot service time for `bucket`: the fresh measured value if
        one exists, else the nearest fresh bucket scaled by size ratio
        (deliberately OPTIMISTIC for smaller buckets — it ignores the
        fixed per-batch overhead — so a cold or stale bucket gets tried
        and re-measured instead of avoided forever), else the stale
        values under the same rule, else 0.0 (= never shed)."""
        # snapshot: the completion thread may INSERT a new bucket key
        # concurrently, and iterating the live dict across bytecodes can
        # raise "dict changed size during iteration" (dict() itself is a
        # single C-level op under the GIL)
        table = dict(self._ewma_slot_s)       # bucket -> (slot_s, t_mono)
        now = time.monotonic()

        def lookup(entries: dict) -> float:
            if bucket in entries:
                return entries[bucket]
            if not entries:
                return 0.0
            b0 = min(entries, key=lambda b: abs(b - bucket))
            return entries[b0] * bucket / b0

        fresh = {b: v for b, (v, t) in table.items()
                 if v and now - t < self._SLOT_TTL_S}
        if fresh:
            return lookup(fresh)
        return lookup({b: v for b, (v, t) in table.items() if v})

    # the adaptive margin never exceeds this: beyond ~2x the prediction
    # the engine is shedding on noise, not on the tail
    _MARGIN_MAX = 2.0

    def _update_margin(self, late: int, with_deadline: int) -> None:
        """Self-tuning shed margin (adaptive_margin=True): feedback on the
        engine's own measured late-completion fraction.

        Control law (AIMD-flavored): a fast EWMA of the per-batch late
        fraction; multiplicative INCREASE while it exceeds 1% (every late
        completion is wasted device work), slow multiplicative decay
        toward the configured `shed_margin` floor once batches complete
        clean (recovers the goodput a too-high margin sheds). Driven only
        by requests that carried deadlines; deadline-free traffic never
        moves it."""
        if not with_deadline:
            return
        frac = late / with_deadline
        self._late_ewma = 0.8 * self._late_ewma + 0.2 * frac
        if late:
            self._t_last_late = time.monotonic()
        if self._late_ewma > 0.01:
            self._margin = min(self._margin * 1.10, self._MARGIN_MAX)
        elif late == 0 and self._late_ewma < 0.002:
            self._margin = max(self._margin * 0.995, self.shed_margin)

    # if the raised margin sheds ALL deadline traffic, no completion ever
    # carries a deadline again and _update_margin starves — the margin
    # would latch at its ceiling forever. The dispatcher therefore also
    # decays on WALL CLOCK: quiet time without a late completion is
    # itself evidence the tail cleared.
    _LATE_CLEAR_S = 2.0

    def _decay_margin_on_quiet(self) -> None:
        if not self.adaptive_margin or self._margin <= self.shed_margin:
            return
        now = time.monotonic()
        if (now - self._t_last_late > self._LATE_CLEAR_S
                and now - self._t_last_decay > 0.1):
            self._margin = max(self._margin * 0.995, self.shed_margin)
            self._t_last_decay = now

    def _dispatch_loop(self) -> None:
        # requests pulled from the queue but deferred to a later batch
        # (servable, just not within the bucket this batch rode). Bounded:
        # once carry holds a full largest bucket we stop pulling new
        # arrivals, so deferral can never grow past ~2x buckets[-1] and
        # never silently extends max_queue's admission bound
        carry: list[_Request] = []
        cap = self.buckets[-1]
        while not (
            self._closed.is_set() and self._queue.empty() and not carry
        ):
            if len(carry) >= cap:
                # nothing was dispatchable last round and carry is full:
                # don't busy-spin — wait for the pipeline to move (a
                # completion is what changes the estimate)
                self._progress.wait(timeout=max(self.max_wait_s, 0.01))
                self._progress.clear()
                batch = carry
            else:
                if carry:
                    # a carried request becomes servable only when the
                    # estimate changes (a completion) or the batch can
                    # grow (an arrival) — both set _progress, so park on
                    # the event instead of polling _collect at ~200 Hz;
                    # the timeout bounds how stale a carried request's
                    # hard-expiry check can get
                    self._progress.wait(timeout=max(self.max_wait_s, 0.01))
                    self._progress.clear()
                    batch = carry + self._collect(first_timeout=0.001)
                else:
                    batch = carry + self._collect(first_timeout=0.1)
            carry = []
            self._n_deferred = 0
            self._decay_margin_on_quiet()
            if not batch:
                continue
            now = time.monotonic()
            depth = self._completion.qsize() + 1
            # drain mode: after close() there is no later batch to defer
            # to — serve everything still queued, late or not
            closing = self._closed.is_set()

            def servable(r: _Request, est: float) -> bool:
                return (
                    r.t_deadline is None or closing
                    or now + est <= r.t_deadline
                )

            # deadline-aware bucket choice: a bigger bucket serves more
            # rows per batch but raises EVERY rider's latency (est =
            # depth x slot[bucket]) — under heavy overload a full
            # largest-bucket batch can outlive a deadline outright, so
            # riding it means serving nobody. Pick the bucket that
            # maximizes requests served WITHIN deadline; ascending scan +
            # strict > = smallest bucket achieving that maximum (lowest
            # latency at equal goodput).
            best_b, best_served, best_est = self.buckets[-1], -1, 0.0
            floor = float("inf")  # best possible FUTURE estimate: the
            # fastest bucket on an empty pipeline (NOT buckets[0]: the
            # measured slot table can be non-monotone in bucket size) —
            # a request that cannot make even that is hopeless and
            # deferring it would only waste queue space
            for bkt in self.buckets:
                slot = self._predict_slot(bkt) * self._margin
                floor = min(floor, slot)
                est = depth * slot
                m = sum(1 for r in batch if servable(r, est))
                if min(m, bkt) > best_served:
                    best_b, best_served, best_est = bkt, min(m, bkt), est
            est_floor = 0.0 if floor == float("inf") else floor

            live: list[_Request] = []

            def triage(r: _Request, cap_count: int) -> None:
                """One shed policy for both intake paths: admit into
                `live` up to cap_count, hard-expire, shed the hopeless,
                defer the rest."""
                if len(live) < cap_count and servable(r, best_est):
                    if self._claim(r):
                        live.append(r)
                elif r.t_deadline is not None and now > r.t_deadline:
                    self._claim(r)  # resolves it as expired
                elif (
                    r.t_deadline is not None
                    and now + est_floor > r.t_deadline
                ):
                    self._shed_predicted(r, est_floor)
                else:
                    carry.append(r)

            for r in batch:
                triage(r, best_served)
            # shed/cancelled rows freed capacity -> backfill from the
            # queue so shedding raises goodput. len(carry) < cap bounds
            # the deferral here too: without it this loop would migrate
            # the ENTIRE queue into carry each round, silently extending
            # max_queue's admission bound
            while live and len(live) < best_b and len(carry) < cap:
                try:
                    r = self._queue.get_nowait()
                except Empty:
                    break
                triage(r, best_b)
            self._n_deferred = len(carry)
            if not live:
                continue
            try:
                self._dispatch_batch(
                    live, time.monotonic(), self._completion.qsize())
            except Exception as e:  # noqa: BLE001 — to the callers
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(e)
        self._completion.put(None)  # finisher shutdown sentinel

    def _dispatch_batch(self, batch: list[_Request], t_claim: float,
                        q_ahead: int) -> None:
        """Assemble + enqueue one device batch; does NOT wait for results
        (the completion thread drains outputs, so the transfer and
        detokenizing of this batch overlap the next one's assembly)."""
        n = len(batch)
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        m = self.cfg.model
        # pad rows replicate request 0 (a guaranteed-valid row: an all-zero
        # frame mask would NaN the attention softmax)
        rows = batch + [batch[0]] * (bucket - n)
        app = np.stack([r.app for r in rows])
        motion = np.stack([r.motion for r in rows])
        mask = (
            np.arange(m.num_frames)[None, :]
            < np.array([r.nframes for r in rows])[:, None]
        ).astype(np.float32)
        tags = use_tags = None
        if any(r.pos_tags is not None for r in rows):
            tags = np.stack([
                r.pos_tags if r.pos_tags is not None
                else np.full((m.max_pos_len,), PAD, np.int32)
                for r in rows
            ]).astype(np.int64)
            use_tags = np.array([r.pos_tags is not None for r in rows])
        out = self._device_batch(app, motion, mask, tags, use_tags)
        # blocks at max_inflight
        self._completion.put((batch, out, bucket, t_claim, q_ahead))

    def _completion_loop(self) -> None:
        max_len = self.cfg.eval.max_decode_len
        nb = max(self._nbest, 1)  # packed row: nb*L tokens | tags | nb scores
        while True:
            item = self._completion.get()
            if item is None:
                return
            batch, (host, events), bucket, t_claim, q_ahead = item
            try:
                for done in events:
                    done.synchronize()  # the batch's transfers have landed
                packed = host.numpy()
                # per-bucket per-slot service time feeds the predictive
                # shed + bucket choice in _dispatch_loop (alpha 0.3:
                # reacts within ~3 batches when load shifts, smooths
                # single-batch jitter)
                t_done = time.monotonic()
                slot = (t_done - t_claim) / (q_ahead + 1)
                prev = self._ewma_slot_s.get(bucket, (0.0, 0.0))[0]
                self._ewma_slot_s[bucket] = (
                    slot if prev == 0.0 else 0.7 * prev + 0.3 * slot,
                    t_done,
                )
                self._progress.set()  # wake a dispatcher parked on carry
                tokens = packed[:, : nb * max_len]
                tags_out = packed[:, nb * max_len:-nb]
                scores = packed[:, -nb:].view(np.float32)
                t_done = time.monotonic()
                n = len(batch)
                n_dl = n_late = 0
                with self._lock:
                    self._n_requests += n
                    self._n_batches += 1
                    self._n_padded_rows += bucket - n
                    for r in batch:
                        self._lat.append(t_done - r.t_submit)
                        if r.t_deadline is not None:
                            n_dl += 1
                            if t_done > r.t_deadline:
                                n_late += 1
                    self._n_deadline_completed += n_dl
                    self._n_late_completed += n_late
                if self.adaptive_margin:
                    self._update_margin(n_late, n_dl)
                for i, r in enumerate(batch):
                    nbest_list = None
                    if self._nbest:
                        rows = tokens[i].reshape(nb, max_len)
                        nbest_list = [
                            (self.vocab.decode_str(rows[n]),
                             float(scores[i, n]))
                            for n in range(nb)
                        ]
                    r.future.set_result(CaptionResult(
                        caption=(nbest_list[0][0] if nbest_list
                                 else self.vocab.decode_str(tokens[i])),
                        pos_sequence=" ".join(
                            self.pos_vocab.decode(tags_out[i])),
                        controlled=r.pos_tags is not None,
                        score=(float(nbest_list[0][1]) if nbest_list
                               else float(scores[i, 0])
                               if self.mode == "beam" else None),
                        latency_ms=(t_done - r.t_submit) * 1e3,
                        batch_size=bucket,
                        nbest=nbest_list,
                    ))
            except Exception as e:  # noqa: BLE001 — to the callers
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    # -------------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        """Run every bucket once, so that the first real requests find
        their graphs captured (and the kernels built)."""
        m = self.cfg.model
        for b in self.buckets:
            app = np.zeros((b, m.num_frames, m.app_dim), np.float32)
            mot = np.zeros((b, m.num_frames, m.motion_dim), np.float32)
            mask = np.ones((b, m.num_frames), np.float32)
            _, events = self._device_batch(app, mot, mask)
            for done in events:
                done.synchronize()

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            n_req, n_bat, n_pad = (
                self._n_requests, self._n_batches, self._n_padded_rows
            )
            n_cancel, n_expired = self._n_cancelled, self._n_expired
            n_pred = self._n_shed_predicted

        def pct(p):
            if not lat:
                return None
            return lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3

        rows = n_req + n_pad
        return {
            "mode": self.mode,
            "ensemble_members": self.n_members,
            "nbest": self._nbest,
            "buckets": list(self.buckets),
            "requests": n_req,
            "batches": n_bat,
            "mean_batch_occupancy": (n_req / rows) if rows else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
            "queue_depth": self._queue.qsize(),
            "rejected": self._n_rejected,
            "cancelled": n_cancel,
            "deadline_expired": n_expired,
            "deadline_shed_predicted": n_pred,
            # completed-with-deadline accounting + the live (possibly
            # adaptive) shed margin the dispatcher is using right now
            "deadline_completed": self._n_deadline_completed,
            "late_completions": self._n_late_completed,
            "shed_margin_live": round(self._margin, 4),
            # the dispatcher's prediction for a LARGEST-bucket rider right
            # now: (in-flight depth + 1) x measured per-slot service time
            "est_claim_to_done_ms": round(
                (self._completion.qsize() + 1)
                * self._predict_slot(self.buckets[-1]) * 1e3, 2),
            "slot_ms_by_bucket": {
                b: round(v * 1e3, 2)
                for b, (v, _t) in sorted(dict(self._ewma_slot_s).items())
            },
            "deferred": self._n_deferred,
            "batches_in_flight": self._completion.qsize(),
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain queues, join both worker threads,
        release the engine's graph keys."""
        with self._submit_lock:  # see submit(): no enqueue after this point
            self._closed.set()
        self._dispatcher.join(timeout)
        self._finisher.join(timeout)
        graphs.release(self._keys)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
