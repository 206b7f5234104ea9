"""The decode loops, and the encoder's BiLSTM, on the device: captured
CUDA graphs of their set-up, their steps in chunks, and their finish.

Counterpart of the reference's execution model for decoding: each JAX
decode is one compiled device loop (`lax.while_loop` / `lax.scan` under
`jax.jit`), memoised per static signature (`lru_cache(maxsize=16)` over
the jitted caption functions). Here a loop is split as the reference's
scan is: its inputs (`prepare`, `bind`), its carry (`init`), `step(carry,
t)` and `finish`. On a CUDA device a key's first call captures, into one
memory pool, a prologue graph (`prepare`, `bind` and `init`), one graph
per chunk of `CHUNK` steps (the step index `t` baked in) and an epilogue
graph (`finish`). Every later call with that key copies its raw inputs
(the tensors of the loop's `raw` attributes: the context, the summary)
into the key's static copies of them and replays prologue, chunks and
epilogue in order: the host makes no other launch for the loop, and one
read per chunk where the eager loop syncs once per step.

The invariant the graphs rest on: everything a captured graph reads is
either a parameter tensor whose `data_ptr`, shape and dtype are part of
the key, a static raw input that the call refreshes (`copy_`) before the
prologue, or a buffer an earlier graph of the key wrote in this call.
The kernels' weight operands are made from the parameters inside the
prologue, so they are made again on the card at every replay: an
optimizer that updates the parameters in place keeps the key and is seen
by the next call. Everything a graph writes is a static buffer of the
pool: the prologue's inputs and carry, a chunk's carry (its graph copies
the carry it ends with back into the static carry), the epilogue's
outputs. The caller receives clones. Nothing in `prepare`, `bind`, `init`
or `finish` reads a device value on the host or copies a tensor in from
another device (a capture cannot hold either), and the host state they
set (a kernel's TMA descriptors, a buffer index) is the same on every
call with a key.

Early exit: every chunk's graph also writes its "nothing left to do" flag
(every beam finished, no row alive). With `early_stop` the flag is copied
to pinned host memory behind an event, and the host reads it before the
next-but-one chunk, so the card never waits on the host. Steps run after
the last row has finished change nothing (a finished beam takes PAD at
zero cost in sorted order, a dead row emits PAD), so every result is the
eager loop's.

The kernel wrappers count their launches in Python, which runs at the
warm-up and at capture and not at replay: a key records each graph's
count at capture, the counters are put back as they were before the
warm-up, and each replay adds its graph's count, so a call counts what
the eager call counts.

Threads: a capture runs in `capture_error_mode="thread_local"`, so that
only the capturing thread's own unsafe calls (a synchronize, a blocking
copy) break it. A serving engine captures a bucket's first batch in its
dispatcher thread while its completion thread waits on the previous
batch's event; under the default "global" mode that wait is an error.
The cache is one per process. A holder (`hold`) keeps the keys its
threads run (`adding_to`) until it releases them, beside MAX_KEYS others:
a serving engine holds its buckets' keys for its life, so that no key of
another caller, and no bucket of its own, evicts one and makes a batch
capture again. One key runs in one thread at a time (its static buffers
are shared); the engine's dispatcher is its keys' one thread.

`resolve_mode` picks the execution: graphs for CUDA tensors, the eager
loop for CPU tensors and where autograd must record (SCST's POS rollout
under gradient; the encoder's BiLSTM then runs its eager scan,
`models/encoder.py::temporal_lstm`); `ops/dispatch.py::set_decode_graphs` and each loop's
`graphs=` override force either. `graphs="chunks"` runs the chunk
runner on eagerly stepped chunks, with an eager set-up and finish, on
any device: the CPU's check of the runner. A capture or replay that
fails raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace
from typing import Callable

import torch

from controllable_xgating_torch.ops.dispatch import (
    decode_graphs_setting,
    fused_enabled,
    nan_checks_enabled,
)
from controllable_xgating_torch.ops.precision import compute_dtype
from controllable_xgating_torch.utils.spans import count, span

CHUNK = 4  # steps per captured graph
MAX_KEYS = 16  # the reference's lru_cache(maxsize=16)


# --- the loops' shape ---


class StepLoop:
    """A decode loop split as the reference's scan. A subclass is made per
    call from that call's arguments and supplies:

      `raw`: the names of the attributes that hold the call's own tensors
          (trees of them: the context, the summary), which the loop reads
          only in `prepare`, `bind`, `init` and `finish`;
      `prepare()` -> this call's inputs (a tree of tensors: dicts, lists,
          tuples, NamedTuples; None and Python scalars as leaves);
      `init()` -> the carry (a dict of new tensors) from `self.inp`;
      `step(carry, t)`: one step, rebinding the carry's entries to new
          tensors and writing its history buffers in place;
      `done(carry)` -> a bool tensor on the device: nothing is left to do;
      `finish(carry)` -> the outputs;
      `key_options()` and `modules()` for the cache key, `device`.
    `bind(inp)` makes the loop step on `inp`."""

    kind = "loop"
    raw: tuple = ()
    device: torch.device
    inp: dict

    def bind(self, inp: dict) -> None:
        self.inp = inp

    def raw_inputs(self) -> dict:
        return {n: getattr(self, n) for n in self.raw}

    def modules(self) -> list:
        return []

    def key_options(self) -> tuple:
        return ()

    def key(self) -> tuple:
        return make_key(self.kind, self.key_options(), self.modules(), self.raw_inputs())

    def needs_grad(self) -> bool:
        """Whether autograd would record this call: grad mode on and some
        parameter or raw input requires grad."""
        if not torch.is_grad_enabled():
            return False
        return any(p.requires_grad for m in self.modules() for p in m.parameters()) or any(
            t.requires_grad for t in tensors_of(self.raw_inputs()))


def chunk_spans(max_len: int, chunk: int = CHUNK) -> list[range]:
    """The steps of each chunk: [0, 4), [4, 8), ..., the last one shorter
    where `chunk` does not divide `max_len`."""
    return [range(s, min(s + chunk, max_len)) for s in range(0, max_len, chunk)]


def drive(n_chunks: int, run_chunk: Callable[[int], None], finished: Callable[[int], bool],
          early_stop: bool) -> int:
    """Run chunks 0 .. n-1 in order. With `early_stop`, chunk i runs only
    if `finished(i - 2)` (the flag chunk i - 2 wrote) is false, so that
    the flag is read one chunk after it was written. Returns the chunks
    run."""
    for i in range(n_chunks):
        if early_stop and i >= 2 and finished(i - 2):
            return i
        run_chunk(i)
    return n_chunks


# --- trees of tensors ---


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_tree(fn, x):
    """A tree of dicts, lists and tuples shaped as `x`, with `fn` of every
    tensor leaf; other leaves are kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: map_tree(fn, v) for k, v in x.items()}
    if _is_namedtuple(x):
        return type(x)(*(map_tree(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(map_tree(fn, v) for v in x)
    return x


def clone_tree(x):
    """A copy of a tree with every tensor leaf cloned; other leaves are kept."""
    return map_tree(torch.Tensor.clone, x)


def tensors_of(x) -> list:
    """The tensor leaves of a tree, in order."""
    out: list = []
    map_tree(out.append, x)
    return out


def copy_tree(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst` (in place); every other leaf must be equal."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"static buffer {tuple(dst.shape)} {dst.dtype} cannot take "
                             f"{src!r:.80}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"static inputs {sorted(dst)} differ from {sorted(src)}")
        for k in dst:
            copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("static inputs differ in length")
        for d, s in zip(dst, src):
            copy_tree(d, s)
    elif dst != src:
        raise ValueError(f"static input {dst!r} differs from {src!r}")


# --- the key ---


def tree_sig(x):
    """A tree's structure with every tensor leaf as its (shape, dtype,
    device), hashable: what a static copy of the tree must match."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, dict):
        return tuple((k, tree_sig(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, *(tree_sig(v) for v in x))
    return x


def param_sig(module) -> tuple:
    """(name, data_ptr, shape, dtype) of every parameter of `module`: a
    captured graph reads parameters at the addresses it saw."""
    return tuple((n, p.data_ptr(), tuple(p.shape), p.dtype) for n, p in module.named_parameters())


def make_key(kind: str, options: tuple, modules, raw) -> tuple:
    """The cache key: the loop's kind and options, the compute policy and
    the kernel setting as they are now, every parameter of `modules`
    (address, shape, dtype) and the signature of the raw inputs `raw`
    (shape, dtype and device of each tensor, None for an absent one, e.g.
    no frame mask)."""
    return (kind, options, compute_dtype(), fused_enabled(),
            tuple(param_sig(m) for m in modules), tree_sig(raw))


# --- launch accounting ---


class LaunchLedger:
    """The kernel wrappers' launch counters (`ops/kernels.WRAPPERS`, or
    any mapping of name -> object with a `launches` attribute)."""

    def __init__(self, counters=None):
        if counters is None:
            from controllable_xgating_torch.ops.kernels import WRAPPERS as counters
        self.counters = counters

    def read(self) -> dict:
        return {n: c.launches for n, c in self.counters.items()}

    def write(self, values: dict) -> None:
        for n, v in values.items():
            self.counters[n].launches = v

    def since(self, before: dict) -> dict:
        """The launches counted since `before`, by wrapper (nonzero only)."""
        now = self.read()
        return {n: now[n] - before[n] for n in now if now[n] != before[n]}

    def add(self, delta: dict) -> None:
        for n, d in delta.items():
            self.counters[n].launches += d


# --- execution ---


def resolve_mode(override, device: torch.device, needs_grad: bool) -> str:
    """"graphs", "eager" or "chunks" for a loop on `device`: the call's
    override, else `set_decode_graphs`'s setting, else auto (graphs for
    CUDA tensors unless autograd must record, the eager loop otherwise).
    Forced graphs need CUDA tensors. With the NaN checks on
    (`utils/debug.py`) nothing is captured: a graph cannot stop at an
    operation."""
    setting = decode_graphs_setting(override)
    if setting == "chunks":
        return "chunks"
    if nan_checks_enabled():
        return "eager"
    if setting is None:
        return "graphs" if device.type == "cuda" and not needs_grad else "eager"
    if not setting:
        return "eager"
    if device.type != "cuda":
        raise ValueError(f"decode graphs need CUDA tensors, got tensors on {device}")
    return "graphs"


class Entry:
    """One key's captured loop: the loop that was captured (its static raw
    inputs in place, its prepared inputs bound), the prologue's graph, one
    graph per chunk and the epilogue's graph, in one pool, each with the
    launches the wrappers counted at its capture; the static carry and
    outputs; the chunks' device flags and their pinned host copies.
    `capture_s` and `pool_bytes` (the device memory the capture reserved)
    describe the capture."""

    def __init__(self, loop: StepLoop, spans: list[range]):
        self.loop, self.spans = loop, spans
        self.carry: dict = {}
        self.outputs = None
        self.prologue = self.epilogue = None  # (graph, launches)
        self.graphs: list = []
        self.deltas: list = []
        self.capture_s = 0.0
        self.pool_bytes = 0
        n, dev = len(spans), loop.device
        self.flags = torch.zeros(n, dtype=torch.bool, device=dev)
        self.host_flags = torch.zeros(n, dtype=torch.bool, pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(n)]

    def setup(self) -> None:
        """Replay the prologue: this call's inputs and carry, from the
        static raw inputs and the parameters."""
        graph, launches = self.prologue
        graph.replay()
        LaunchLedger().add(launches)

    def finish(self):
        """Replay the epilogue; clones of its outputs."""
        graph, launches = self.epilogue
        graph.replay()
        LaunchLedger().add(launches)
        return clone_tree(self.outputs)


_CACHE: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()
_HELD: list = []  # the key sets held (`hold`) until released
_CACHE_LOCK = threading.Lock()  # _CACHE's order and _HELD, across threads
_THREAD = threading.local()  # .keys: the set the calling thread's keys join


def clear() -> None:
    """Drop every key's graphs (and so their memory pools)."""
    with _CACHE_LOCK:
        _CACHE.clear()


def hold(keys: set) -> None:
    """Keep every key in `keys` cached until `release(keys)`: held keys are
    never evicted and do not count against MAX_KEYS. A thread adds the
    keys it runs to `keys` inside `adding_to(keys)`."""
    with _CACHE_LOCK:
        _HELD.append(keys)


def release(keys: set) -> None:
    """Make the keys of `hold(keys)` ordinary LRU keys again."""
    with _CACHE_LOCK:
        _HELD[:] = [k for k in _HELD if k is not keys]
        _evict()


@contextmanager
def adding_to(keys: set):
    """Inside the block, every key the calling thread runs joins `keys`."""
    prev = getattr(_THREAD, "keys", None)
    _THREAD.keys = keys
    try:
        yield
    finally:
        _THREAD.keys = prev


def _evict() -> None:
    """Drop the oldest keys that no holder holds beyond MAX_KEYS of them
    (under _CACHE_LOCK)."""
    held = set().union(*_HELD)
    free = [k for k in _CACHE if k not in held]
    for k in free[:max(0, len(free) - MAX_KEYS)]:
        del _CACHE[k]


def cache_info() -> list[dict]:
    """Per cached key, oldest first: kind, chunks, capture seconds, pool bytes."""
    with _CACHE_LOCK:
        return [{"kind": k[0], "chunks": len(e.spans), "capture_s": e.capture_s,
                 "pool_bytes": e.pool_bytes} for k, e in _CACHE.items()]


def _steps(loop: StepLoop, carry: dict, span) -> dict:
    work = dict(carry)
    for t in span:
        loop.step(work, t)
    return work


# the kernel launches the captures' warm-ups made, by wrapper: real launches
# on the device that the wrappers' counters leave out (a profile of a call
# that captures sees them)
WARMUP_LAUNCHES: collections.Counter = collections.Counter()


def _setup(loop: StepLoop) -> dict:
    """The loop's set-up: its inputs prepared and bound, its carry."""
    loop.bind(loop.prepare())
    return loop.init()


def _own(outputs, carry: dict):
    """`outputs` with every tensor that shares memory with the carry
    cloned: the epilogue's outputs are buffers of its own (a finish that
    returns carry entries as they are would capture an empty graph)."""
    held = {t.untyped_storage().data_ptr() for t in tensors_of(carry)}
    return map_tree(lambda t: t.clone() if t.untyped_storage().data_ptr() in held else t, outputs)


def _capture(loop: StepLoop, spans: list[range]) -> Entry:
    """First sight of a key: static copies of the raw inputs, then a
    warm-up of the set-up, chunk 0 and the finish on a side stream of the
    loop's device (it builds the kernel library, makes cuBLAS's handle and
    workspace, sets each kernel's attributes, makes what the set-up keeps
    across calls: `gate_perm`, a rollout's TMA descriptors), then the
    prologue, every chunk and the epilogue captured on that stream into
    one pool (torch's default capture stream belongs to the device of the
    first capture in the process, so a second card needs its own). The
    prologue's inputs and carry are the buffers the chunks read and
    write. Nothing has run on the captured buffers yet: the caller replays
    them as on any call. The launch counters end as they began, the
    warm-up's launches added to WARMUP_LAUNCHES."""
    dev = loop.device
    entry = Entry(loop, spans)
    ledger = LaunchLedger()
    counts = ledger.read()
    t0 = time.perf_counter()
    try:
        for name, static in clone_tree(loop.raw_inputs()).items():
            setattr(loop, name, static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            work = _steps(loop, _setup(loop), spans[0])
            loop.done(work)
            loop.finish(work)
        torch.cuda.current_stream(dev).wait_stream(side)
        WARMUP_LAUNCHES.update(ledger.since(counts))
        del work
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as each capture's entry does: the pool is what it adds
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            before = ledger.read()
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn()
            return (graph, ledger.since(before)), out

        entry.prologue, entry.carry = capture(lambda: _setup(loop))
        for i, span in enumerate(spans):
            def chunk(i=i, span=span):
                work = _steps(loop, entry.carry, span)
                entry.flags[i].copy_(loop.done(work))
                copy_tree(entry.carry, work)  # the carry this chunk ends with

            (graph, launches), _ = capture(chunk)
            entry.graphs.append(graph)
            entry.deltas.append(launches)
        entry.epilogue, entry.outputs = capture(
            lambda: _own(loop.finish(entry.carry), entry.carry))
        torch.cuda.synchronize(dev)
        entry.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    finally:
        ledger.write(counts)
    entry.capture_s = time.perf_counter() - t0
    return entry


@functools.lru_cache(maxsize=None)
def _names(kind: str) -> SimpleNamespace:
    """The spans and counters of a loop of `kind` (made once: a dormant
    span allocates nothing)."""
    return SimpleNamespace(**{p: f"{kind}.{p}" for p in ("setup", "capture", "replay", "wait",
                                                          "finish")},
                           **{c: f"graphs.{c}.{kind}" for c in ("captures", "setups", "replays",
                                                                 "chunks_of")})


def _on_card(device: torch.device):
    """A key's graphs, events and streams are its card's: capture and
    replay with that card current, whichever the caller left current."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _replay(entry: Entry, early_stop: bool) -> int:
    ledger = LaunchLedger()
    names = _names(entry.loop.kind)

    def run_chunk(i: int) -> None:
        with span(names.replay):
            entry.graphs[i].replay()
            ledger.add(entry.deltas[i])
            if early_stop:
                entry.host_flags[i].copy_(entry.flags[i], non_blocking=True)
                entry.events[i].record()

    def finished(i: int) -> bool:
        with span(names.wait):
            entry.events[i].synchronize()
        return bool(entry.host_flags[i])

    return drive(len(entry.spans), run_chunk, finished, early_stop)


def run(loop: StepLoop, max_len: int, early_stop: bool, graphs=None):
    """Run `loop` for `max_len` steps (fewer with `early_stop` once
    nothing is left to do) and return `loop.finish`'s outputs, as
    `resolve_mode` decides: the eager loop (one host read a step under
    `early_stop`), eagerly stepped chunks, or the key's captured graphs.

    Spans (`utils/spans.py`), named by the loop's kind: `<kind>.setup`
    from entry to the first step or chunk launched (with `<kind>.capture`
    inside it at a key's first sight; on the graphs' path it ends with the
    prologue's replay), `<kind>.replay` around each chunk (each step of
    the eager loop), `<kind>.wait` around each host read of the early-exit
    flag, `<kind>.finish`. Counters: `graphs.captures.<kind>` (calls that
    captured), `graphs.setups.<kind>` (calls whose set-up was a replayed
    prologue: every other call of the graphs' path),
    `graphs.replays.<kind>` and `graphs.chunks_of.<kind>` (the chunks
    replayed, of those a call has) for the chunk runner and the graphs."""
    mode = resolve_mode(graphs, loop.device, loop.needs_grad())
    names = _names(loop.kind)
    if mode == "eager":
        with span(names.setup):
            carry = _setup(loop)
        for t in range(max_len):
            if early_stop:
                with span(names.wait):
                    stop = bool(loop.done(carry))
                if stop:
                    break
            with span(names.replay):
                loop.step(carry, t)
        with span(names.finish):
            return loop.finish(carry)
    spans = chunk_spans(max_len)
    with torch.inference_mode(False), torch.no_grad():
        if mode == "chunks":
            with span(names.setup):
                state = {"carry": _setup(loop)}
            flags: list = []

            def run_chunk(i: int) -> None:
                with span(names.replay):
                    state["carry"] = _steps(loop, state["carry"], spans[i])
                with span(names.wait):
                    flags.append(bool(loop.done(state["carry"])))

            n = drive(len(spans), run_chunk, flags.__getitem__, early_stop)
            count(names.replays, n)
            count(names.chunks_of, len(spans))
            with span(names.finish):
                return loop.finish(state["carry"])
        with span(names.setup):
            key = loop.key() + (max_len,)
            held = getattr(_THREAD, "keys", None)
            with _CACHE_LOCK:
                entry = _CACHE.get(key)
                if entry is not None:
                    _CACHE.move_to_end(key)
            captured = entry is None
            with _on_card(loop.device):
                if captured:
                    count(names.captures)
                    with span(names.capture):
                        entry = _capture(loop, spans)
                else:
                    count(names.setups)
                    copy_tree(entry.loop.raw_inputs(), loop.raw_inputs())
                with _CACHE_LOCK:
                    if held is not None:
                        held.add(key)
                    if captured:
                        _CACHE[key] = entry
                        _evict()
                entry.setup()
        with _on_card(loop.device):
            n = _replay(entry, early_stop)
        count(names.replays, n)
        count(names.chunks_of, len(spans))
        with span(names.finish), _on_card(loop.device):
            return entry.finish()
