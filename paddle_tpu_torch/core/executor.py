"""Execution of a block on torch tensors: op by op, or as a compiled
step.

The port of ``run_op``/``run_block`` (``paddle_tpu/core/executor.py``
:101, :141) and of the ``Executor`` class's two paths: the interpreting
path (``_run_interpreted`` :528), op by op, and the compiled one
(``_run_compiled`` / ``_compile`` :1031, one jitted step with the state
donated), which ``Executor.run`` takes by default as the reference does.
The compiled step here is a CUDA graph (``core/graph.py``): the first run
of a (program, scope, feed shapes and dtypes, fetch names) key runs op by
op, which does the lazy work (kernel builds, library handles,
workspaces); the second captures the step and replays it; every later run
only replays it. The decode engine runs each program's block through
``run_block`` with its params, pools and feeds in one env dict.

Forward lowerings run under ``torch.no_grad()``, so no autograd graph
outlives an op; ``__vjp_grad__`` re-enables grad inside its lowering.

The reference leaves the liveness of a step's temporaries to its
compiler. An eager env that kept every var of a training step alive
would hold all activations, all their gradients and every recompute
temporary at once, so ``Executor.run`` computes each var's last reader
once per program and drops a non-persistable, non-fetched var from the
env right after it, in either path: inside a capture the freed blocks
return to the graph's pool and later ops of the step reuse them.

Telemetry, with the reference's names: the spans ``executor.run`` (or
``executor.run_steps``), ``executor.feed``, ``executor.dispatch`` and
``executor.fetch`` of a sampled run; the counters ``runs_compiled`` /
``runs_interpreted``, ``cache_hits`` / ``cache_misses`` (a key's first
run), ``feed_host_bytes`` / ``fetch_host_bytes``, ``fused_dispatches``
/ ``fused_steps``; the port's compile is a step's capture:
``executor.compiles``, ``compile_ms`` and a ``compile`` record whose
cause names the components of the step's key that changed
(``_KEY_COMPONENTS``); the timers ``interpret_ms`` (op by op),
``run_ms`` / ``run_steps_ms`` (replays) and their split into
``device_ms`` (CUDA events around the replay, read once they have
completed: the host never waits for them) and ``host_dispatch_ms``.
A capture books a cost record (``core/costmodel.py``) when cost capture
is on, every replay its flops; an allocation failure raises
``costmodel.OutOfMemoryError`` after its forensics record; every run
ticks the SLO watchdog and the goodput ledger. ``FLAGS_verify_program``
runs the static verifier once a (program, op count) before its run. Op
ranges for the profiler (``profiler.RecordEvent``) open only while it
records.
"""

from __future__ import annotations

import contextlib
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import costmodel, goodput, incidents, registry, rng, telemetry, trace
from .. import profiler as _prof
from .compiler import program_of
from .flags import flag as _flag
from .graph import StepGraph
from .ir import Block, OpDesc, Program, Variable, default_main_program
from .registry import EMPTY_VAR
from .scope import STEP_COUNTER, Scope, global_scope
from .selected_rows import SelectedRows
from .types import to_torch_dtype, x64_off

_MISSING = object()
_SEEN = object()   # a compiled-step key whose first run ran op by op


class ExecutionError(RuntimeError):
    pass


def _resolve_inputs(op: OpDesc, env: Dict[str, Any]) -> Dict[str, List[Any]]:
    ins: Dict[str, List[Any]] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
                continue
            v = env.get(n, _MISSING)
            if v is _MISSING:
                raise ExecutionError(
                    f"op '{op.type}' reads undefined variable '{n}' "
                    f"(slot {slot}). Defined so far: {len(env)} vars.")
            vals.append(v)
        ins[slot] = vals
    return ins


def run_op(op: OpDesc, env: Dict[str, Any], step=None,
           seed: Optional[torch.Tensor] = None,
           seeds: Optional[Dict[Any, torch.Tensor]] = None,
           autograd: bool = False) -> Dict[str, Any]:
    """Run one op's lowering against env and bind its outputs there.
    ``step`` (the global step counter) is handed to the lowering as the
    ``__step__`` attr: random ops fold it into their seed. ``seed``, a
    random op's slots of a compiled step's seed and key tables (a pair of
    0-d tensors), goes in as the ``__seed__`` and ``__key__`` attrs,
    which ``rng.op_seed`` and ``rng.op_key`` take instead; ``seeds``,
    the slots of the random ops of the sub-blocks an op runs
    (``rng.seed_slots``), as ``__seeds__``. The lowering runs under
    ``torch.no_grad()``, or with ``autograd`` under the caller's grad
    mode (a sub-block's ops inside a ``__vjp_grad__`` recompute)."""
    opdef = registry.get(op.type)
    if opdef.forward is None:
        raise ExecutionError(f"op '{op.type}' has no registered lowering")
    ins = _resolve_inputs(op, env)
    attrs = dict(op.attrs)
    if step is not None:
        attrs["__step__"] = step
    if seed is not None:
        attrs["__seed__"], attrs["__key__"] = seed
    if seeds is not None:
        attrs["__seeds__"] = seeds
    try:
        with contextlib.nullcontext() if autograd else torch.no_grad(), \
                _prof.RecordEvent(op.type) if _prof.active() \
                else contextlib.nullcontext():
            outs = registry.normalize_outputs(opdef.forward(ins, attrs))
    except (ExecutionError, NotImplementedError,
            torch.cuda.OutOfMemoryError):
        raise      # callers tell these apart; the rest gets the build site
    except Exception as e:
        site = "".join(op.callstack[-2:]) if op.callstack else ""
        raise ExecutionError(
            f"error running op '{op.type}': {e}\n--- op built at ---\n"
            f"{site}") from e
    for slot, names in op.outputs.items():
        for n, v in zip(names, outs.get(slot) or ()):
            if n != EMPTY_VAR and v is not None:
                env[n] = v
    return env


def run_block(block: Block, env: Dict[str, Any], step=None
              ) -> Dict[str, Any]:
    for op in block.ops:
        run_op(op, env, step=step)
    return env


def run_sub_block(block: Block, env: Dict[str, Any], step=None,
                  seeds: Optional[Dict[Any, torch.Tensor]] = None,
                  keep: Sequence[str] = ()) -> Dict[str, Any]:
    """Run a sub-block's ops on ``env``, the call's own local env, under
    the caller's grad mode: a ``block_call`` recomputed by its
    ``__vjp_grad__`` builds its autograd graph here. ``seeds`` maps the
    block's random ops to their slots of a compiled step's seed table
    (op by op it is None, and each op folds ``step`` into its seed). A
    var that no later op of the block reads leaves the env after its last
    reader, unless it is in ``keep``."""
    for op, drop in zip(block.ops, _last_readers(block, set(keep))):
        run_op(op, env, step=step,
               seed=seeds.get(op) if seeds else None,
               seeds=seeds if seeds and rng.sub_blocks(op) else None,
               autograd=True)
        for n in drop:
            env.pop(n, None)
    return env


def _analyze_block(block: Block):
    """(external reads, writes) of a block in a stable order (reference:
    ``paddle_tpu/core/executor.py:148``): the names its ops read before
    any op of it writes them, and every name written."""
    produced: set = set()
    ext_reads: list = []
    writes: list = []
    seen_r: set = set()
    seen_w: set = set()
    for op in block.ops:
        for n in op.input_names():
            if n != EMPTY_VAR and n not in produced and n not in seen_r:
                ext_reads.append(n)
                seen_r.add(n)
        for n in op.output_names():
            if n == EMPTY_VAR:
                continue
            produced.add(n)
            if n not in seen_w:
                writes.append(n)
                seen_w.add(n)
    return ext_reads, writes


def _last_readers(block: Block, keep: set) -> List[List[str]]:
    """For each op of the block, the vars that no later op reads and
    that are not in ``keep``: read or written there for the last time,
    they can leave the env once the op has run."""
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_names() + op.output_names():
            if n != EMPTY_VAR:
                last[n] = i
    dead: List[List[str]] = [[] for _ in block.ops]
    for n, i in last.items():
        if n not in keep:
            dead[i].append(n)
    return dead


# the truncation guards of the running compiled step: (flag, message)
# pairs collected instead of read (``truncation_guard``)
_GUARDS: List[List[tuple]] = []


def truncation_guard(flag: torch.Tensor, message: str):
    """A bounded loop's check that it ran to its end: ``flag`` (a 0-d bool
    tensor) true means the result is wrong for this input. Op by op it is
    read and raises RuntimeError(message), as the reference raises on
    concrete values. In a compiled step it is not read: the step keeps
    the flag, and the executor reads it with the fetches and warns with
    ``message`` (``_CompiledStep.check_guards``)."""
    if _GUARDS:
        _GUARDS[-1].append((flag, message))
    elif flag.device.type != "meta" and bool(flag):
        raise RuntimeError(message)


def copy_guards(flags: torch.Tensor) -> tuple:
    """Start a copy of a step's stacked truncation flags to the host
    without a wait: (host tensor, the event the copy completes at, or None
    on the CPU)."""
    if flags.device.type != "cuda":
        return flags.clone(), None
    host = torch.empty(flags.shape, dtype=torch.bool, pin_memory=True)
    host.copy_(flags, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def warn_guards(pending: List[tuple], messages: List[str]):
    """Warn with the message of each flag set in the copies of
    ``pending`` (``copy_guards``) that have completed, oldest first; the
    rest stay for a later call."""
    while pending:
        host, done = pending[0]
        if done is not None and not done.query():
            return
        pending.pop(0)
        for hit, message in zip(host.tolist(), messages):
            if hit:
                warnings.warn(message, stacklevel=4)


def host_decider(ops) -> Optional[str]:
    """The type of the first op of ``ops`` (or of the sub-blocks and
    programs they run, or the forward a ``__vjp_grad__`` recomputes) that
    decides on the host (its registry entry's ``decides_on_host``:
    ``conditional_block``, ``cond``, ``while``, ``print``, a
    ``while_loop`` without ``grad_max_iters``); None if there is none. A
    compiled step that holds one runs uncaptured."""
    for op in ops:
        attrs = rng._run_attrs(op)
        kind = op.attrs.get("fwd_type") if op.type == "__vjp_grad__" \
            else op.type
        decides = registry.get(kind).decides_on_host
        if decides(attrs) if callable(decides) else decides:
            return kind
        inner = [blk.ops for blk in rng.sub_blocks(op)]
        if kind == "run_program" and attrs.get("program") is not None:
            inner.append(attrs["program"].global_block().ops)
        for sub in inner:
            found = host_decider(sub)
            if found:
                return found
    return None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor on the host; bf16 as ml_dtypes.bfloat16 bits, or
    as float32 without ml_dtypes (numpy has no bfloat16 of its own).
    Always a copy: a CPU tensor's ``numpy()`` is a view, and a fetched
    persistable is the scope's tensor, which later steps update in place
    (optimizer ops, a compiled step's write-back)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _fetched(v, return_numpy: bool):
    """A fetch as the caller gets it: a numpy array (``_to_numpy``) or a
    tensor copy. A SelectedRows comes back as a SelectedRows of such
    copies (rows and values). The reference's op-by-op path gives a 0-d
    object array holding the SelectedRows, and its compiled path raises
    (a SelectedRows is no JAX type)."""
    if isinstance(v, SelectedRows):
        return SelectedRows(_fetched(v.rows, return_numpy),
                            _fetched(v.values, return_numpy), v.height)
    return _to_numpy(v) if return_numpy else v.clone()


def _stack(values: List[Any]):
    """Per-step fetches (tensors, or SelectedRows of tensors) stacked
    along a new leading axis of k."""
    if isinstance(values[0], SelectedRows):
        return SelectedRows(torch.stack([v.rows for v in values]),
                            torch.stack([v.values for v in values]),
                            values[0].height)
    return torch.stack(values)


# host-IO op types (the reference's ``_PS_IO_TYPES``): a program holding
# one cannot fuse k steps; the reference runs k sequential steps there
_PS_IO_TYPES = frozenset(
    ("send", "recv", "send_barrier", "fetch_barrier", "listen_and_serv",
     "save", "load", "save_combine", "load_combine", "checkpoint_notify",
     "py_func"))


def _host_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _feed_spec(block: Block, name: str, value):
    """(the feed as a host tensor, the dtype it is cast to: its declared
    one, 64-bit types to 32 as the reference does)."""
    t = _host_tensor(value)
    dtype = block.var(name).dtype if block.has_var(name) else None
    return t, x64_off(to_torch_dtype(dtype) if dtype is not None
                      else t.dtype)


def _step_key(plan_key, feeds) -> tuple:
    """The key of a compiled step: the plan's (op count, fetch names) and
    each feed's (name, shape, dtype) as a step receives it."""
    return plan_key, tuple(sorted((n, tuple(shape), dt)
                                  for n, shape, dt in feeds))


# the components of a compiled step's identity, in order: the program,
# its op count (the port's program version), the scope, and the parts of
# ``_step_key``; the recompile cause names the ones that changed
_KEY_COMPONENTS = ("program", "program_version", "scope", "feed_names",
                   "fetch_names", "feed_shapes", "feed_dtypes")

_UIDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _uid(obj) -> int:
    """A small per-process id of a program or scope (the reference's
    ``uid``), stable while the object lives."""
    uid = _UIDS.get(obj)
    if uid is None:
        uid = _UIDS[obj] = len(_UIDS) + 1
    return uid


def _cause_key(program, scope, key) -> tuple:
    (n_ops, fetch_names), feeds = key
    return (_uid(program), n_ops, _uid(scope),
            tuple(n for n, _, _ in feeds), fetch_names,
            tuple(shape for _, shape, _ in feeds),
            tuple(str(dt) for _, _, dt in feeds))


def _recompile_cause(key: tuple, cached_keys) -> str:
    """Why a capture happened: the components in which the new key
    differs from the nearest key captured before (most components
    equal), or ``first_compile``."""
    if not cached_keys:
        return "first_compile"
    best, best_n = None, -1
    for k in cached_keys:
        n = sum(1 for a, b in zip(k, key) if a == b)
        if n > best_n:
            best, best_n = k, n
    changed = [comp for comp, a, b in zip(_KEY_COMPONENTS, best, key)
               if a != b]
    return ",".join(changed) if changed else "unknown"


def _values(env, names) -> List[Any]:
    return [env[n] for n in names if n != EMPTY_VAR and n in env]


def meta_count(ops, dead, env: Dict[str, Any], seed_of=None,
               runs_sub=()) -> tuple:
    """(flops, bytes, GEMM dtype) of one step of ``ops`` over ``env``,
    run on meta tensors of the same shapes (``costmodel.count_ops``):
    every tensor of ``env`` and of ``seed_of`` (a compiled step's seed
    and key slots) becomes a meta tensor, every op runs through
    ``run_op``, and each op's input and output bytes are summed."""
    def meta(v):
        return torch.empty_like(v, device="meta") \
            if isinstance(v, torch.Tensor) else v

    start = {n: meta(v) for n, v in env.items()}
    seeds = {k: (meta(a), meta(b)) for k, (a, b) in (seed_of or {}).items()}

    def run(each):
        menv = dict(start)
        with registry.creating_on("meta"):
            for i, (op, drop) in enumerate(zip(ops, dead)):
                each(_values(menv, op.input_names()))
                run_op(op, menv, seed=seeds.get(i),
                       seeds=seeds if i in runs_sub else None)
                each(_values(menv, op.output_names()))
                for n in drop:
                    menv.pop(n, None)

    return costmodel.count_ops(run)


# runs whose device time is still on the card: (start event, end event,
# the run's wall ms), read once they have completed
_pending_device: List[tuple] = []


def _observe_split(device_ms: float, run_ms: float):
    telemetry.observe("executor.device_ms", device_ms, kind="timer")
    telemetry.observe("executor.host_dispatch_ms",
                      max(0.0, run_ms - device_ms), kind="timer")


def _settle_device(wait: bool = True):
    """Observe ``executor.device_ms`` and ``host_dispatch_ms`` of the
    runs whose end events have completed (all of them with ``wait``,
    which synchronises on each: never on the hot path)."""
    while _pending_device:
        start, end, run_ms = _pending_device[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _pending_device.pop(0)
        _observe_split(start.elapsed_time(end), run_ms)


telemetry.add_settler(_settle_device)


class _DeviceClock:
    """The device time of the work inside the block: CUDA events around
    it on the card (``value``: the pair, read later by
    ``_settle_device``), the host's wall around it elsewhere (``value``:
    ms; the CPU runs it synchronously)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.value = None

    def __enter__(self):
        if self.cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._events[1].record()
            self.value = self._events
        else:
            self.value = (time.perf_counter() - self._t0) * 1e3
        return False


class _CompiledStep:
    """One key's compiled step: static feed buffers, the state tensors
    the scope held when it was built, a seed table, and the step captured
    (on a CUDA device) as a graph over them.

    The seed table has one int64 slot per random op, those of the
    sub-blocks the step's ops run included (``rng.seed_slots``), and a
    key table beside it; before each step the host writes
    ``rng.seed_values`` and ``rng.key_values`` at that step into them
    (through a pinned buffer, one copy), and each random op reads its
    slots as its ``__seed__`` and ``__key__`` (an op that runs a
    sub-block gets the slots of the sub-block's ops as ``__seeds__``).
    ``run_many`` runs k steps from stacked device feeds with the tables
    of all k steps copied once. Optimizer ops update
    their state in place; a persistable that a lowering writes out of
    place (batch norm's running statistics) is copied back into the
    tensor the scope holds at the end of the step, so the scope keeps the
    tensors the graph reads.

    A step holding an op that decides on the host (``host_decider``:
    ``conditional_block``, ``cond``, ``while``, ``print``, an unbounded
    ``while_loop``) is not captured: the same step, with its static
    buffers, seed table and write-back, runs uncaptured on the device on
    every run, counted by ``executor.uncaptured_steps``, and its
    ``compile`` record names the op (``uncaptured``). The truncation flags
    of its bounded loops (``truncation_guard``) are copied to the host
    after each run without a wait and read once that copy has completed
    (``check_guards``), at the latest with the next run's fetches."""

    def __init__(self, device, ops, dead, scope, feeds, fetch_names,
                 persist):
        for op in ops:
            if not registry.get(op.type).capturable:
                raise ExecutionError(
                    f"op '{op.type}' cannot be replayed in a compiled "
                    f"step (it draws through a host-seeded generator); "
                    f"run this program with use_compiled=False")
        unseeded = rng.unseeded_random_ops(ops)
        if unseeded:
            raise ExecutionError(
                f"op '{ops[unseeded[0]].type}' draws random bits but "
                f"carries no seed attr, so a compiled step would replay "
                f"one mask every step; give it a seed or run this "
                f"program with use_compiled=False")
        self.device = device
        self.ops, self.dead, self.fetch_names = ops, dead, fetch_names
        outs = {n for op in ops for n in op.output_names()}
        used = outs.union(*(op.input_names() for op in ops))
        self.state = {n: v for n, v in scope.items()
                      if n in used and isinstance(v, torch.Tensor)}
        self.written = sorted(n for n in persist
                              if n in self.state and n in outs)
        self.feeds = {n: torch.empty(t.shape, dtype=dt, device=device)
                      for n, (t, dt) in feeds.items()}
        slots = rng.seed_slots(ops)
        self.seed_attrs = [s for _, s in slots]
        self.cost: Optional[costmodel.ProgramCost] = None
        # allocator statistics around the graph capture (cost level full)
        self.measure_memory = False
        self.capture_memory: Optional[Dict[str, int]] = None
        # row 0 the seed table, row 1 the key table
        self.tables = torch.zeros(2, len(slots), dtype=torch.int64,
                                  device=device)
        self.seeds = self.tables[0]
        # slot key (an op's index, or a sub-block's OpDesc) -> its slots
        self.seed_of = {key: (self.tables[0, k], self.tables[1, k])
                        for k, (key, _) in enumerate(slots)}
        # the ops that run sub-blocks get the sub-blocks' slots
        self.runs_sub = {i for i, op in enumerate(ops) if rng.sub_blocks(op)}
        cuda = device.type == "cuda"
        self.seed_host = torch.zeros(2, len(slots), dtype=torch.int64,
                                     pin_memory=cuda) if cuda else None
        self.copied: Optional[torch.cuda.Event] = None
        self.host_op = host_decider(ops)
        # the bounded loops' truncation flags of the last step, stacked,
        # with their messages; and the host copies still to be read
        self.guard_flags: Optional[torch.Tensor] = None
        self.guard_messages: List[str] = []
        self.pending_guards: List[tuple] = []
        self.graph = StepGraph(self._step, device)

    def _step(self) -> List[torch.Tensor]:
        env: Dict[str, Any] = dict(self.state)
        env.update(self.feeds)
        guards: List[tuple] = []
        _GUARDS.append(guards)
        try:
            with registry.creating_on(self.device):
                for i, (op, drop) in enumerate(zip(self.ops, self.dead)):
                    run_op(op, env, seed=self.seed_of.get(i),
                           seeds=self.seed_of if i in self.runs_sub
                           else None)
                    for n in drop:
                        env.pop(n, None)
                if guards:
                    self.guard_flags = torch.stack(
                        [f.reshape(()).bool() for f, _ in guards])
                    self.guard_messages = [m for _, m in guards]
        finally:
            _GUARDS.pop()
        for n in self.written:
            if env.get(n) is not self.state[n]:
                self.state[n].copy_(env[n])
        for n in self.fetch_names:
            if n not in env:
                raise ExecutionError(f"fetch target '{n}' was not produced")
        return [env[n] for n in self.fetch_names]

    def holds(self, scope: Scope) -> bool:
        """Whether the scope still holds every tensor the step reads."""
        now = dict(scope.items())
        return all(now.get(n) is t for n, t in self.state.items())

    def _table_values(self, step: int) -> List[List[int]]:
        return [rng.seed_values(self.seed_attrs, step),
                rng.key_values(self.seed_attrs, step)]

    def _fill_seeds(self, step: int):
        if not self.seed_attrs:
            return
        values = self._table_values(step)
        if self.seed_host is None:
            self.tables.copy_(torch.tensor(values, dtype=torch.int64))
            return
        if self.copied is not None:   # the last step's copy has read it
            self.copied.synchronize()
        self.seed_host.numpy()[:] = values
        self.tables.copy_(self.seed_host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()

    def _replay(self) -> List[Any]:
        if self.graph.graph is None and self.device.type == "cuda" \
                and self.host_op is None:
            with _prof.RecordEvent("executor::compile"):
                if self.measure_memory:
                    _, self.capture_memory = costmodel.memory_around(
                        self.graph.capture, self.device)
                else:
                    self.graph.capture()
        outs = self.graph.replay()
        if self.host_op is not None:
            telemetry.counter_add("executor.uncaptured_steps", 1,
                                  op=self.host_op)
        if self.guard_flags is not None:
            self.pending_guards.append(copy_guards(self.guard_flags))
        return outs

    def check_guards(self):
        """Warn with the message of each truncation flag set in a run whose
        host copy has completed (never waits for the card)."""
        warn_guards(self.pending_guards, self.guard_messages)

    def meta_cost(self) -> tuple:
        """(flops, bytes, GEMM dtype) of one step, from a run of its
        lowerings on meta tensors (``meta_count``)."""
        env: Dict[str, Any] = dict(self.state)
        env.update(self.feeds)
        return meta_count(self.ops, self.dead, env, self.seed_of,
                          self.runs_sub)

    def run(self, feeds: Dict[str, torch.Tensor], step: int
            ) -> List[Any]:
        for n, buf in self.feeds.items():
            buf.copy_(feeds[n])
        self._fill_seeds(step)
        return self._replay()

    def run_many(self, stacked: Dict[str, torch.Tensor], step: int,
                 k: int) -> List[List[Any]]:
        """k steps from ``step`` on: feeds sliced from the stacked device
        tensors and the tables of all k steps (one host-to-device copy
        before the first) copied in on the device before each replay,
        with nothing read back in between. Each step's fetches are
        copied out of the static outputs on the device."""
        tables = torch.tensor([self._table_values(step + i)
                               for i in range(k)], dtype=torch.int64
                              ).to(self.device) if self.seed_attrs else None
        outs = []
        for i in range(k):
            for n, buf in self.feeds.items():
                buf.copy_(stacked[n][i])
            if tables is not None:
                self.tables.copy_(tables[i])
            outs.append([_fetched(v, False) for v in self._replay()])
        return outs


def program_cost(program: Program, feed: Dict[str, Any],
                 fetch_list: Sequence[Union[str, Variable]],
                 scope: Scope) -> tuple:
    """(flops, bytes, GEMM dtype) of one compiled step of ``program`` over
    ``feed`` and ``scope``'s state, with nothing run on a device: the
    count the executor's cost capture of that step records
    (``_CompiledStep.meta_cost``)."""
    block = program.global_block()
    fetch_names = [f.name if isinstance(f, Variable) else str(f)
                   for f in fetch_list]
    persist = {v.name for v in block.vars.values() if v.persistable}
    dead = _last_readers(block, persist | set(fetch_names))
    feeds = {n: _feed_spec(block, n, v) for n, v in feed.items()}
    return _CompiledStep(torch.device("meta"), list(block.ops), dead, scope,
                         feeds, fetch_names, persist).meta_cost()


class Executor:
    """User-facing run loop (reference: ``Executor``,
    ``paddle_tpu/core/executor.py:276``): ``run(program, feed,
    fetch_list)`` executes block 0 on ``device``, as a compiled step
    (the default) or op by op.

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` to run on the CPU, as the tests do."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Executor runs on the GPU by default and no CUDA device "
                    "is available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        # program -> {(op count, fetch names): vars to drop after each op}
        self._dead = weakref.WeakKeyDictionary()
        # program -> scope -> {key: _SEEN or its _CompiledStep}
        self._compiled = weakref.WeakKeyDictionary()
        # compiled steps built (on a CUDA device: graphs captured)
        self.compiled_builds = 0
        # the cause keys of the steps built, for the recompile cause
        self._cause_keys: List[tuple] = []
        # program -> op count verified (FLAGS_verify_program)
        self._verified = weakref.WeakKeyDictionary()

    def close(self):
        self._dead.clear()
        self._compiled.clear()

    def _maybe_verify(self, program, feed, fetch_names, scope):
        """FLAGS_verify_program: run the static verifier
        (``core/verify.py``) once per (program, version: its op count)
        before the program's first run, so a corrupt program raises a
        typed, located ProgramVerifyError."""
        if not _flag("verify_program"):
            return
        n_ops = sum(len(b.ops) for b in program.blocks)
        if self._verified.get(program) == n_ops:
            return
        from .verify import verify_program

        verify_program(program, feed_names=set(feed or ()),
                       fetch_names=fetch_names, scope=scope,
                       context="executor pre-run gate")
        self._verified[program] = n_ops

    def _build_step(self, program, scope, key, block, dead, feeds,
                    fetch_names, persist) -> "_CompiledStep":
        """A new compiled step for ``key``: counted as a compile, with the
        cause of the recompile, and (cost capture on) its allocator
        statistics taken around the graph capture."""
        compiled = _CompiledStep(self.device, list(block.ops), dead, scope,
                                 feeds, fetch_names, persist)
        compiled.measure_memory = self.device.type == "cuda" and \
            costmodel.capture_mode() == "full"
        compiled.cause_key = _cause_key(program, scope, key)
        compiled.cause = _recompile_cause(compiled.cause_key,
                                          self._cause_keys)
        self._cause_keys.append(compiled.cause_key)
        self.compiled_builds += 1
        return compiled

    def _after_compile(self, program, block, compiled, key, outs,
                       compile_ms: float):
        """Account a compiled step's first run (its capture): the compile
        counters and event, and, with cost capture on, its cost record
        and the persistable split of its state."""
        if costmodel.capture_mode() != "off":
            mem = compiled.capture_memory
            if mem is not None:
                mem = dict(mem, out_bytes=sum(costmodel._nbytes(o)
                                              for o in outs))
            label = f"p{_uid(program)}v{len(block.ops)}"
            compiled.cost = costmodel.capture(
                compiled.meta_cost, key_id=costmodel.key_id_for(
                    compiled.cause_key), kind="executor", program=label,
                device=self.device, memory=mem)
            names = list(compiled.state)
            pb, ob = costmodel.split_persistable_bytes(
                block, names, [compiled.state[n] for n in names])
            costmodel.record_model_bytes(pb, ob)
        costmodel.book_dispatch(compiled.cost)
        (n_ops, fetch_names), feeds = key
        n_steps = sum(isinstance(c, _CompiledStep)
                      for steps in self._compiled.values()
                      for by_key in steps.values() for c in by_key.values())
        telemetry.counter_add("executor.compiles", 1)
        telemetry.counter_add("executor.compile_ms", round(compile_ms, 3))
        telemetry.gauge_set("executor.cache_size", n_steps)
        record = {"cause": compiled.cause, "cache_size": n_steps,
                  "program": _uid(program), "program_version": n_ops,
                  "feed_names": [n for n, _, _ in feeds],
                  "fetch_names": list(fetch_names),
                  "feed_shapes": [list(sh) for _, sh, _ in feeds],
                  "steps_per_dispatch": 1}
        if compiled.host_op is not None:
            record["uncaptured"] = compiled.host_op
        telemetry.event("compile", "executor", round(compile_ms, 3), record)

    def run_steps(self, program: Optional[Program] = None,
                  feed: Optional[Dict[str, Any]] = None,
                  fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
                  k: Optional[int] = None, scope: Optional[Scope] = None,
                  return_numpy: bool = True, sync_fetch: bool = True):
        """k training steps in one call (reference ``run_steps``,
        ``paddle_tpu/core/executor.py:430``), equal bit for bit to k
        sequential ``run()`` calls: losses, every parameter and optimizer
        slot, the step counter (advanced by k) and every dropout mask.

        ``feed`` is stacked: every entry has a leading [k, ...] axis,
        slice i being step i's feed; k is inferred from it when not
        given, and the reference's errors are raised for a bad k or a
        feed that is not stacked. Fetches come back stacked [k, ...]
        (numpy with ``return_numpy`` and ``sync_fetch``, else device
        tensors; a fetched SelectedRows as a SelectedRows of stacked
        rows and values).

        The stacked feeds go to the device once. Until the (program,
        scope, per-step feed shapes, fetch names) key has a compiled
        step, steps run as ``run()`` runs them (the first op by op, the
        second builds the step); the rest replay the compiled step
        (``_CompiledStep.run_many``: per-step slices and seed/key tables
        copied on the device, nothing read back between steps), and the
        fetches are read back once. The span ``executor.run_steps`` and
        the timer ``executor.run_steps_ms`` (one sample a call, covering
        k steps; its device split when all k were replays) are written as
        the reference writes them, and the step's cost record books k
        steps. A program
        with a host-IO op raises: the reference's fallback to k
        sequential runs comes with those ops (ROADMAP A9)."""
        program = program_of(program)
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = dict(feed or {})
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        if k is None:
            if not feed:
                raise ExecutionError(
                    "run_steps needs k= when there are no feeds to infer "
                    "the step count from")
            k = int(np.shape(next(iter(feed.values())))[0])
        k = int(k)
        if k < 1:
            raise ExecutionError(f"run_steps: k must be >= 1, got {k}")
        for name, v in feed.items():
            shape = tuple(np.shape(v))
            if len(shape) < 1 or shape[0] != k:
                raise ExecutionError(
                    f"run_steps: feed '{name}' must be stacked [k, ...] "
                    f"with k={k}; got shape {shape} — stack per-step "
                    f"batches along a new leading axis (np.stack)")
        io = sorted({op.type for blk in program.blocks for op in blk.ops}
                    & _PS_IO_TYPES)
        if io:
            raise NotImplementedError(
                f"run_steps over a program with host-IO ops {io}: the "
                f"reference runs k sequential steps there, which comes "
                f"with those ops (ROADMAP A9)")
        self._maybe_verify(program, feed, fetch_names, scope)
        feed_host_bytes = sum(v.nbytes for v in feed.values()
                              if isinstance(v, np.ndarray))
        if feed_host_bytes:
            telemetry.counter_add("executor.feed_host_bytes",
                                  int(feed_host_bytes))
        t0 = time.perf_counter()
        device = None
        with trace.span("executor.run_steps", program=_uid(program), k=k):
            block = program.global_block()
            stacked = {}
            with trace.span("executor.feed", feeds=len(feed)):
                for n, v in feed.items():
                    t, dt = _feed_spec(block, n, v)
                    stacked[n] = t.to(device=self.device, dtype=dt)
            rows: List[List[Any]] = []
            while len(rows) < k:
                i = len(rows)
                compiled = self._built_step(program, scope, fetch_names,
                                            stacked)
                if compiled is None:
                    out = self.run(program, {n: t[i] for n, t in
                                             stacked.items()},
                                   fetch_names, scope, return_numpy=False)
                    rows.append([_fetched(v, False) for v in out])
                    continue
                step = int(scope.find_var(STEP_COUNTER) or 0)
                telemetry.counter_add("executor.runs_compiled", 1)
                telemetry.counter_add("executor.cache_hits", 1)
                with trace.span("executor.dispatch", compiled=True,
                                k=k - i), _DeviceClock(self.device) as clock:
                    rows += compiled.run_many({n: t[i:] for n, t in
                                               stacked.items()}, step, k - i)
                # the device split only when every step was a replay: the
                # run() calls above did their own
                device = clock.value if i == 0 else None
                scope.set(STEP_COUNTER, np.int32(step + k - i))
                telemetry.counter_add("executor.fused_dispatches", 1)
                telemetry.counter_add("executor.fused_steps", k - i)
                costmodel.book_dispatch(compiled.cost, steps=k - i)
            with trace.span("executor.fetch", sync=return_numpy and
                            sync_fetch):
                out = [_stack([r[j] for r in rows])
                       for j in range(len(fetch_names))]
                if return_numpy and sync_fetch:
                    out = [_fetched(v, True) for v in out]
            if compiled is not None:
                compiled.check_guards()
        self._account("executor.run_steps_ms", device,
                      (time.perf_counter() - t0) * 1e3)
        incidents.tick()
        goodput.tick()
        return out

    def _built_step(self, program, scope, fetch_names, stacked):
        """The compiled step ``run()`` would replay for one step of these
        stacked feeds, or None where it has none built yet (or the scope
        no longer holds its tensors)."""
        block = program.global_block()
        plan_key = (len(block.ops), tuple(fetch_names))
        steps = self._compiled.get(program, {}).get(scope, {})
        key = _step_key(plan_key, ((n, t.shape[1:], t.dtype)
                                   for n, t in stacked.items()))
        compiled = steps.get(key)
        if isinstance(compiled, _CompiledStep) and compiled.holds(scope):
            return compiled
        return None

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_compiled: bool = True):
        """Run block 0 of ``program`` once. Feeds are cast to their
        declared dtypes (64-bit types to 32, as the reference does),
        persistable vars are read from and written back to ``scope``,
        and the scope's step counter goes up by one. With
        ``return_numpy`` fetches come back as numpy arrays; a bf16 fetch
        comes back as an ``ml_dtypes.bfloat16`` array, as the reference
        returns it, where ``ml_dtypes`` imports, and as float32 where it
        does not.

        ``use_compiled`` (the default, as in the reference) runs a
        compiled step: the first run of a (program, scope, feed shapes
        and dtypes, fetch names) key runs op by op; the second builds the
        step (static feed buffers, a seed table, the scope's tensors) and,
        on a CUDA device, captures it into a CUDA graph and replays it;
        later runs copy the feeds in and replay. A step whose scope
        tensors were replaced since it was built is built again (an op by
        op run, then a new capture). A program holding an op that cannot
        be replayed (``registry`` ``capturable=False``: the random
        initializers of a startup program) raises at that second run. On
        the CPU there is no graph: the same step, with its static
        buffers, seed table and write-back, is called on every run, which
        gives the op-by-op path's results bit for bit. Fetches of a
        compiled step come from its static outputs: copied to the host
        with ``return_numpy``, cloned without it. ``use_compiled=False``
        runs every step op by op. A ``CompiledProgram`` runs its
        Program."""
        program = program_of(program)
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        self._maybe_verify(program, feed, fetch_names, scope)
        feed_host_bytes = sum(v.nbytes for v in (feed or {}).values()
                              if isinstance(v, np.ndarray))
        if feed_host_bytes:
            telemetry.counter_add("executor.feed_host_bytes",
                                  int(feed_host_bytes))
        t0 = time.perf_counter()
        try:
            with trace.span("executor.run", program=_uid(program)):
                out, timer, device = self._run(
                    program, feed, fetch_names, scope, return_numpy,
                    use_compiled, t0)
        except torch.OutOfMemoryError as e:
            raise costmodel.oom_forensics(
                f"p{_uid(program)}v{len(program.global_block().ops)}", e,
                where="executor.dispatch") from e
        if return_numpy:
            fetch_bytes = sum(v.nbytes for v in out
                              if isinstance(v, np.ndarray))
            if fetch_bytes:
                telemetry.counter_add("executor.fetch_host_bytes",
                                      int(fetch_bytes))
        self._account(timer, device, (time.perf_counter() - t0) * 1e3)
        incidents.tick()
        goodput.tick()
        return out

    @staticmethod
    def _account(timer: Optional[str], device, run_ms: float):
        """One run's timer (``executor.interpret_ms`` op by op,
        ``executor.run_ms`` or ``run_steps_ms`` for replays) and, given a
        replay's ``_DeviceClock`` value, its device / host split. CUDA
        events are read once they have completed (at a later run,
        ``goodput.breakdown`` or ``flush``): the host never waits for the
        card here."""
        if timer is None:
            return
        telemetry.observe(timer, run_ms, kind="timer")
        if isinstance(device, tuple):
            _pending_device.append(device + (run_ms,))
            _settle_device(wait=False)
        elif device is not None:
            _observe_split(device, run_ms)

    def _run(self, program, feed, fetch_names, scope, return_numpy,
             use_compiled, t0):
        """One run: (fetches, the timer and device clock value for
        ``_account``: none for a key's first run and its capture)."""
        block = program.global_block()
        step = scope.find_var(STEP_COUNTER)
        step = 0 if step is None else int(step)
        persist = {v.name for v in block.vars.values() if v.persistable}
        plans = self._dead.setdefault(program, {})
        plan_key = (len(block.ops), tuple(fetch_names))
        dead = plans.get(plan_key)
        if dead is None:
            dead = plans[plan_key] = _last_readers(block,
                                                   persist | set(fetch_names))
        with trace.span("executor.feed", feeds=len(feed or {})):
            feeds = {n: _feed_spec(block, n, v)
                     for n, v in (feed or {}).items()}
        telemetry.counter_add("executor.runs_compiled" if use_compiled
                              else "executor.runs_interpreted", 1)

        compiled, built = None, False
        if use_compiled:
            steps = self._compiled.setdefault(
                program, weakref.WeakKeyDictionary()).setdefault(scope, {})
            key = _step_key(plan_key, ((n, t.shape, dt)
                                       for n, (t, dt) in feeds.items()))
            compiled = steps.get(key)
            if compiled is _SEEN:
                compiled = steps[key] = self._build_step(
                    program, scope, key, block, dead, feeds, fetch_names,
                    persist)
                built = True
            elif compiled is not None and not compiled.holds(scope):
                compiled = None
            elif compiled is not None:
                telemetry.counter_add("executor.cache_hits", 1)
            if compiled is None:
                steps[key] = _SEEN
                telemetry.counter_add("executor.cache_misses", 1)
        if compiled is not None:
            with trace.span("executor.dispatch", compiled=True), \
                    _DeviceClock(self.device) as clock, \
                    _prof.RecordEvent("executor::run"):
                out = compiled.run({n: t for n, (t, _) in feeds.items()},
                                   step)
            scope.set(STEP_COUNTER, np.int32(step + 1))
            with trace.span("executor.fetch", sync=return_numpy):
                fetched = [_fetched(v, return_numpy) for v in out]
            compiled.check_guards()
            if built:
                self._after_compile(program, block, compiled, key, out,
                                    (time.perf_counter() - t0) * 1e3)
                return fetched, None, None
            costmodel.book_dispatch(compiled.cost)
            return fetched, "executor.run_ms", clock.value

        env: Dict[str, Any] = dict(scope.items())
        env.update({n: t.to(device=self.device, dtype=dt)
                    for n, (t, dt) in feeds.items()})
        feeds.clear()   # the env holds the only reference to each feed
        with trace.span("executor.dispatch", compiled=False), \
                registry.creating_on(self.device):
            for op, drop in zip(block.ops, dead):
                run_op(op, env, step=step)
                for n in drop:
                    env.pop(n, None)

        for name in persist:
            if name in env:
                scope.set(name, env[name])
        scope.set(STEP_COUNTER, np.int32(step + 1))
        out = []
        with trace.span("executor.fetch", sync=return_numpy):
            for n in fetch_names:
                if n not in env:
                    raise ExecutionError(
                        f"fetch target '{n}' was not produced")
                v = env[n]
                if return_numpy or isinstance(v, SelectedRows):
                    v = _fetched(v, return_numpy)
                out.append(v)
        return out, (None if use_compiled else "executor.interpret_ms"), None
