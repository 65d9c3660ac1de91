"""Static program verifier (port of ``paddle_tpu/core/verify.py``).

A Program is checked before it runs, so a malformed one (a dangling
input left by a fusion pass, a shape mismatch, two unordered writes to
one var) fails with a typed, located ``ProgramVerifyError`` instead of an
error deep in a lowering, or a silent wrong answer. Five registered
checks over a ``VerifyContext``:

* ``structure``: every op input/output resolves to a VarDesc visible
  from its block, the op type has a lowering, the attrs its lowering
  dereferences (``OpDef.required_attrs``) are present; fusion_group
  sub-op types are registered.
* ``dataflow``: def-before-use in program order, dangling reads (a
  non-persistable var no op produces and nothing feeds), uninitialised
  persistable reads when a scope is given, fetch targets nothing
  produces, and dead VarDescs (warnings).
* ``hazards``: a write-after-write on one var that nothing reads in
  between.
* ``donation``: a feed that aliases written persistable state, and a
  sub-block write to an outer persistable (a warning).
* ``shapes`` (opt-in, ``infer_shapes=True``): the build-time shape
  inference again over the (rewritten) program: each lowering runs on
  ``meta`` tensors at the propagated input shapes, dynamic dims found by
  the two-sentinel substitution, where the reference runs
  ``jax.eval_shape``. A lowering that rejects its inputs, and an
  inferred shape or dtype that disagrees with the declared one, are
  violations.

``core.passes.apply_passes`` runs the four default checks after every
pass (``FLAGS_verify_passes``), naming the pass. Counters:
``verifier.programs``, ``verifier.checks_run``, ``verifier.violations``
and the ``verifier.verify_ms`` timer. The reference's executor gate
(``FLAGS_verify_program``) and its ``tools/graph_lint.py`` CLI are not
ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from . import registry, telemetry
from .ir import Block, OpDesc, Program, _string_refs
from .registry import EMPTY_VAR

# Names the runtime injects into every step env: never a dangling read.
_RUNTIME_VARS = frozenset(("@STEP_COUNTER@",))

# Op types the shapes check does not run on meta tensors (host IO in the
# reference): their outputs are unknown.
_SHAPE_SKIP_TYPES = frozenset((
    "send", "recv", "send_barrier", "fetch_barrier", "listen_and_serv",
    "save", "load", "save_combine", "load_combine", "checkpoint_notify",
    "py_func", "print", "feed", "fetch"))


# ---------------------------------------------------------------------------
# violations and the typed error
# ---------------------------------------------------------------------------

@dataclass
class Violation:
    """One finding: which check fired, where, and why."""

    check: str                    # e.g. "dangling_input"
    severity: str                 # "error" | "warning"
    block_idx: int
    op_idx: int                   # -1 for block-level findings
    op_type: str                  # "" for block-level findings
    var: str = ""
    message: str = ""

    def format(self) -> str:
        # clickable-style location prefix, program:block:op like file:line
        loc = f"program:block{self.block_idx}"
        if self.op_idx >= 0:
            loc += f":op{self.op_idx}"
        what = f" '{self.op_type}'" if self.op_type else ""
        var = f" var '{self.var}':" if self.var else ""
        return (f"{loc}: [{self.check}/{self.severity}]{what}:{var} "
                f"{self.message}")


class ProgramVerifyError(RuntimeError):
    """A program failed static verification.

    Carries the full violation list plus (block_idx, op_idx, op_type,
    check) of the first error. A plain RuntimeError subclass: it names a
    programming error, never a transport fault to retry.
    """

    def __init__(self, violations: Sequence[Violation], context: str = ""):
        self.violations = list(violations)
        self.context = context
        errors = [v for v in self.violations if v.severity == "error"]
        first = errors[0] if errors else (
            self.violations[0] if self.violations else None)
        self.check = first.check if first else ""
        self.block_idx = first.block_idx if first else -1
        self.op_idx = first.op_idx if first else -1
        self.op_type = first.op_type if first else ""
        head = f"program verification failed"
        if context:
            head += f" ({context})"
        head += (f": {len(errors)} error(s), "
                 f"{len(self.violations) - len(errors)} warning(s)")
        lines = [head] + ["  " + v.format() for v in self.violations]
        super().__init__("\n".join(lines))


@dataclass
class VerifyResult:
    violations: List[Violation] = field(default_factory=list)
    checks_run: Tuple[str, ...] = ()
    elapsed_ms: float = 0.0
    context: str = ""

    @property
    def errors(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "error"]

    @property
    def warnings(self) -> List[Violation]:
        return [v for v in self.violations if v.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_error(self):
        if self.errors:
            raise ProgramVerifyError(self.violations, context=self.context)
        return self


# ---------------------------------------------------------------------------
# context shared by the checks
# ---------------------------------------------------------------------------

def _attr_blocks(op: OpDesc) -> List[Block]:
    """Blocks held in the op's attrs (cond true/false, while cond/body,
    block_call sub_block, run_program's program blocks)."""
    out: List[Block] = []

    def scan(val):
        if isinstance(val, Block):
            out.append(val)
        elif isinstance(val, Program):
            out.extend(val.blocks)
        elif isinstance(val, dict):
            for v in val.values():
                scan(v)
        elif isinstance(val, (list, tuple)):
            for v in val:
                scan(v)

    for val in (op.attrs or {}).values():
        scan(val)
    return out


class VerifyContext:
    """Program + optional runtime knowledge (feeds/fetches/scope),
    with the block walk and per-block io tables precomputed once."""

    def __init__(self, program: Program, feed_names=None, fetch_names=None,
                 scope=None):
        self.program = program
        self.feed_names: Optional[Set[str]] = (
            set(feed_names) if feed_names is not None else None)
        self.fetch_names: List[str] = list(fetch_names or [])
        self.scope = scope
        self.scope_names: Optional[Set[str]] = None
        if scope is not None:
            names: Set[str] = set()
            s = scope
            while s is not None:
                names.update(s.local_var_names())
                s = getattr(s, "parent", None)
            self.scope_names = names
        # blocks: program.blocks plus attr-held blocks (a cloned program's
        # control-flow ops hold deepcopied blocks that are NOT in
        # program.blocks — those are what the lowerings execute)
        self.blocks: List[Block] = []
        seen: Set[int] = set()
        pending = list(program.blocks)
        while pending:
            blk = pending.pop(0)
            if id(blk) in seen or not isinstance(blk, Block):
                continue
            seen.add(id(blk))
            self.blocks.append(blk)
            for op in blk.ops:
                pending.extend(_attr_blocks(op))
        # all names any op (or op attr) references, program-wide
        self.referenced: Set[str] = set(self.fetch_names)
        for blk in self.blocks:
            for op in blk.ops:
                self.referenced.update(n for n in op.input_names())
                self.referenced.update(n for n in op.output_names())
                for val in (op.attrs or {}).values():
                    if not isinstance(val, (Block, Program)):
                        _string_refs(val, self.referenced)

    # -- helpers -------------------------------------------------------------
    def resolve(self, block: Block, name: str):
        return block._find_var_recursive(name)

    def block_writers(self, block: Block) -> Dict[str, List[int]]:
        writers: Dict[str, List[int]] = {}
        for i, op in enumerate(block.ops):
            for n in op.output_names():
                if n != EMPTY_VAR:
                    writers.setdefault(n, []).append(i)
        return writers

    def block_readers(self, block: Block) -> Dict[str, List[int]]:
        readers: Dict[str, List[int]] = {}
        for i, op in enumerate(block.ops):
            for n in op.input_names():
                if n != EMPTY_VAR:
                    readers.setdefault(n, []).append(i)
        return readers

    def is_external(self, name: str) -> bool:
        """Name satisfiable from outside the program at run time."""
        if self.feed_names is not None and name in self.feed_names:
            return True
        if self.scope_names is not None and name in self.scope_names:
            return True
        return name in _RUNTIME_VARS


# ---------------------------------------------------------------------------
# check registry
# ---------------------------------------------------------------------------

CheckFn = Callable[[VerifyContext], List[Violation]]

_CHECKS: Dict[str, CheckFn] = {}

# checks cheap enough to run on every pass application / executor gate
DEFAULT_CHECKS = ("structure", "dataflow", "hazards", "donation")


def register_check(name: str):
    def deco(fn: CheckFn) -> CheckFn:
        _CHECKS[name] = fn
        return fn

    return deco


def registered_checks() -> List[str]:
    return sorted(_CHECKS)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

@register_check("structure")
def check_structure(ctx: VerifyContext) -> List[Violation]:
    vios: List[Violation] = []
    for blk in ctx.blocks:
        for oi, op in enumerate(blk.ops):
            opdef = registry.lookup(op.type)
            if opdef is None or opdef.forward is None:
                vios.append(Violation(
                    "unregistered_op", "error", blk.idx, oi, op.type,
                    message="op type has no registered lowering"))
            else:
                for a in opdef.required_attrs:
                    if a not in op.attrs:
                        vios.append(Violation(
                            "missing_attr", "error", blk.idx, oi, op.type,
                            var=a,
                            message=f"required attr '{a}' is absent "
                                    f"(the lowering dereferences it)"))
            for n in op.input_names():
                if n != EMPTY_VAR and ctx.resolve(blk, n) is None:
                    vios.append(Violation(
                        "dangling_input", "error", blk.idx, oi, op.type,
                        var=n,
                        message="reads a var with no VarDesc in any "
                                "scope-visible block"))
            for n in op.output_names():
                if n != EMPTY_VAR and ctx.resolve(blk, n) is None:
                    vios.append(Violation(
                        "undefined_output", "error", blk.idx, oi, op.type,
                        var=n,
                        message="writes a var with no VarDesc in any "
                                "scope-visible block"))
            if op.type == "fusion_group":
                for sub in op.attrs.get("sub_ops", []) or []:
                    st = sub.get("type") if isinstance(sub, dict) else None
                    if st is None or registry.lookup(st) is None:
                        vios.append(Violation(
                            "unregistered_op", "error", blk.idx, oi,
                            op.type, var=str(st),
                            message="fusion_group sub-op type is not "
                                    "registered"))
    return vios


# ---------------------------------------------------------------------------
# dataflow
# ---------------------------------------------------------------------------

@register_check("dataflow")
def check_dataflow(ctx: VerifyContext) -> List[Violation]:
    vios: List[Violation] = []
    for blk in ctx.blocks:
        writers = ctx.block_writers(blk)
        defined: Set[str] = set()
        for oi, op in enumerate(blk.ops):
            for n in op.input_names():
                if n == EMPTY_VAR or n in defined:
                    continue
                var = ctx.resolve(blk, n)
                if var is None:
                    continue          # structure already flagged it
                persistable = bool(var.desc.persistable)
                local_ws = writers.get(n)
                if local_ws:
                    # produced in this block, but only at a LATER index.
                    # Legit sources for the incoming value: the scope
                    # (persistable), the feed, an ancestor block's write
                    # (loop carries seeded by the parent control-flow
                    # op), or — for an in-place RMW op (increment,
                    # batch_norm stats) whose first writer is the
                    # reading op ITSELF — any of the above; flag only
                    # when none exist
                    if persistable or ctx.is_external(n) or \
                            _written_by_ancestor(ctx, blk, n):
                        continue
                    if local_ws[0] == oi:
                        # self-RMW with no visible source: only judge
                        # when we actually know the feeds
                        if ctx.feed_names is not None and \
                                blk.program is ctx.program:
                            vios.append(Violation(
                                "dangling_read", "error", blk.idx, oi,
                                op.type, var=n,
                                message="in-place op reads a var whose "
                                        "only producer is itself and "
                                        "nothing external provides it"))
                        continue
                    vios.append(Violation(
                        "def_after_use", "error", blk.idx, oi, op.type,
                        var=n,
                        message=f"read before its definition (first "
                                f"written by op {local_ws[0]} "
                                f"'{blk.ops[local_ws[0]].type}')"))
                    continue
                # external to this block: fine if persistable (scope),
                # produced by an ancestor block, fed, or runtime-injected
                if persistable:
                    if ctx.scope_names is not None \
                            and blk.program is ctx.program \
                            and n not in ctx.scope_names \
                            and not _written_by_ancestor(ctx, blk, n):
                        vios.append(Violation(
                            "uninitialized_read", "error", blk.idx, oi,
                            op.type, var=n,
                            message="persistable var is neither in the "
                                    "scope nor written earlier — did the "
                                    "startup program run?"))
                    continue
                if ctx.feed_names is None or blk.program is not ctx.program:
                    # no runtime knowledge (or a foreign attr-held
                    # sub-program with its own feed convention): can't
                    # judge external reads
                    continue
                if ctx.is_external(n) or _written_by_ancestor(ctx, blk, n):
                    continue
                vios.append(Violation(
                    "dangling_read", "error", blk.idx, oi, op.type, var=n,
                    message="non-persistable var has no producer and is "
                            "not fed — dangling read (pass-removed "
                            "producer?)"))
            for n in op.output_names():
                if n != EMPTY_VAR:
                    defined.add(n)
        # dead VarDescs: declared here, referenced by no op anywhere —
        # the droppings a fusion pass leaves behind
        for name, var in blk.vars.items():
            if name in ctx.referenced or var.desc.persistable:
                continue
            if ctx.feed_names is not None and name in ctx.feed_names:
                continue
            vios.append(Violation(
                "dead_var", "warning", blk.idx, -1, "", var=name,
                message="VarDesc is referenced by no op in any block "
                        "(leaked by a pass?)"))
    # fetch targets must be statically satisfiable from block 0
    if ctx.fetch_names:
        blk0 = ctx.program.global_block()
        produced = {n for op in blk0.ops for n in op.output_names()}
        for n in ctx.fetch_names:
            if n in produced or n in _RUNTIME_VARS:
                continue
            var = ctx.resolve(blk0, n)
            if var is not None and var.desc.persistable:
                continue
            if ctx.feed_names is not None and n in ctx.feed_names:
                continue
            if ctx.scope_names is not None and n in ctx.scope_names:
                continue
            vios.append(Violation(
                "missing_fetch", "error", 0, -1, "", var=n,
                message="fetch target is produced by no block-0 op and "
                        "is not fed/persistable"))
    return vios


def _written_by_ancestor(ctx: VerifyContext, block: Block, name: str) -> bool:
    blk = block.parent_block
    while blk is not None:
        for op in blk.ops:
            if name in op.output_names():
                return True
        blk = blk.parent_block
    return False


# ---------------------------------------------------------------------------
# hazards
# ---------------------------------------------------------------------------

@register_check("hazards")
def check_hazards(ctx: VerifyContext) -> List[Violation]:
    """Write-after-write with no intervening observer: op j overwrites
    op i's write and NOTHING (op j included) read the value in between.
    The first write is dead at best; at worst a pass that reorders
    independent-looking ops (or the donation machinery reusing the
    buffer) turns it into a wrong answer. Reference analog: the ir graph
    builder's write-dependency edges (graph.cc) that executors honour —
    this IR's program order is the only edge, so an unobserved double
    write means the edge never existed."""
    vios: List[Violation] = []
    for blk in ctx.blocks:
        writers = ctx.block_writers(blk)
        readers = ctx.block_readers(blk)
        for name, ws in writers.items():
            if len(ws) < 2:
                continue
            rs = readers.get(name, [])
            for i, j in zip(ws, ws[1:]):
                if any(i < r <= j for r in rs):
                    continue          # observed (or read-modify-write)
                vios.append(Violation(
                    "waw_hazard", "error", blk.idx, j,
                    blk.ops[j].type, var=name,
                    message=f"overwrites op {i} '{blk.ops[i].type}''s "
                            f"write with no read in between — unordered "
                            f"write-write hazard (lost update)"))
    return vios


# ---------------------------------------------------------------------------
# donation safety
# ---------------------------------------------------------------------------

@register_check("donation")
def check_donation(ctx: VerifyContext) -> List[Violation]:
    vios: List[Violation] = []
    blk0 = ctx.program.global_block()
    state = set()
    for op in blk0.ops:
        for n in op.output_names():
            if n == EMPTY_VAR:
                continue
            var = ctx.resolve(blk0, n)
            if var is not None and var.desc.persistable:
                state.add(n)
    # (a) a feed aliasing donated state: env.update(state) then
    # env.update(feed) silently shadows the carried value, and under
    # run_steps the [k,...]-stacked feed is NOT a valid scan carry
    if ctx.feed_names:
        for n in sorted(ctx.feed_names & state):
            vios.append(Violation(
                "donated_feed_overlap", "error", 0, -1, "", var=n,
                message="fed var is also donated training state "
                        "(persistable + written by the block): the feed "
                        "shadows the carried value and breaks run_steps "
                        "scan donation"))
    # (b) sub-block writes to outer persistables: the compiling
    # executor's state analysis only sees block-0 writes, so the update
    # never reaches the scope (and the donated buffer may alias it)
    for blk in ctx.blocks:
        if blk is blk0 or blk.parent_idx < 0 and blk.idx == 0:
            continue
        for oi, op in enumerate(blk.ops):
            for n in op.output_names():
                if n == EMPTY_VAR or n in blk.vars:
                    continue
                var = ctx.resolve(blk, n)
                if var is not None and var.desc.persistable:
                    vios.append(Violation(
                        "sub_block_state_write", "warning", blk.idx, oi,
                        op.type, var=n,
                        message="sub-block writes an outer persistable "
                                "var — invisible to the executor's "
                                "block-0 state analysis; the update is "
                                "dropped (write it through a block-0 op "
                                "output instead)"))
    return vios


# ---------------------------------------------------------------------------
# static shape/dtype propagation
# ---------------------------------------------------------------------------

def _holds_block(op: OpDesc) -> bool:
    return any(isinstance(v, (Block, Program))
               for v in (op.attrs or {}).values())


def _meta(shape, dtype):
    from .types import to_torch_dtype, x64_off

    return torch.empty(shape, dtype=x64_off(to_torch_dtype(dtype)),
                       device="meta")


def _rejects_shapes(e: Exception) -> bool:
    """Whether a lowering's exception on meta tensors says its inputs'
    shapes are wrong (torch raises RuntimeError for those), as opposed
    to a lowering that cannot run on meta at all (a host read, an op
    without a meta kernel)."""
    if isinstance(e, NotImplementedError):
        return False
    if isinstance(e, (TypeError, ValueError, IndexError)):
        return True
    return isinstance(e, RuntimeError) and "meta" not in str(e).lower()


@register_check("shapes")
def check_shapes(ctx: VerifyContext) -> List[Violation]:
    """Re-run build-time shape inference over the (possibly rewritten)
    program: each op's lowering runs on meta tensors at the propagated
    input shapes (declared VarDescs seed the walk; dynamic -1 dims go
    through the two sentinels of ``Block._infer_op_shapes``). A lowering
    that rejects its inputs is the error the first run would raise; an
    inferred output that disagrees with its declared shape or dtype means
    a pass rewired shapes without updating the descs."""
    from .ir import _DYN_SENTINEL, _DYN_SENTINEL_B
    from .types import to_torch_dtype, x64_off

    vios: List[Violation] = []
    for blk in ctx.blocks:
        # name -> (meta tensor a, meta tensor b) | None (unknown)
        env: Dict[str, Any] = {}

        def mark_unknown(op):
            for n in op.output_names():
                if n != EMPTY_VAR:
                    env[n] = None

        for oi, op in enumerate(blk.ops):
            opdef = registry.lookup(op.type)
            if (opdef is None or opdef.forward is None
                    or opdef.skip_infer_shape
                    or op.type in _SHAPE_SKIP_TYPES or _holds_block(op)):
                mark_unknown(op)
                continue
            ins_a: Dict[str, List[Any]] = {}
            ins_b: Dict[str, List[Any]] = {}
            has_dyn = False
            unknown = False
            for slot, names in op.inputs.items():
                la, lb = [], []
                for n in names:
                    if n == EMPTY_VAR:
                        la.append(None)
                        lb.append(None)
                        continue
                    pair = env.get(n, _ABSENT)
                    if pair is _ABSENT:
                        var = ctx.resolve(blk, n)
                        if var is None or var.shape is None:
                            unknown = True
                            break
                        pair = (_meta([_DYN_SENTINEL if d == -1 else d
                                       for d in var.shape], var.dtype),
                                _meta([_DYN_SENTINEL_B if d == -1 else d
                                       for d in var.shape], var.dtype))
                    elif pair is None:
                        unknown = True
                        break
                    has_dyn = has_dyn or pair[0].shape != pair[1].shape
                    la.append(pair[0])
                    lb.append(pair[1])
                if unknown:
                    break
                ins_a[slot] = la
                ins_b[slot] = lb
            if unknown:
                mark_unknown(op)
                continue
            try:
                with registry.creating_on("meta"):
                    out_a = registry.normalize_outputs(
                        opdef.forward(ins_a, dict(op.attrs)))
                    out_b = registry.normalize_outputs(
                        opdef.forward(ins_b, dict(op.attrs))) \
                        if has_dyn else out_a
            except Exception as e:
                if _rejects_shapes(e):
                    vios.append(Violation(
                        "shape_mismatch", "error", blk.idx, oi, op.type,
                        message=f"lowering rejects the declared input "
                                f"shapes: {type(e).__name__}: "
                                f"{str(e)[:300]}"))
                else:
                    telemetry.counter_add("verifier.shape_infer_skips", 1)
                mark_unknown(op)
                continue
            for slot, names in op.outputs.items():
                va, vb = out_a.get(slot), out_b.get(slot)
                if va is None:
                    for n in names:
                        if n != EMPTY_VAR:
                            env[n] = None
                    continue
                for n, ta, tb in zip(names, va, vb):
                    if n == EMPTY_VAR:
                        continue
                    if not isinstance(ta, torch.Tensor) or \
                            not isinstance(tb, torch.Tensor) or \
                            ta.dim() != tb.dim():
                        env[n] = None
                        continue
                    env[n] = (ta, tb)
                    var = ctx.resolve(blk, n)
                    if var is None or var.shape is None:
                        continue
                    inferred = tuple(-1 if da != db else int(da)
                                     for da, db in zip(ta.shape, tb.shape))
                    declared = tuple(var.shape)
                    if len(declared) != len(inferred) or any(
                            d != -1 and i != -1 and d != i
                            for d, i in zip(declared, inferred)):
                        vios.append(Violation(
                            "shape_mismatch", "error", blk.idx, oi,
                            op.type, var=n,
                            message=f"declared shape {declared} != "
                                    f"inferred {inferred}"))
                    elif x64_off(ta.dtype) != \
                            x64_off(to_torch_dtype(var.dtype)):
                        vios.append(Violation(
                            "dtype_mismatch", "error", blk.idx, oi,
                            op.type, var=n,
                            message=f"declared dtype {var.dtype} != "
                                    f"inferred {ta.dtype}"))
    return vios


_ABSENT = object()


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def verify_program(program: Program, *, feed_names=None, fetch_names=None,
                   scope=None, checks: Optional[Sequence[str]] = None,
                   infer_shapes: bool = False, raise_on_error: bool = True,
                   context: str = "") -> VerifyResult:
    """Run the static checks over `program` and return a VerifyResult.

    feed_names/fetch_names/scope sharpen the dataflow checks (dangling
    reads, missing fetches, uninitialized persistables) — without them
    external inputs are assumed satisfiable. ``infer_shapes=True`` adds
    the eval_shape propagation check (one trace per op — opt in on hot
    paths). ``raise_on_error`` turns error-severity violations into a
    typed ProgramVerifyError.
    """
    names = list(checks) if checks is not None else list(DEFAULT_CHECKS)
    if infer_shapes and "shapes" not in names:
        names.append("shapes")
    ctx = VerifyContext(program, feed_names=feed_names,
                        fetch_names=fetch_names, scope=scope)
    t0 = time.perf_counter()
    violations: List[Violation] = []
    for name in names:
        fn = _CHECKS.get(name)
        if fn is None:
            raise KeyError(
                f"unknown verifier check '{name}'; have {registered_checks()}")
        violations.extend(fn(ctx))
    elapsed = (time.perf_counter() - t0) * 1e3
    telemetry.counter_add("verifier.programs", 1)
    telemetry.counter_add("verifier.checks_run", len(names))
    if violations:
        telemetry.counter_add("verifier.violations", len(violations))
    telemetry.observe("verifier.verify_ms", round(elapsed, 3))
    result = VerifyResult(violations=violations, checks_run=tuple(names),
                          elapsed_ms=elapsed, context=context)
    if raise_on_error:
        result.raise_if_error()
    return result
