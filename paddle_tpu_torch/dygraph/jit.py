"""dygraph -> static: ``@to_static``, ``TracedLayer``, ``jit.save`` /
``jit.load``.

The port of ``paddle_tpu/dygraph/jit.py``. Capture by execution: the
decorated function runs eagerly once per input signature while every
``trace_op`` records its op into a fresh Program, so Python control flow
runs on concrete values and is frozen into the trace. Before that an AST
pass (``_IfTransformer``, a copy of the reference's) rewrites each
eligible ``if``, ``while`` and ``for ... in range`` so that a test on a
traced tensor becomes a ``where`` blend of both branches or one bounded
``while_loop`` op, which a replay runs for any value of the test.

Every call, the first included, runs the captured block as one
``run_program`` op on the autograd tape (``ops/control_flow_ops.py``):
op by op on the CPU, and on the card as CUDA graphs captured once per
signature of its feeds and parameters, the forward graph and a backward
graph that keeps the forward's activations, so a call dispatches no op
from the host.

VarBase convenience methods run ad-hoc torch closures (``trace_fn``);
those are recorded as ``__jax_fn__`` ops (the reference's name, so the
two registries stay comparable): callable in memory, refused by
``save``.
"""

from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core import unique_name
from ..core.ir import Program
from ..core.registry import EMPTY_VAR, register_op
from ..core.types import dtype_name
from .varbase import VarBase

_capture_stack: List["_CaptureState"] = []


# ---------------------------------------------------------------------------
# The AST rewrite of `if`, `while` and `for ... in range` (a copy of the
# reference's, ``paddle_tpu/dygraph/jit.py:39-539``).
#
# Every eligible `if` in the decorated function becomes
#
#     def _jst_true():  <body>;   return (a, b, ...)
#     def _jst_false(): <orelse>; return (a, b, ...)
#     (a, b, ...) = _jst_if(<test>, _jst_true, _jst_false)
#
# Each branch function receives a snapshot of the assigned names' pre-if
# values and binds them as locals, so the branches are isolated from each
# other and augmented assignments work. At run time `_jst_if` dispatches:
# a plain-Python test keeps Python's semantics (and the value is part of
# the trace signature); a traced tensor test runs both branches and
# blends every assigned tensor with a `where` op, so one traced program
# serves either outcome. Branches holding return/break/continue or
# `global` names stay as they are.
# ---------------------------------------------------------------------------


class _Missing:
    __slots__ = ()

    def __repr__(self):
        return "<undefined before if>"


_JST_MISSING = _Missing()


def _jst_not(x):
    """Tensor-aware `not` for generated break/continue guards."""
    if isinstance(x, VarBase):
        from .tracer import trace_op

        return trace_op("logical_not", {"X": [x]}, {})["Out"][0]
    return not x


def _jst_bool2(op):
    def f(a, b):
        if isinstance(a, VarBase) or isinstance(b, VarBase):
            from .tracer import trace_op

            av = a if isinstance(a, VarBase) else VarBase(np.asarray(a))
            bv = b if isinstance(b, VarBase) else VarBase(np.asarray(b))
            return trace_op(op, {"X": [av], "Y": [bv]}, {})["Out"][0]
        return (a or b) if op == "logical_or" else (a and b)

    return f


_jst_or = _jst_bool2("logical_or")
_jst_and = _jst_bool2("logical_and")


def _jst_peek(fn):
    try:
        return fn()
    except NameError:
        return _JST_MISSING


class _ControlFinder(ast.NodeVisitor):
    def __init__(self):
        self.blocked = False

    def visit_Return(self, node):
        self.blocked = True

    def visit_Break(self, node):
        self.blocked = True

    def visit_Continue(self, node):
        self.blocked = True

    def visit_Global(self, node):
        self.blocked = True

    def visit_FunctionDef(self, node):
        pass            # nested defs own their control statements

    def visit_Lambda(self, node):
        pass


def _assigned_names(stmts) -> set:
    names = set()

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
            self.generic_visit(node.value)

        def visit_AugAssign(self, node):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
            self.generic_visit(node.value)

        def visit_AnnAssign(self, node):
            if isinstance(node.target, ast.Name) and node.value is not None:
                names.add(node.target.id)

        def visit_For(self, node):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    names.add(n.id)
            self.generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                if item.optional_vars is not None:
                    for n in ast.walk(item.optional_vars):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            self.generic_visit(node)

        def visit_Import(self, node):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])

        def visit_ImportFrom(self, node):
            for alias in node.names:
                names.add(alias.asname or alias.name)

        def visit_FunctionDef(self, node):
            names.add(node.name)

        def visit_Lambda(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return names


class _IfTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0

    # -- loops (reference: dygraph_to_static/loop_transformer.py) ----------
    #
    # `while <test>: <body>` becomes
    #
    #     def _jst_cond_i(__jst_snap__):  bind; return <test>
    #     def _jst_body_i(__jst_snap__):  bind; <body>; return (a, b, ...)
    #     (a, b, ...) = _jst_while(_jst_cond_i, _jst_body_i, snap)
    #
    # with the same snapshot/bind design as the if-rewrite: the loop state
    # is every name assigned in the body (plus names the test reads that
    # are also assigned — reads of untouched outer locals stay closure
    # lookups). At runtime a Python predicate runs the plain eager loop
    # (trace-time freeze, exact semantics); a traced-tensor predicate
    # sub-traces cond/body ONCE each and records a single `while_loop`
    # program op (bounded-scan lowering → differentiable), so the trip
    # count is a runtime value and changing it does not retrace.
    #
    # `for i in range(...)` (1- or 2-arg) desugars to that while form
    # first; other iterables keep Python semantics.

    # -- break/continue (reference: dygraph_to_static/
    # break_continue_transformer.py:86) -------------------------------------
    #
    # `break`/`continue` directly owned by a loop become flag variables:
    # break  -> _bc_brk_i = True   (loop test gains `and not brk`)
    # continue -> _bc_cnt_i = True (reset False each iteration)
    # (names must NOT carry the _jst_ prefix: _jst_* is machinery the
    # state collectors deliberately exclude)
    # and every statement after a flag-setting `if` is guarded by
    # `if _jst_not(_jst_or(brk, cnt)): ...` — which the if-transformer
    # then lowers to select form when the flags are tensors. A for-loop's
    # desugared counter bump is guarded by `not brk` ONLY (Python's
    # `continue` still increments the index).

    @staticmethod
    def _has_direct_bc(stmts) -> bool:
        found = [False]

        class F(ast.NodeVisitor):
            def visit_Break(self, n):
                found[0] = True

            def visit_Continue(self, n):
                found[0] = True

            def visit_While(self, n):     # nested loops own theirs
                pass

            def visit_For(self, n):
                pass

            def visit_FunctionDef(self, n):
                pass

            def visit_Lambda(self, n):
                pass

        f = F()
        for s in stmts:
            f.visit(s)
        return found[0]

    def _rewrite_bc(self, body, bf, cf):
        def assign_flag(name):
            a = ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                           value=ast.Constant(value=True))
            return a

        def guard_test():
            return ast.Call(
                func=ast.Name(id="_jst_not", ctx=ast.Load()),
                args=[ast.Call(
                    func=ast.Name(id="_jst_or", ctx=ast.Load()),
                    args=[ast.Name(id=bf, ctx=ast.Load()),
                          ast.Name(id=cf, ctx=ast.Load())],
                    keywords=[])],
                keywords=[])

        out = []
        for idx, s in enumerate(body):
            if isinstance(s, ast.Break):
                out.append(assign_flag(bf))
                return out                       # rest is unreachable
            if isinstance(s, ast.Continue):
                out.append(assign_flag(cf))
                return out
            if isinstance(s, ast.If) and self._has_direct_bc([s]):
                new_if = ast.If(
                    test=s.test,
                    body=self._rewrite_bc(s.body, bf, cf) or [ast.Pass()],
                    orelse=(self._rewrite_bc(s.orelse, bf, cf)
                            if s.orelse else []))
                out.append(new_if)
                rest = self._rewrite_bc(list(body[idx + 1:]), bf, cf)
                if rest:
                    out.append(ast.If(test=guard_test(), body=rest,
                                      orelse=[]))
                return out
            out.append(s)
        return out

    def _maybe_rewrite_loop_bc(self, body, test, bump=None):
        """Returns (pre_stmts, new_test, new_body); pre empty when the
        body has no directly-owned break/continue."""
        if not self._has_direct_bc(body):
            return [], test, list(body) + ([bump] if bump is not None
                                           else [])
        i = self.counter
        self.counter += 1
        bf, cf = f"_bc_brk_{i}", f"_bc_cnt_{i}"
        pre = [ast.Assign(targets=[ast.Name(id=n_, ctx=ast.Store())],
                          value=ast.Constant(value=False))
               for n_ in (bf, cf)]
        new_body = [ast.Assign(
            targets=[ast.Name(id=cf, ctx=ast.Store())],
            value=ast.Constant(value=False))]
        new_body += self._rewrite_bc(body, bf, cf)
        if self._has_direct_bc(new_body):
            # break/continue inside constructs the rewriter doesn't
            # reach (with/try) — give up, keep Python semantics (the
            # raw-loop fallback); rewriting again would recurse forever
            return [], test, list(body) + ([bump] if bump is not None
                                           else [])
        if bump is not None:
            new_body.append(ast.If(
                test=ast.Call(func=ast.Name(id="_jst_not", ctx=ast.Load()),
                              args=[ast.Name(id=bf, ctx=ast.Load())],
                              keywords=[]),
                body=[bump], orelse=[]))
        new_test = ast.Call(
            func=ast.Name(id="_jst_and", ctx=ast.Load()),
            args=[ast.Call(func=ast.Name(id="_jst_not", ctx=ast.Load()),
                           args=[ast.Name(id=bf, ctx=ast.Load())],
                           keywords=[]),
                  test],
            keywords=[])
        return pre, new_test, new_body

    def visit_While(self, node: ast.While):
        if not node.orelse:
            pre, new_test, new_body = self._maybe_rewrite_loop_bc(
                node.body, node.test)
            if pre:
                new_node = ast.While(test=new_test, body=new_body,
                                     orelse=[])
                for n in pre + [new_node]:
                    ast.copy_location(n, node)
                    ast.fix_missing_locations(n)
                result = self.visit_While(new_node)
                if isinstance(result, list):
                    return pre + result
                return pre + [result]
        self.generic_visit(node)
        if node.orelse:
            return node
        finder = _ControlFinder()
        for s in node.body:
            finder.visit(s)
        if finder.blocked:
            return node
        # generated _jst_* defs (from already-transformed nested ifs/loops)
        # are body-local machinery, never loop state
        assigned = sorted(n for n in _assigned_names(node.body)
                          if not n.startswith("_jst_"))
        if not assigned:
            return node
        i = self.counter
        self.counter += 1
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in assigned],
            ctx=ast.Load()))
        bind = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=ast.Name(id="__jst_snap__", ctx=ast.Load()))

        def mk(name, body):
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg="__jst_snap__")],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=[bind] + list(body) + [ret], decorator_list=[])

        snap = ast.Tuple(
            elts=[ast.Call(
                func=ast.Name(id="_jst_peek", ctx=ast.Load()),
                args=[ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
                    body=ast.Name(id=n, ctx=ast.Load()))],
                keywords=[]) for n in assigned],
            ctx=ast.Load())
        c_name, b_name = f"_jst_cond_{i}", f"_jst_body_{i}"
        c_def = mk(c_name, [ast.Return(value=node.test)])
        # strip mk's trailing tuple-return from the cond fn
        c_def.body = c_def.body[:-1]
        b_def = mk(b_name, node.body)
        # break/continue flags must be loop-carried TENSORS on the
        # traced path even when the example input never flips them (the
        # probe's changed-set would otherwise leave them frozen python
        # False in the predicate — runtime break silently ignored)
        flag_pos = [k for k, n in enumerate(assigned)
                    if n.startswith("_bc_")]
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="_jst_while", ctx=ast.Load()),
                args=[ast.Name(id=c_name, ctx=ast.Load()),
                      ast.Name(id=b_name, ctx=ast.Load()),
                      snap],
                keywords=[ast.keyword(
                    arg="flag_positions",
                    value=ast.Tuple(
                        elts=[ast.Constant(value=k) for k in flag_pos],
                        ctx=ast.Load()))] if flag_pos else []))
        out = [c_def, b_def, call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out

    def visit_For(self, node: ast.For):
        if node.orelse or not isinstance(node.target, ast.Name):
            self.generic_visit(node)
            return node
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords
                and len(it.args) in (1, 2)):
            self.generic_visit(node)
            return node
        finder = _ControlFinder()
        for s in node.body:
            finder.visit(s)
        has_bc = self._has_direct_bc(node.body)
        if finder.blocked and not has_bc:
            # Return/Global (or bc inside with/try constructs the
            # rewriter does not reach) — keep Python semantics
            self.generic_visit(node)
            return node
        i_name = node.target.id
        start = (ast.Constant(value=0) if len(it.args) == 1
                 else it.args[0])
        stop_name = f"_jst_stop_{self.counter}"
        init = [ast.Assign(targets=[ast.Name(id=i_name, ctx=ast.Store())],
                           value=start),
                ast.Assign(targets=[ast.Name(id=stop_name,
                                             ctx=ast.Store())],
                           value=it.args[-1])]
        bump = ast.AugAssign(target=ast.Name(id=i_name, ctx=ast.Store()),
                             op=ast.Add(), value=ast.Constant(value=1))
        test = ast.Compare(left=ast.Name(id=i_name, ctx=ast.Load()),
                           ops=[ast.Lt()],
                           comparators=[ast.Name(id=stop_name,
                                                 ctx=ast.Load())])
        if has_bc:
            # rewrite here so the counter bump is guarded by `not brk`
            # ONLY (`continue` still increments, matching Python)
            pre_bc, test, body = self._maybe_rewrite_loop_bc(
                list(node.body), test, bump=bump)
            after_bc = _ControlFinder()
            for s in body:
                after_bc.visit(s)
            if after_bc.blocked:       # Return alongside break etc.
                self.generic_visit(node)
                return node
            init += pre_bc
        else:
            body = list(node.body) + [bump]
        while_node = ast.While(test=test, body=body, orelse=[])
        for n in init + [while_node]:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        replaced = self.visit_While(while_node)   # also visits the body
        if replaced is while_node:           # not transformable: keep For
            self.generic_visit(node)
            return node
        return init + replaced

    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        finder = _ControlFinder()
        for s in node.body + node.orelse:
            finder.visit(s)
        if finder.blocked:
            return node
        assigned = sorted(n for n in (_assigned_names(node.body)
                                      | _assigned_names(node.orelse))
                          if not n.startswith("_jst_"))
        if not assigned:
            return node
        i = self.counter
        self.counter += 1
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in assigned],
            ctx=ast.Load()))
        # branch fns take the pre-if snapshot and bind it as locals
        bind = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=ast.Name(id="__jst_snap__", ctx=ast.Load()))

        def mk(name, body):
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg="__jst_snap__")],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=[bind] + list(body) + [ret], decorator_list=[])

        # snapshot: per-name guarded closure reads (undefined -> MISSING)
        snap = ast.Tuple(
            elts=[ast.Call(
                func=ast.Name(id="_jst_peek", ctx=ast.Load()),
                args=[ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
                    body=ast.Name(id=n, ctx=ast.Load()))],
                keywords=[]) for n in assigned],
            ctx=ast.Load())
        t_name, f_name = f"_jst_true_{i}", f"_jst_false_{i}"
        t_def = mk(t_name, node.body)
        f_def = mk(f_name, node.orelse or [ast.Pass()])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in assigned],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="_jst_if", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=t_name, ctx=ast.Load()),
                      ast.Name(id=f_name, ctx=ast.Load()),
                      snap],
                keywords=[]))
        out = [t_def, f_def, call]
        for n in out:
            ast.copy_location(n, node)
            ast.fix_missing_locations(n)
        return out




def _jst_if(pred, t_fn, f_fn, snap):
    """Run-time dispatch of a rewritten `if` (see the module notes): a
    Python test keeps Python's semantics; a tensor test under a capture
    runs both branches and blends their values with the `where` op."""
    if _capture_stack and not _suppress_capture and isinstance(pred, VarBase):
        from .tracer import trace_op

        t_vals = t_fn(snap)
        f_vals = f_fn(snap)
        blended = []
        for t, f in zip(t_vals, f_vals):
            if t is f:
                blended.append(t)
            elif isinstance(t, _Missing) or isinstance(f, _Missing):
                # a name only one branch defines: keep the defined side
                # (using it when the other branch ran is a user error the
                # reference also leaves to run time)
                warnings.warn(
                    "to_static: a name assigned in only ONE branch of a "
                    "tensor-dependent `if` cannot be selected at "
                    "runtime; the defined branch's value is kept "
                    "regardless of the predicate", stacklevel=3)
                blended.append(t if isinstance(f, _Missing) else f)
            elif isinstance(t, (VarBase, np.ndarray)) or \
                    isinstance(f, (VarBase, np.ndarray)):
                tv = t if isinstance(t, VarBase) else VarBase(np.asarray(t))
                fv = f if isinstance(f, VarBase) else VarBase(np.asarray(f))
                blended.append(trace_op(
                    "where", {"Condition": pred, "X": tv, "Y": fv},
                    {})["Out"][0])
            elif t != f:
                num = (bool, int, float, np.integer, np.floating)
                if isinstance(t, num) and isinstance(f, num):
                    # differing plain scalars (break/continue flags,
                    # counters) become a run-time select
                    blended.append(trace_op(
                        "where", {"Condition": pred,
                                  "X": VarBase(np.asarray(t)),
                                  "Y": VarBase(np.asarray(f))},
                        {})["Out"][0])
                else:
                    raise TypeError(
                        f"to_static: a tensor-dependent `if` assigns a "
                        f"non-tensor value that differs between branches "
                        f"({t!r} vs {f!r}) — only tensors can be "
                        f"selected at runtime")
            else:
                blended.append(t)
        return tuple(blended)
    return t_fn(snap) if _jst_truth(pred) else f_fn(snap)


_suppress_capture = 0       # >0: trace_op runs eagerly and records nothing
_active_loop_bound = 0      # the StaticFunction's loop_max_iters in _trace


def _jst_truth(v):
    return bool(v._tensor.reshape(-1)[0]) if isinstance(v, VarBase) \
        else bool(v)


def _subtrace(fn, state_vbs):
    """Trace fn over fresh feed VarBases mirroring state_vbs: (capture,
    result). Builds the cond and body blocks of a tensor-dependent
    loop."""
    feeds = [VarBase(vb._tensor, stop_gradient=True) for vb in state_vbs]
    cap = _CaptureState()
    for f in feeds:
        cap.mark_feed(f)
    _capture_stack.append(cap)
    try:
        result = fn(feeds)
    finally:
        _capture_stack.pop()
    return cap, result


def _jst_while(cond_fn, body_fn, snap, flag_positions=()):
    """Run-time dispatch of a rewritten while/for loop: a Python
    predicate runs the plain loop (frozen into a capture); a tensor
    predicate under a capture records one bounded ``while_loop`` op, its
    bound ``loop_max_iters`` or ``max(2 * cnt, cnt + 8)`` for the traced
    input's count ``cnt``."""
    global _suppress_capture
    state = tuple(snap)
    capturing = bool(_capture_stack) and not _suppress_capture
    if capturing:
        # peek at the predicate without recording the test's ops twice
        _suppress_capture += 1
        try:
            pred0 = cond_fn(state)
        finally:
            _suppress_capture -= 1
    else:
        pred0 = cond_fn(state)
    if capturing and flag_positions and not isinstance(pred0, VarBase):
        # break/continue flags start as Python False, so the rewritten
        # predicate `not brk and <test>` can look Python-valued on
        # iteration 0 and turn into a tensor only once a tensor `if`
        # sets a flag: probe one iteration to find out (only for loops
        # with flags: a plain loop must not run its body once more)
        _suppress_capture += 1
        try:
            if _jst_truth(pred0):
                pred1 = cond_fn(tuple(body_fn(state)))
                if isinstance(pred1, VarBase):
                    pred0 = pred1
        finally:
            _suppress_capture -= 1
    if not capturing or not isinstance(pred0, VarBase):
        # a Python predicate (or eager mode): Python's semantics; under a
        # capture the iterations are frozen into the trace
        while _jst_truth(cond_fn(state)):
            state = tuple(body_fn(state))
        return state

    # a tensor-dependent loop: one while_loop op, its trip count decided
    # at run time
    from .tracer import trace_op

    # probe the loop eagerly (capture suppressed) on the example input:
    # it counts the trips for the default bound and finds the non-tensor
    # state the body changes (the desugared for-loop's counter), which
    # must become a tensor to be carried at run time
    bound = _active_loop_bound
    probe_limit = 10_000 if not bound else 16
    changed = set()

    def diff_positions(old, new):
        for j, (a, b) in enumerate(zip(old, new)):
            if isinstance(b, VarBase) or isinstance(a, _Missing):
                continue
            try:
                if isinstance(a, VarBase) or (a is not b and a != b):
                    changed.add(j)
            except Exception:       # an array's ambiguous truth etc.
                changed.add(j)

    _suppress_capture += 1
    try:
        # one unconditional probe of the body, so that an example input
        # with no trip still shows which numbers the body changes (a body
        # that fails outside the guard just skips the detection)
        try:
            diff_positions(state, tuple(body_fn(state)))
        except Exception:
            pass
        cnt, probe = 0, state
        while _jst_truth(cond_fn(probe)) and cnt < probe_limit:
            new = tuple(body_fn(probe))
            diff_positions(probe, new)
            probe = new
            cnt += 1
    finally:
        _suppress_capture -= 1
    if not bound:
        bound = max(2 * cnt, cnt + 8)
        warnings.warn(
            f"to_static: tensor-dependent loop bounded at {bound} "
            f"iterations (2x the traced input's {cnt}); pass "
            f"to_static(fn, loop_max_iters=N) to set the bound "
            f"explicitly", stacklevel=2)

    state = list(state)
    # break/continue flags are always tensors on this path: the probe
    # flips them only where the example input takes the branch
    for j in flag_positions:
        changed.add(j)
    for j in changed:
        v = state[j]
        if isinstance(v, VarBase):
            continue
        if isinstance(v, (bool, int, float, np.integer, np.floating)):
            state[j] = VarBase(np.asarray(v))
        else:
            raise TypeError(
                f"to_static: a tensor-dependent loop mutates "
                f"non-numeric state (position {j}: {v!r}) — only "
                f"tensors/numbers can be carried at runtime")
    state = tuple(state)
    # _Missing positions are the body's own temporaries (assigned every
    # trip before use): not carried; their value after the loop is
    # undefined on this path
    t_idx = [i for i, v in enumerate(state) if isinstance(v, VarBase)]
    if not t_idx:
        raise TypeError("to_static loop: tensor predicate but no tensor "
                        "loop state")
    state_vbs = [state[i] for i in t_idx]

    def run_cond(feeds):
        s = list(state)
        for i, f in zip(t_idx, feeds):
            s[i] = f
        return cond_fn(tuple(s))

    def run_body(feeds):
        s = list(state)
        for i, f in zip(t_idx, feeds):
            s[i] = f
        out = body_fn(tuple(s))
        for i, (a, b) in enumerate(zip(s, out)):
            if isinstance(b, VarBase) or isinstance(a, _Missing):
                continue
            if a is not b and a != b:
                raise TypeError(
                    f"to_static: a tensor-dependent loop changes "
                    f"non-tensor state (position {i}: {a!r} -> {b!r}) — "
                    f"only tensors can be carried at runtime")
        return [out[i] for i in t_idx]

    cap_c, pred = _subtrace(run_cond, state_vbs)
    if not isinstance(pred, VarBase):
        raise TypeError("to_static loop: predicate ceased to be a tensor "
                        "inside the sub-trace")
    cap_b, outs = _subtrace(run_body, state_vbs)
    carry_names = list(cap_b.feed_names)
    body_out_names = []
    for vb in outs:
        if not isinstance(vb, VarBase):
            # a carried position the body leaves a plain number (a
            # break/continue flag never set): a constant output var
            vb = VarBase(np.asarray(vb))
        name = cap_b.names.get(id(vb))
        if name is None:                  # a constant or external result
            name = cap_b.name_of(vb)
        body_out_names.append(name)
    # the cond block's feeds take the body's carry names in the op's env
    rename = dict(zip(cap_c.feed_names, carry_names))
    for op in cap_c.block.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
    cond_out = rename.get(cap_c.names[id(pred)], cap_c.names[id(pred)])

    ext = {}
    ext.update(cap_c.param_values)
    ext.update(cap_b.param_values)
    ext_names = list(ext)
    ext_vbs = [ext[n] for n in ext_names]
    res = trace_op(
        "while_loop",
        {"X": state_vbs, "Ext": ext_vbs},
        {"cond_block": cap_c.block, "body_block": cap_b.block,
         "carry_names": carry_names, "body_out_names": body_out_names,
         "ext_names": ext_names, "cond_out_name": cond_out,
         "grad_max_iters": int(bound)})["Out"]
    final = list(state)
    for i, vb in zip(t_idx, res):
        final[i] = vb
    return tuple(final)


def _transform_fn(fn):
    """fn with its `if`, `while` and `for ... in range` statements
    rewritten by _IfTransformer; the original on any source or compile
    problem (no source in a REPL, a closure)."""
    if fn.__closure__:
        return fn              # a closure cannot be rebuilt: keep it
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fdef = tree.body[0]
        # drop the decorators: this is the decorator
        fdef.decorator_list = []
        tr = _IfTransformer()
        tr.visit(fdef)
        if tr.counter == 0:
            return fn
        ast.fix_missing_locations(tree)
        code = compile(tree, f"<to_static {fn.__name__}>", "exec")

        # globals resolved live: a copy would freeze the module's globals
        # at decoration time (helpers defined later, monkeypatches)
        class _Globals(dict):
            def __missing__(self, k):
                return fn.__globals__[k]

        glb = _Globals()
        glb["_jst_if"] = _jst_if
        glb["_jst_while"] = _jst_while
        glb["_jst_peek"] = _jst_peek
        glb["_jst_not"] = _jst_not
        glb["_jst_or"] = _jst_or
        glb["_jst_and"] = _jst_and
        glb["__builtins__"] = fn.__globals__.get("__builtins__", __builtins__)
        loc: Dict[str, Any] = {}
        exec(code, glb, loc)
        new_fn = loc[fdef.name]
        new_fn.__defaults__ = fn.__defaults__
        new_fn.__kwdefaults__ = fn.__kwdefaults__
        return new_fn
    except (OSError, TypeError, SyntaxError, KeyError):
        return fn


@register_op("__jax_fn__", skip_infer_shape=True)
def _closure_op(ins, attrs):
    """An ad-hoc traced torch closure as an op (in memory only: it does
    not serialise). The reference's name for it."""
    res = attrs["fn"](*[v for v in ins.get("X", [])])
    if not isinstance(res, (list, tuple)):
        res = [res]
    return {"Out": list(res)}


class _CaptureState:
    def __init__(self):
        self.program = Program()
        self.block = self.program.global_block()
        self.names: Dict[int, str] = {}
        self.keep: List[VarBase] = []       # keeps the ids in names valid
        self.param_values: Dict[str, VarBase] = {}  # live persistables
        self.feed_names: List[str] = []
        self.closure_ops = 0

    def mark_feed(self, vb: VarBase) -> str:
        name = unique_name.generate("feed")
        self.block.create_var(name=name, shape=list(vb.shape),
                              dtype=dtype_name(vb.dtype), stop_gradient=True)
        self.names[id(vb)] = name
        self.keep.append(vb)
        self.feed_names.append(name)
        return name

    def name_of(self, vb: VarBase) -> str:
        key = id(vb)
        if key in self.names:
            return self.names[key]
        self.keep.append(vb)
        # a parameter keeps its name; any other tensor made outside the
        # trace is captured by (live) reference as a persistable too
        name = vb.name if vb.persistable else unique_name.generate("captured")
        self.block.create_var(name=name, shape=list(vb.shape),
                              dtype=dtype_name(vb.dtype), persistable=True)
        self.param_values[name] = vb
        self.names[key] = name
        return name

    def bind_outputs(self, out_vars: Dict[str, List[Optional[VarBase]]],
                     op_type: str) -> Dict[str, List[str]]:
        outputs: Dict[str, List[str]] = {}
        for slot, vals in out_vars.items():
            names = []
            for vb in vals:
                if vb is None:
                    names.append(EMPTY_VAR)
                    continue
                name = unique_name.generate(f"{op_type}.cap")
                self.block.create_var(name=name, shape=list(vb.shape),
                                      dtype=dtype_name(vb.dtype))
                self.names[id(vb)] = name
                self.keep.append(vb)
                names.append(name)
            outputs[slot] = names
        return outputs


def capture_op(op_type: str, norm_inputs, attrs, out_vars):
    """Record an op that has just run eagerly into the innermost capture
    (called by the tracer's ``trace_op`` and ``trace_fn``)."""
    if not _capture_stack or _suppress_capture:
        return
    cap = _capture_stack[-1]
    inputs: Dict[str, List[str]] = {}
    for slot, vals in norm_inputs.items():
        inputs[slot] = [EMPTY_VAR if v is None else cap.name_of(v)
                        for v in vals]
    outputs = cap.bind_outputs(out_vars, op_type)
    if op_type == "__jax_fn__":
        cap.closure_ops += 1
    cap.block.append_op(op_type, inputs, outputs, dict(attrs),
                        infer_shape=False)


class ConcreteProgram:
    """One traced (program, feeds, fetches, parameters) per input
    signature (reference: partial_program.py PartialProgramLayer)."""

    def __init__(self, cap: _CaptureState, fetch_names: List[str], treedef):
        self.program = cap.program
        self.feed_names = list(cap.feed_names)
        self.fetch_names = list(fetch_names)
        self.param_values = dict(cap.param_values)
        self.closure_ops = cap.closure_ops
        self.treedef = treedef
        self.param_names = list(self.param_values)

    def __call__(self, arg_vbs: List[VarBase]):
        from .tracer import trace_op

        # one run_program op on the tape (reference: run_program_op.cc
        # through partial_program.py): the captured program runs as one
        # op, whose backward is the block's
        param_vbs = [self.param_values[n] for n in self.param_names]
        outs = trace_op("run_program",
                        {"X": arg_vbs, "Params": param_vbs},
                        {"program": self.program,
                         "feed_names": self.feed_names,
                         "param_names": self.param_names,
                         "fetch_names": self.fetch_names})["Out"]
        return self.treedef(outs)


class ProgramTranslator:
    """reference: program_translator.py:691 — the global switch."""

    _instance: Optional["ProgramTranslator"] = None

    def __init__(self):
        self.enable_to_static = True

    @classmethod
    def get_instance(cls) -> "ProgramTranslator":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, flag: bool):
        self.enable_to_static = bool(flag)


def _sig_of(args) -> tuple:
    sig = []
    for a in args:
        if isinstance(a, VarBase):
            sig.append(("vb", tuple(a.shape), dtype_name(a.dtype)))
        elif isinstance(a, np.ndarray):
            sig.append(("nd", a.shape, str(a.dtype)))
        elif isinstance(a, (int, float, bool, str, bytes, type(None))):
            sig.append(("py", a))
        else:
            # any other object (the Layer self): its identity, not its
            # repr, which distinct instances can share
            sig.append(("obj", id(a)))
    return tuple(sig)


class StaticFunction:
    """The @to_static wrapper: a trace on the first call of each input
    signature, then every call runs the captured block as one
    ``run_program`` op on the tape."""

    def __init__(self, fn, input_spec=None, loop_max_iters=0):
        self._fn = _transform_fn(fn)
        self._fn_original = fn
        self._input_spec = input_spec
        self._loop_max_iters = int(loop_max_iters or 0)
        self._cache: Dict[tuple, ConcreteProgram] = {}
        # a signature holds id(obj) for a non-tensor argument; keep those
        # objects alive so a reused id can never reach a stale entry
        self._sig_refs: Dict[tuple, list] = {}
        self._last: Optional[ConcreteProgram] = None
        functools.update_wrapper(self, fn)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        # one StaticFunction (and trace cache) per instance: a cache on
        # the class would key m1 and m2 to one ConcreteProgram and run m2
        # with m1's captured parameters
        key = "_sf_" + self._fn.__name__
        inst_sf = obj.__dict__.get(key)
        if inst_sf is None:
            inst_sf = StaticFunction(self._fn, self._input_spec,
                                     self._loop_max_iters)
            obj.__dict__[key] = inst_sf
        bound = functools.partial(inst_sf.__call__, obj)
        bound.__self__ = obj
        bound._static_function = inst_sf
        return bound

    def __call__(self, *args):
        if not ProgramTranslator.get_instance().enable_to_static:
            return self._fn(*args)
        tensor_idx = [i for i, a in enumerate(args)
                      if isinstance(a, (VarBase, np.ndarray))]
        vb_args = [a if isinstance(a, VarBase) else VarBase(a)
                   for a in (args[i] for i in tensor_idx)]
        sig = _sig_of(args)
        conc = self._cache.get(sig)
        if conc is None:
            conc = self._trace(args, tensor_idx, vb_args)
            self._cache[sig] = conc
            self._sig_refs[sig] = [
                a for a in args
                if not isinstance(a, (VarBase, np.ndarray, int, float, bool,
                                      str, bytes, type(None)))]
        self._last = conc
        return conc(vb_args)

    def _trace(self, args, tensor_idx, vb_args) -> ConcreteProgram:
        """Run the function eagerly under a new capture. Its results are
        dropped (the call runs the captured program after), so the trace
        records no autograd graph: the tracer's grad switch is off while
        it runs."""
        from .tracer import get_tracer

        cap = _CaptureState()
        for vb in vb_args:
            cap.mark_feed(vb)
        full_args = list(args)
        for i, vb in zip(tensor_idx, vb_args):
            full_args[i] = vb
        global _active_loop_bound
        tracer = get_tracer()
        had_grad = tracer.has_grad if tracer is not None else None
        _capture_stack.append(cap)
        prev_bound = _active_loop_bound
        _active_loop_bound = self._loop_max_iters
        try:
            if tracer is not None:
                tracer.has_grad = False
            result = self._fn(*full_args)
        finally:
            if tracer is not None:
                tracer.has_grad = had_grad
            _active_loop_bound = prev_bound
            _capture_stack.pop()
        flat, treedef = _flatten_result(result)
        fetch_names = []
        for vb in flat:
            name = cap.names.get(id(vb))
            if name is None:
                # an output that does not depend on the trace (a
                # constant): captured as one
                name = cap.name_of(vb)
            fetch_names.append(name)
        return ConcreteProgram(cap, fetch_names, treedef)

    # export surface -------------------------------------------------------
    @property
    def concrete_program(self) -> Optional[ConcreteProgram]:
        return self._last

    @property
    def main_program(self) -> Optional[Program]:
        return self._last.program if self._last else None


def _flatten_result(result):
    if isinstance(result, VarBase):
        return [result], (lambda outs: outs[0])
    if isinstance(result, (list, tuple)):
        ctor = type(result)
        if not all(isinstance(r, VarBase) for r in result):
            raise TypeError("to_static functions must return VarBase or "
                            "(nested) lists/tuples of VarBase")
        return list(result), (lambda outs: ctor(outs))
    raise TypeError(f"unsupported to_static return type {type(result)}")


def to_static(function=None, input_spec=None, loop_max_iters=0, **kwargs):
    """@paddle.jit.to_static (reference: jit.py declarative).

    ``loop_max_iters`` bounds tensor-dependent Python loops (the
    differentiable bounded loop needs a static trip bound); without it
    the bound is 2x the traced input's count (at least that count + 8)."""

    def deco(fn):
        return StaticFunction(fn, input_spec, loop_max_iters)

    if function is not None:
        return deco(function)
    return deco


declarative = to_static


def _concrete_of(layer_or_fn) -> ConcreteProgram:
    target = layer_or_fn
    if hasattr(target, "forward"):
        fwd = type(target).__dict__.get("forward")
        if isinstance(fwd, StaticFunction):
            inst_sf = target.__dict__.get("_sf_" + fwd._fn.__name__)
            conc = inst_sf.concrete_program if inst_sf else None
            if conc is None:
                raise RuntimeError(
                    "layer has not been called yet — run one forward pass "
                    "(or TracedLayer.trace) before jit.save")
            return conc
        raise TypeError("layer.forward is not decorated with @to_static — "
                        "use TracedLayer.trace instead")
    if isinstance(target, StaticFunction):
        conc = target.concrete_program
        if conc is None:
            raise RuntimeError("function has not been called yet — call it "
                               "once with example inputs before jit.save")
        return conc
    bound = getattr(target, "_static_function", None)
    if bound is not None:
        conc = bound.concrete_program
        if conc is None:
            raise RuntimeError("call the function once before jit.save")
        return conc
    raise TypeError(f"cannot jit.save a {type(target)}")


def save(layer_or_fn, path: str):
    """Export the traced program and the parameters' current values as
    an inference model directory (reference: jit.py save ->
    save_inference_model), in the format either package loads."""
    from .. import io
    from ..core.scope import Scope

    conc = _concrete_of(layer_or_fn)
    if conc.closure_ops:
        raise RuntimeError(
            f"traced program contains {conc.closure_ops} ad-hoc closure op(s) "
            f"(VarBase method calls like x.reshape()/x.sum()); these cannot "
            f"be serialised — build the model from paddle_tpu.nn / "
            f"dygraph layers for an exportable trace")
    scope = Scope()
    for name, vb in conc.param_values.items():
        scope.set(name, vb._tensor.detach())
    io.save_inference_model(path, conc.feed_names,
                            [conc.program.global_block().var(n)
                             for n in conc.fetch_names],
                            main_program=conc.program, scope=scope)
    return path


def load(path: str, device=None):
    """An exported model as a callable of numpy arrays or VarBases
    (reference: jit.py load -> TranslatedLayer; here the predictor).
    ``device`` as the predictor's (None: the card)."""
    from ..inference import AnalysisConfig, create_predictor

    pred = create_predictor(AnalysisConfig(path, device=device))

    def run(*arrays):
        feeds = {n: (a.numpy() if isinstance(a, VarBase) else np.asarray(a))
                 for n, a in zip(pred.get_input_names(), arrays)}
        outs = pred.run(feeds)
        return outs[0] if len(outs) == 1 else outs

    run.predictor = pred
    return run


class TracedLayer:
    """reference: dygraph/jit.py TracedLayer — a Layer traced once: a
    static callable and an export handle."""

    def __init__(self, conc: ConcreteProgram):
        self._conc = conc

    @staticmethod
    def trace(layer, inputs: Sequence[Any]):
        fwd = type(layer).__dict__.get("forward") \
            if hasattr(layer, "forward") else None
        if isinstance(fwd, StaticFunction):
            # forward is @to_static already: reuse its ConcreteProgram
            # (wrapping it again would capture one run_program op)
            out = layer(*inputs)
            return out, TracedLayer(_concrete_of(layer))
        sf = StaticFunction(layer.forward if hasattr(layer, "forward")
                            else layer)
        out = sf(*inputs)
        return out, TracedLayer(sf.concrete_program)

    def __call__(self, *inputs):
        vbs = [v if isinstance(v, VarBase) else VarBase(v) for v in inputs]
        return self._conc(vbs)

    def save_inference_model(self, path: str):
        sf = StaticFunction(lambda: None)
        sf._last = self._conc
        return save(sf, path)

    @property
    def program(self) -> Program:
        return self._conc.program
