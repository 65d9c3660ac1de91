"""Program-level autodiff: append grad ops to the program.

The port of ``paddle_tpu/core/backward.py`` (``append_backward`` :126,
``_GradAccumulator`` :65, ``gradients`` :242): walk the forward ops in
reverse, ask each op's grad maker for grad op-descs, insert ``@GRAD``
vars, sum duplicated gradients, honour stop_gradient / no_grad_set. A
pure IR transform with no tensor code: both packages append the same ops
and vars to the same program.

Gradients are ops in the program. The default grad op is the generic
``__vjp_grad__`` (registry.py), whose lowering re-runs the forward
lowering under autograd; eager PyTorch does not merge that recompute
with the forward op as a compiler's CSE would.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import registry, unique_name
from .ir import Block, OpDesc, OpRole, Parameter, Program, Variable
from .types import dtype_name

GRAD_SUFFIX = "@GRAD"


def _grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


# Ops that are never differentiated through.
_NON_DIFF_OPS = {
    "fill_constant", "gaussian_random", "uniform_random", "feed", "fetch",
    "save", "load", "accuracy", "auc", "print", "assign_value", "shape",
    "c_comm_init", "c_gen_unique_id", "truncated_gaussian_random",
    "randint", "iota", "one_hot", "argmax", "argmin", "equal", "not_equal",
    "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "update_loss_scaling", "check_finite_and_unscale", "isfinite",
}


def _requires_grad_vars(block: Block, ops: List[OpDesc], no_grad: Set[str],
                        extra_leaves: Set[str] = frozenset()) -> Set[str]:
    """Forward-propagate the requires-grad property from trainable leaves."""
    req: Set[str] = set(extra_leaves) - no_grad
    for var in block.vars.values():
        if isinstance(var, Parameter) and var.trainable and var.name not in no_grad:
            req.add(var.name)
    for op in ops:
        if op.type in _NON_DIFF_OPS:
            continue
        if any(n in req for n in op.input_names()):
            for n in op.output_names():
                if n in no_grad:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and v.stop_gradient:
                    continue
                req.add(n)
    return req


class _GradAccumulator:
    """Collects gradient contributions per forward var; emits `sum` ops when a
    var has fan-out >1 (reference: backward.py _addup_repetitive_outputs_)."""

    def __init__(self, block: Block):
        self.block = block
        self.contribs: Dict[str, List[str]] = {}
        self.final: Dict[str, str] = {}

    def new_contrib_name(self, var_name: str) -> str:
        lst = self.contribs.setdefault(var_name, [])
        base = _grad_name(var_name)
        name = base if not lst else f"{base}@RENAME@{len(lst)}"
        lst.append(name)
        return name

    def set_final(self, var_name: str, grad_name: str):
        self.final[var_name] = grad_name
        self.contribs.setdefault(var_name, []).append(grad_name)

    def finalize(self, var_name: str) -> Optional[str]:
        """Called when the op PRODUCING var_name is reached in the reverse
        walk — all consumers are already processed, so sum now."""
        if var_name in self.final:
            return self.final[var_name]
        lst = self.contribs.get(var_name, [])
        if not lst:
            return None
        if len(lst) == 1:
            self.final[var_name] = lst[0]
            return lst[0]
        out = _grad_name(var_name)
        if out in lst:  # avoid summing a name into itself
            renamed = f"{out}@RENAME@0x"
            src_var = self.block._find_var_recursive(out)
            self.block.create_var(name=renamed,
                                  shape=src_var.shape if src_var else None,
                                  dtype=src_var.dtype if src_var else "float32",
                                  stop_gradient=True)
            for op in reversed(self.block.ops):
                if out in op.output_names():
                    op._rename_output(out, renamed)
                    break
            lst = [renamed if n == out else n for n in lst]
        self.block.create_var(name=out, stop_gradient=True)
        self.block.append_op("sum", {"X": lst}, {"Out": [out]},
                             {"op_role": OpRole.Backward})
        self.final[var_name] = out
        return out


def _ensure_grad_var(block: Block, fwd_name: str, grad_name: str):
    if grad_name == registry.EMPTY_VAR or block.has_var(grad_name):
        return
    fwd = block._find_var_recursive(fwd_name)
    block.create_var(name=grad_name,
                     shape=fwd.shape if fwd is not None else None,
                     dtype=fwd.dtype if fwd is not None else "float32",
                     stop_gradient=True)


def append_backward(loss: Variable, parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None, checkpoints=None,
                    _extra_leaves: Set[str] = frozenset()) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for `loss` and return [(param, grad_var), ...].

    Reference: python/paddle/fluid/backward.py:1275.
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    loss_idx = None
    for i in range(len(block.ops) - 1, -1, -1):
        if loss.name in block.ops[i].output_names():
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError(f"loss var '{loss.name}' is not produced by any op")

    fwd_ops = block.ops[: loss_idx + 1]
    req = _requires_grad_vars(block, fwd_ops, no_grad, _extra_leaves)
    if loss.name not in req:
        raise ValueError(
            f"loss '{loss.name}' does not depend on any trainable parameter")

    acc = _GradAccumulator(block)
    with program._role_guard(OpRole.Backward):
        # d(loss)/d(loss) = 1
        loss_grad = _grad_name(loss.name)
        block.create_var(name=loss_grad, shape=loss.shape or (1,),
                         dtype=loss.dtype, stop_gradient=True)
        block.append_op(
            "fill_constant", {}, {"Out": [loss_grad]},
            {"shape": list(loss.shape or (1,)), "value": 1.0,
             "dtype": dtype_name(loss.dtype),
             "op_role": OpRole.Backward | OpRole.Loss})
        acc.set_final(loss.name, loss_grad)

        for op in reversed(fwd_ops):
            if op.type in _NON_DIFF_OPS or op.is_optimize_op():
                continue
            opdef = registry.lookup(op.type)
            if opdef is None:
                continue
            # finalize output grads (all consumers already visited)
            out_grads: Dict[str, List[Optional[str]]] = {}
            any_grad = False
            for slot, names in op.outputs.items():
                gs = []
                for n in names:
                    g = acc.finalize(n) if n in req else None
                    gs.append(g)
                    any_grad = any_grad or (g is not None)
                out_grads[slot] = gs
            if not any_grad:
                continue
            # decide which input grads to produce
            in_grads: Dict[str, List[Optional[str]]] = {}
            for slot, names in op.inputs.items():
                if slot in (opdef.non_diff_inputs or ()):
                    in_grads[slot] = [None] * len(names)
                    continue
                gs = []
                for n in names:
                    if n in req and n not in no_grad:
                        gs.append(acc.new_contrib_name(n))
                    else:
                        gs.append(None)
                in_grads[slot] = gs
            if all(g is None for gs in in_grads.values() for g in gs):
                continue
            maker = opdef.grad_maker or registry.default_grad_maker
            grad_ops = maker(op, out_grads, in_grads)
            for gop in grad_ops:
                gop.attrs.setdefault("op_role", OpRole.Backward)
                for slot, names in gop.outputs.items():
                    for gn in names:
                        # map grad var desc from its forward var when derivable
                        fwd_guess = gn.split(GRAD_SUFFIX)[0]
                        _ensure_grad_var(block, fwd_guess, gn)
                for slot, names in gop.inputs.items():
                    for gn in names:
                        if gn != registry.EMPTY_VAR and not block.has_var(gn):
                            _ensure_grad_var(block, gn.split(GRAD_SUFFIX)[0], gn)
                block.ops.append(gop)

    # assemble (param, grad) pairs
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(str(p))
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    result = []
    # finalize leaf inputs requested via gradients() so fan-out sums are emitted
    for name in _extra_leaves:
        acc.finalize(name)
    for name, gname in acc.final.items():
        program.grad_var_map.setdefault(name, gname)
    for p in params:
        g = acc.finalize(p.name)
        if g is None:
            continue
        program.grad_var_map[p.name] = g
        gvar = block.var(g)
        # record param↔grad on the producing op (reference: op_role_var attr,
        # used by DP rewrites to place allreduce)
        for op in reversed(block.ops):
            if g in op.output_names():
                op.attrs.setdefault("op_role_var", []).extend([p.name, g])
                break
        result.append((p, gvar))
    return result


def gradients(targets: Sequence[Variable], inputs: Sequence[Variable],
              target_gradients: Optional[Sequence[Variable]] = None,
              no_grad_set: Optional[Set[str]] = None) -> List[Optional[Variable]]:
    """paddle.static.gradients — grads of targets wrt inputs.

    Reference: backward.py:1864 / calc_gradient:1728. Implemented by running
    append_backward on a summed scalar of targets when target_gradients is
    None; custom target grads seed the accumulator instead of fill 1.
    """
    if not targets:
        return []
    t0 = targets[0]
    block = t0.block
    if target_gradients is None and (t0.shape is None or int(np.prod([d for d in (t0.shape or (1,)) if d != -1])) != 1 or len(targets) > 1):
        from .. import layers

        total = None
        for t in targets:
            s = layers.reduce_sum(t)
            total = s if total is None else total + s
        t0 = total
    append_backward(t0, parameter_list=[], no_grad_set=no_grad_set,
                    _extra_leaves={iv.name for iv in inputs})
    out = []
    for iv in inputs:
        g = block.program.grad_var_map.get(iv.name)
        if g is None:
            gname = _grad_name(iv.name)
            g = gname if block.has_var(gname) else None
        out.append(block.var(g) if g else None)
    return out
