"""IR passes: program rewrites applied before the backward is built.

The port of ``paddle_tpu/core/passes.py``: the registry
(``register_pass``, ``get_pass``, ``apply_passes`` :29-122) and
``fuse_bn_act_pass`` (:481). A pass maps Program -> Program, rewriting
block 0's op list in place. After each pass ``apply_passes`` drops the
VarDescs the pass orphaned, as the reference does, so both packages
serialise the same program. The reference's static verifier, which also
runs after each pass there, and its scope-dependent (weight-folding)
passes are not in the port.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from .ir import OpDesc, Program

PassFn = Callable[[Program], Program]

_PASS_REGISTRY: Dict[str, PassFn] = {}


def register_pass(name: str):
    def deco(fn: PassFn) -> PassFn:
        _PASS_REGISTRY[name] = fn
        return fn

    return deco


def get_pass(name: str) -> PassFn:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"unknown pass '{name}'; have {sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name]


def _string_refs(val, out: Set[str]):
    """Every string reachable through list/tuple/dict attr values."""
    if isinstance(val, str):
        out.add(val)
    elif isinstance(val, dict):
        for v in val.values():
            _string_refs(v, out)
    elif isinstance(val, (list, tuple)):
        for v in val:
            _string_refs(v, out)


def _referenced_names(program: Program) -> Set[str]:
    """Every var name an op references: its io slots and, over-
    approximately, any string in its attrs."""
    names: Set[str] = set()
    for blk in program.blocks:
        for op in blk.ops:
            names.update(op.input_names())
            names.update(op.output_names())
            for val in (op.attrs or {}).values():
                _string_refs(val, names)
    return names


def _prune_orphaned_vars(program: Program, before: Set[str]):
    """Drop the non-persistable VarDescs a pass just disconnected:
    referenced before it, referenced by nothing after it."""
    after = _referenced_names(program)
    for blk in program.blocks:
        for name in [n for n in blk.vars if n in before and n not in after
                     and not blk.vars[n].desc.persistable]:
            del blk.vars[name]


def apply_passes(program: Program, names: List[str]) -> Program:
    """Apply the named passes in order, pruning after each one the
    VarDescs it orphaned."""
    for n in names:
        before = _referenced_names(program)
        program = get_pass(n)(program)
        _prune_orphaned_vars(program, before)
    return program


def _single_consumer_map(ops: List[OpDesc]) -> Dict[str, List[OpDesc]]:
    consumers: Dict[str, List[OpDesc]] = {}
    for op in ops:
        for name in op.input_names():
            consumers.setdefault(name, []).append(op)
    return consumers


def _out(op: OpDesc, slot: str) -> Optional[str]:
    v = op.outputs.get(slot)
    return v[0] if v else None


def _in(op: OpDesc, slot: str) -> Optional[str]:
    v = op.inputs.get(slot)
    return v[0] if v else None


@register_pass("fuse_bn_act_pass")
def fuse_bn_act_pass(program: Program) -> Program:
    """Training-time batch_norm(+elementwise_add)+relu -> one
    fused_bn_add_act op. Run before append_backward, so the fused op's
    pinned-residual backward owns the whole segment.

    Patterns (Y consumed once at every hop, training-mode BN only):
      batch_norm -> relu
      batch_norm -> elementwise_add (either operand order) -> relu
    """
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    dead = set()
    # the fused op goes where the relu was: the residual Z of the add may
    # be produced between the bn and the relu (the shortcut branch)
    fused_at: Dict[int, OpDesc] = {}
    for op in block.ops:
        if op.type != "batch_norm" or op.attrs.get("is_test", False) \
                or op.attrs.get("use_global_stats", False):
            continue
        y = _out(op, "Y")
        cons = consumers.get(y, [])
        nxt = cons[0] if len(cons) == 1 else None
        if nxt is None or id(nxt) in dead:
            continue    # (dead: absorbed by an earlier match, e.g. the
        z = None        # other bn feeding the same residual add)
        add_op = None
        if nxt.type == "elementwise_add" and \
                int(nxt.attrs.get("axis", -1)) in (-1, 0):
            other = _in(nxt, "Y") if _in(nxt, "X") == y else _in(nxt, "X")
            cons2 = consumers.get(_out(nxt, "Out"), [])
            relu = cons2[0] if len(cons2) == 1 and \
                cons2[0].type == "relu" and id(cons2[0]) not in dead \
                else None
            if relu is None:
                continue
            add_op, z, nxt = nxt, other, relu
        if nxt.type != "relu":
            continue
        inputs = dict(op.inputs)
        if z is not None:
            inputs["Z"] = [z]
        outputs = dict(op.outputs)
        outputs["Y"] = [_out(nxt, "Out")]
        fused_at[id(nxt)] = OpDesc("fused_bn_add_act", inputs, outputs,
                                   {**op.attrs, "act": "relu"})
        dead.update((id(op), id(nxt)))
        if add_op is not None:
            dead.add(id(add_op))

    new_ops: List[OpDesc] = []
    for op in block.ops:
        if id(op) in fused_at:
            new_ops.append(fused_at[id(op)])
        elif id(op) not in dead:
            new_ops.append(op)
    block.ops = new_ops
    return program
