"""IR passes: program rewrites (port of ``paddle_tpu/core/passes.py``).

A pass maps Program -> Program, rewriting block 0's op list in place.
The registry holds the reference's eight passes: the seven of the
inference predictor (``inference/predictor.py`` ``DEFAULT_PASSES``) and
the training-time ``fuse_bn_act_pass``. ``apply_passes`` runs them in
order and, after each one (``FLAGS_verify_passes``), drops the VarDescs
the pass orphaned and runs the static verifier (``core/verify.py``), so
a pass that corrupts the program raises a ``ProgramVerifyError`` naming
it. A pass with a ``scope`` parameter (``conv_bn_fuse_pass``, which
folds weights) gets the parameter store; the others take the program
alone. Each pass leaves the program JSON the reference's pass leaves.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Set

import numpy as np
import torch

from . import telemetry
from .flags import flag as _flag
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


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def _referenced_names(program: Program) -> Set[str]:
    """Every var name an op references: its io slots and, over-
    approximately, any string in its attrs (fusion_group's sub_ops io
    keeps its vars alive)."""
    from .verify import VerifyContext

    return VerifyContext(program).referenced


def _prune_orphaned_vars(program: Program, before: Set[str],
                         keep: Set[str]) -> int:
    """Drop the non-persistable VarDescs a pass just disconnected:
    referenced before it, referenced by nothing after it, and not in
    ``keep`` (the feeds and fetches). A declaration no op referenced
    before the pass (an unused feed) is left alone."""
    after = _referenced_names(program)
    pruned = 0
    for blk in program.blocks:
        for name in [n for n in blk.vars
                     if n in before and n not in after and n not in keep
                     and not blk.vars[n].desc.persistable]:
            del blk.vars[name]
            pruned += 1
    if pruned:
        telemetry.counter_add("verifier.pruned_vars", pruned)
    return pruned


def apply_passes(program: Program, names: List[str], scope=None,
                 feed_names=None, fetch_names=None,
                 verify: Optional[bool] = None) -> Program:
    """Apply the named passes in order, verifying the program after each
    one: orphaned VarDescs are pruned, then ``verify_program`` runs with
    the feed and fetch names when the caller knows them (the predictor
    does) and raises naming the pass. ``verify=None`` follows
    ``FLAGS_verify_passes``; ``verify=False`` neither prunes nor checks,
    as in the reference."""
    if verify is None:
        verify = bool(_flag("verify_passes"))
    keep = set(feed_names or ()) | {str(f) for f in (fetch_names or ())}
    for n in names:
        fn = get_pass(n)
        before = _referenced_names(program) if verify else None
        if "scope" in inspect.signature(fn).parameters:
            program = fn(program, scope=scope)
        else:
            program = fn(program)
        if verify:
            from .verify import verify_program

            _prune_orphaned_vars(program, before, keep)
            verify_program(program, feed_names=feed_names,
                           fetch_names=fetch_names, scope=scope,
                           context=f"after pass '{n}'")
    return program


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _single_consumer_map(ops: List[OpDesc]) -> Dict[str, List[OpDesc]]:
    consumers: Dict[str, List[OpDesc]] = {}
    for op in ops:
        for name in op.input_names():
            consumers.setdefault(name, []).append(op)
    return consumers


def _producer_map(ops: List[OpDesc]) -> Dict[str, OpDesc]:
    prod: Dict[str, OpDesc] = {}
    for op in ops:
        for name in op.output_names():
            prod[name] = op
    return prod


def _out(op: OpDesc, slot: str) -> Optional[str]:
    v = op.outputs.get(slot)
    return v[0] if v else None


def _in(op: OpDesc, slot: str) -> Optional[str]:
    v = op.inputs.get(slot)
    return v[0] if v else None


def _host(v) -> np.ndarray:
    """A scope value (a tensor on any device, or an array) as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

@register_pass("delete_dropout_pass")
def delete_dropout_pass(program: Program) -> Program:
    """Strip is_test dropout ops (identity at inference) by rewiring their
    consumers (reference: ``core/passes.py:154``)."""
    block = program.global_block()
    rename: Dict[str, str] = {}
    kept: List[OpDesc] = []
    for op in block.ops:
        # apply pending renames to inputs first
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
        if op.type == "dropout" and bool(op.attrs.get("is_test", False)) and \
                op.attrs.get("dropout_implementation",
                             "upscale_in_train") == "upscale_in_train":
            rename[_out(op, "Out")] = _in(op, "X")
            continue
        kept.append(op)
    block.ops = kept
    return program


@register_pass("fc_fuse_pass")
def fc_fuse_pass(program: Program) -> Program:
    """mul/matmul_v2 + elementwise_add(bias) -> one fc op (reference:
    ``core/passes.py:176``)."""
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    fused_away = set()
    new_ops: List[OpDesc] = []
    for op in block.ops:
        if id(op) in fused_away:
            continue
        if op.type in ("mul", "matmul_v2") and not op.attrs.get("trans_x") \
                and not op.attrs.get("trans_y"):
            out = _out(op, "Out")
            cons = consumers.get(out, [])
            if len(cons) == 1 and cons[0].type == "elementwise_add":
                add = cons[0]
                bias_name = _in(add, "Y")
                bias_var = block.var(bias_name) \
                    if bias_name and block.has_var(bias_name) else None
                # only fuse a real bias: 1-D persistable parameter (the
                # reference fc_fuse_pass.cc requirement) — never a
                # residual-add of another activation tensor
                bias_ok = (bias_var is not None and bias_var.persistable
                           and len(bias_var.shape or ()) == 1)
                if bias_ok and _in(add, "X") == out and \
                        int(add.attrs.get("axis", -1)) in (-1, 1):
                    xname = _in(op, "X")
                    if op.type == "matmul_v2":
                        # batched matmul contracts only the last dim:
                        # flatten everything before it
                        xv = block.var(xname) if block.has_var(xname) else None
                        ncol = (len(xv.shape) - 1) if xv is not None and \
                            xv.shape and len(xv.shape) > 1 else 1
                    else:
                        ncol = op.attrs.get("x_num_col_dims", 1)
                    new_ops.append(OpDesc(
                        "fc",
                        {"Input": [xname], "W": [_in(op, "Y")],
                         "Bias": [_in(add, "Y")]},
                        {"Out": [_out(add, "Out")]},
                        {"in_num_col_dims": ncol}))
                    fused_away.add(id(add))
                    continue
        new_ops.append(op)
    block.ops = new_ops
    return program


@register_pass("conv_bn_fuse_pass")
def conv_bn_fuse_pass(program: Program, scope=None) -> Program:
    """conv2d -> batch_norm(is_test) folded into one conv + a bias add
    (reference: ``core/passes.py:226``). Batch norm at inference is an
    affine map per channel, y = k conv(x) + c with k = scale /
    sqrt(var + eps) and c = bias - mean k, so the filter absorbs k (its
    out-channel axis) and c becomes a bias. The fold reads the weights'
    values, so it needs the predictor's scope and does nothing without
    one; it computes in float32 numpy, as the reference does, and puts
    the folded tensors on the filter's device."""
    if scope is None:
        return program
    from . import unique_name

    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    dead = set()
    new_ops: List[OpDesc] = []
    for op in block.ops:
        if id(op) in dead:
            continue
        if op.type == "conv2d" and int(op.attrs.get("groups", 1) or 1) == 1:
            out = _out(op, "Output")
            cons = consumers.get(out, [])
            bn = cons[0] if len(cons) == 1 and \
                cons[0].type in ("batch_norm", "sync_batch_norm") else None
            if bn is not None and (bool(bn.attrs.get("is_test", False))
                                   or bool(bn.attrs.get(
                                       "use_global_stats", False))):
                names = {s: _in(bn, s)
                         for s in ("Scale", "Bias", "Mean", "Variance")}
                w_name = _in(op, "Filter")
                vals = {s: scope.find_var(n) for s, n in names.items()}
                w = scope.find_var(w_name)
                if w is not None and all(v is not None
                                         for v in vals.values()):
                    eps = float(bn.attrs.get("epsilon", 1e-5))
                    host = {s: _host(v) for s, v in vals.items()}
                    w_host = _host(w)
                    k = host["Scale"].astype(np.float32) / np.sqrt(
                        host["Variance"].astype(np.float32) + eps)
                    new_w = (w_host.astype(np.float32)
                             * k[:, None, None, None]).astype(w_host.dtype)
                    new_b = (host["Bias"].astype(np.float32)
                             - host["Mean"].astype(np.float32) * k)
                    wf_name = unique_name.generate(w_name + "@bn_fused")
                    bf_name = unique_name.generate(w_name + "@bn_bias")
                    wv = block.var(w_name)
                    block.create_parameter(name=wf_name,
                                           shape=tuple(wv.shape),
                                           dtype=str(wv.dtype))
                    block.create_parameter(name=bf_name,
                                           shape=(len(new_b),),
                                           dtype="float32")
                    dev = w.device if isinstance(w, torch.Tensor) else "cpu"
                    scope.set(wf_name, torch.from_numpy(new_w).to(dev))
                    scope.set(bf_name, torch.from_numpy(
                        new_b.astype(np.float32)).to(dev))
                    conv_out = block.create_var(
                        name=unique_name.generate(out + "@fused"),
                        shape=tuple(block.var(out).shape)
                        if block.has_var(out) else None)
                    fused_conv = OpDesc(
                        "conv2d",
                        {"Input": op.inputs["Input"], "Filter": [wf_name]},
                        {"Output": [conv_out.name]}, dict(op.attrs))
                    y = _out(bn, "Y")
                    new_ops.append(fused_conv)
                    new_ops.append(OpDesc(
                        "elementwise_add",
                        {"X": [conv_out.name], "Y": [bf_name]},
                        {"Out": [y]}, {"axis": 1}))
                    dead.add(id(bn))
                    continue
        new_ops.append(op)
    block.ops = new_ops
    return program


@register_pass("embedding_eltwise_layernorm_fuse_pass")
def embedding_eltwise_layernorm_fuse_pass(program: Program) -> Program:
    """N lookup_table_v2 ops summed, then layer_norm'd (the BERT
    embedding stack) -> one fused_embedding_eltwise_layernorm op
    (reference: ``core/passes.py:305``)."""
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    producer = _producer_map(block.ops)
    dead = set()
    new_ops: List[OpDesc] = []

    def as_lookup(name):
        # v2 only (v1 squeezes a trailing ids dim the fused op doesn't);
        # padding_idx zeroes rows in the unfused op — the fused lowering
        # has no mask, so those lookups must stay unfused
        op = producer.get(name)
        if op is not None and op.type == "lookup_table_v2" and \
                int(op.attrs.get("padding_idx", -1)) < 0 and \
                len(consumers.get(name, [])) == 1:
            return op
        return None

    for op in block.ops:
        if id(op) in dead:
            continue
        # anchor on layer_norm; walk the add tree beneath it
        if op.type == "layer_norm" and \
                int(op.attrs.get("begin_norm_axis", 1)) == 2:
            chain = []
            ids, embs = [], []

            def collect(name):
                lk = as_lookup(name)
                if lk is not None:
                    ids.append(lk.inputs["Ids"][0])
                    embs.append(lk.inputs["W"][0])
                    chain.append(lk)
                    return True
                add = producer.get(name)
                if add is not None and add.type == "elementwise_add" and \
                        len(consumers.get(name, [])) == 1:
                    if collect(_in(add, "X")) and collect(_in(add, "Y")):
                        chain.append(add)
                        return True
                return False

            has_affine = bool(op.inputs.get("Scale")) and \
                bool(op.inputs.get("Bias"))
            if has_affine and collect(_in(op, "X")) and len(ids) >= 2:
                # scale=False/shift=False layer_norms are left unfused —
                # the fused lowering requires the affine pair
                new_ops.append(OpDesc(
                    "fused_embedding_eltwise_layernorm",
                    {"Ids": list(ids), "Embs": list(embs),
                     "Scale": op.inputs["Scale"],
                     "Bias": op.inputs["Bias"]},
                    {"Out": [_out(op, "Y")]},
                    {"epsilon": op.attrs.get("epsilon", 1e-5)}))
                dead.update(id(o) for o in chain)
                continue
        new_ops.append(op)
    block.ops = [o for o in new_ops if id(o) not in dead]
    return program


@register_pass("fuse_elewise_add_act_pass")
def fuse_elewise_add_act_pass(program: Program) -> Program:
    """elementwise_add -> relu/gelu/tanh/sigmoid becomes one
    fused_elemwise_activation op (reference: ``core/passes.py:372``)."""
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    dead = set()
    new_ops: List[OpDesc] = []
    acts = ("relu", "gelu", "tanh", "sigmoid")
    for op in block.ops:
        if id(op) in dead:
            continue
        if op.type == "elementwise_add" and \
                int(op.attrs.get("axis", -1)) == -1:
            out = _out(op, "Out")
            cons = consumers.get(out, [])
            if len(cons) == 1 and cons[0].type in acts:
                act = cons[0]
                # carry the act op's attrs so e.g. gelu(approximate=...)
                # keeps its exact numerics through the fuse
                fattrs = dict(act.attrs)
                fattrs.pop("op_role", None)
                fattrs["functor_list"] = ["elementwise_add", act.type]
                new_ops.append(OpDesc(
                    "fused_elemwise_activation",
                    {"X": op.inputs["X"], "Y": op.inputs["Y"]},
                    {"Out": [_out(act, "Out")],
                     "IntermediateOut": [out]},
                    fattrs))
                dead.add(id(act))
                continue
        new_ops.append(op)
    block.ops = new_ops
    return program


@register_pass("multihead_attention_fuse_pass")
def multihead_attention_fuse_pass(program: Program) -> Program:
    """matmul(Q K^T, alpha) [+ bias] -> softmax [-> dropout] -> matmul(V)
    becomes one flash_attention op (reference: ``core/passes.py:411``),
    which runs the port's flash forward kernel in the bnsd layout
    (``csrc/flash_attention_fwd.cu``). The op carries no num_heads:
    ``_flash_args`` reads the 4-D layout from q."""
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    dead = set()
    new_ops: List[OpDesc] = []

    def only_consumer(name, op_type):
        cons = [c for c in consumers.get(name, [])]
        if len(cons) == 1 and cons[0].type == op_type:
            return cons[0]
        return None

    for op in block.ops:
        if id(op) in dead:
            continue
        # anchor: the scores matmul q @ k^T
        if op.type == "matmul" and op.attrs.get("transpose_Y") and \
                not op.attrs.get("transpose_X"):
            q, k = _in(op, "X"), _in(op, "Y")
            scale = float(op.attrs.get("alpha", 1.0))
            scores = _out(op, "Out")
            bias = None
            cur = op
            nxt = only_consumer(scores, "elementwise_add")
            if nxt is not None:
                bias = _in(nxt, "Y") if _in(nxt, "X") == scores else _in(nxt, "X")
                scores = _out(nxt, "Out")
                cur = nxt
            sm = only_consumer(scores, "softmax")
            if sm is None or int(sm.attrs.get("axis", -1)) != -1:
                new_ops.append(op)
                continue
            probs = _out(sm, "Out")
            chain = [op] if cur is op else [op, cur]
            chain.append(sm)
            drop = only_consumer(probs, "dropout")
            if drop is not None and bool(drop.attrs.get("is_test", False)) \
                    and drop.attrs.get("dropout_implementation",
                                       "upscale_in_train") == \
                    "upscale_in_train":  # downgrade_in_infer scales at test
                probs = _out(drop, "Out")
                chain.append(drop)
            ctx_mm = only_consumer(probs, "matmul")
            if ctx_mm is None or _in(ctx_mm, "X") != probs or \
                    ctx_mm.attrs.get("transpose_X") or \
                    ctx_mm.attrs.get("transpose_Y") or \
                    float(ctx_mm.attrs.get("alpha", 1.0)) != 1.0:
                new_ops.append(op)
                continue
            v = _in(ctx_mm, "Y")
            chain.append(ctx_mm)
            inputs = {"Q": [q], "K": [k], "V": [v]}
            if bias is not None:
                inputs["Bias"] = [bias]
            new_ops.append(OpDesc("flash_attention", inputs,
                                  {"Out": [_out(ctx_mm, "Out")]},
                                  {"scale": scale, "causal": False}))
            dead.update(id(o) for o in chain if o is not op)
            continue
        new_ops.append(op)
    block.ops = new_ops
    return program


@register_pass("fuse_bn_act_pass")
def fuse_bn_act_pass(program: Program) -> Program:
    """Training-time batch_norm(+elementwise_add)+relu -> one
    fused_bn_add_act op (reference: ``core/passes.py:481``). Run before
    append_backward, so the fused op's backward owns the whole segment.

    Patterns (Y consumed once at every hop, training-mode BN only):
      batch_norm -> relu
      batch_norm -> elementwise_add (either operand order) -> relu
    """
    block = program.global_block()
    consumers = _single_consumer_map(block.ops)
    dead = set()
    # fused op INSERTS at the relu's position (the pattern's last op) —
    # a residual Z may be produced between the bn and the relu (the
    # shortcut branch), so replacing at the bn's position would read Z
    # before its producer runs
    fused_at: Dict[int, OpDesc] = {}
    for op in block.ops:
        if op.type != "batch_norm" or op.attrs.get("is_test", False) \
                or op.attrs.get("use_global_stats", False):
            continue
        y = _out(op, "Y")
        cons = consumers.get(y, [])
        nxt = cons[0] if len(cons) == 1 else None
        if nxt is None or id(nxt) in dead:
            continue            # (dead: chain absorbed by an earlier
        z = None                # match, e.g. the OTHER bn feeding the
        add_op = None           # same residual add)
        if nxt.type == "elementwise_add" and \
                int(nxt.attrs.get("axis", -1)) in (-1, 0):
            other = _in(nxt, "Y") if _in(nxt, "X") == y else _in(nxt, "X")
            add_out = _out(nxt, "Out")
            cons2 = consumers.get(add_out, [])
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
        fused_at[id(nxt)] = OpDesc(
            "fused_bn_add_act", inputs, outputs,
            {**{k: v for k, v in op.attrs.items()}, "act": "relu"})
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


# Ops safe to pack into a fusion_group: pure elementwise lowerings with
# no sub-blocks and no state. dropout is included: the group lowering
# threads __step__ through, so op by op each step draws its own mask.
_FUSION_GROUP_OPS = frozenset({
    "relu", "relu6", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt",
    "rsqrt", "square", "abs", "floor", "ceil", "round", "reciprocal",
    "softsign", "silu", "swish", "softplus", "logsigmoid", "sin", "cos",
    "erf", "sign", "leaky_relu", "elu", "hard_swish", "hard_sigmoid",
    "scale", "cast", "clip", "dropout",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
})


@register_pass("fusion_group_pass")
def fusion_group_pass(program: Program, min_size: int = 2) -> Program:
    """Pack maximal runs of consecutive elementwise ops into single
    fusion_group ops (reference: ``core/passes.py:564``). The run
    extends while the op is in ``_FUSION_GROUP_OPS``, shares the run's
    op_role and touches no persistable var; block order is topological,
    so grouping keeps it. Every var the run produces is exported: the
    program carries no fetch ops, so any of them may be a fetch target.
    The group's types need not be registered in the port: a group holding
    one that is not fails the structure check."""
    from .registry import EMPTY_VAR

    block = program.global_block()
    persistable = {v.name for v in block.vars.values() if v.persistable}

    def groupable(op):
        if op.type not in _FUSION_GROUP_OPS:
            return False
        names = [n for ns in list(op.inputs.values()) +
                 list(op.outputs.values()) for n in ns]
        return not any(n == EMPTY_VAR or n in persistable for n in names)

    runs: List[List[OpDesc]] = []
    cur: List[OpDesc] = []
    cur_role = None
    for op in block.ops:
        role = int(op.attrs.get("op_role", 0))
        if groupable(op) and (not cur or role == cur_role):
            cur.append(op)
            cur_role = role
        else:
            if len(cur) >= min_size:
                runs.append(cur)
            cur = [op] if groupable(op) else []
            cur_role = role if cur else None
    if len(cur) >= min_size:
        runs.append(cur)
    if not runs:
        return program

    replacements: Dict[int, OpDesc] = {}
    dead = set()
    for run in runs:
        members = {id(op) for op in run}
        produced: List[str] = []
        produced_set = set()
        ext_in: List[str] = []
        for op in run:
            for ns in op.inputs.values():
                for n in ns:
                    if n not in produced_set and n not in ext_in:
                        ext_in.append(n)
            for ns in op.outputs.values():
                for n in ns:
                    if n not in produced_set:
                        produced.append(n)
                        produced_set.add(n)
        ext_out = produced
        if not ext_out:
            continue
        sub_ops = [{"type": op.type,
                    "inputs": {s: list(ns) for s, ns in op.inputs.items()},
                    "outputs": {s: list(ns) for s, ns in op.outputs.items()},
                    "attrs": {k: v for k, v in op.attrs.items()
                              if k != "op_role"}}
                   for op in run]
        replacements[id(run[0])] = OpDesc(
            "fusion_group", {"X": ext_in}, {"Out": ext_out},
            {"sub_ops": sub_ops, "ext_in_names": ext_in,
             "ext_out_names": ext_out,
             "op_role": int(run[0].attrs.get("op_role", 0))})
        dead.update(members)

    new_ops: List[OpDesc] = []
    for op in block.ops:
        if id(op) in replacements:
            new_ops.append(replacements[id(op)])
        elif id(op) not in dead:
            new_ops.append(op)
    block.ops = new_ops
    return program
