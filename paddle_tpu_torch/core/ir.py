"""Program IR: Program ⊃ Block ⊃ {VarDesc, OpDesc}.

The port of ``paddle_tpu/core/ir.py``. Descs are the same plain,
JSON-serialisable dataclasses, and ``Program.to_dict``/``from_dict``
write and read the same JSON, so a program exported by ``paddle_tpu``
loads here and runs on torch lowerings.

Build-time shape/dtype inference runs the op's *torch lowering* on
``device="meta"`` tensors (the counterpart of ``jax.eval_shape``): meta
tensors carry shape and dtype but no storage, so inference allocates
nothing. Dynamic (-1) dims are found as in the reference, by evaluating
at two different sentinel substitutions.
"""

from __future__ import annotations

import contextlib
import copy
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import unique_name
from .types import (VarType, convert_dtype, dtype_name, to_torch_dtype,
                    x64_off)


class OpRole:
    """Op role taxonomy (reference: framework/op_proto_maker.h OpRole)."""

    Forward = 0
    Backward = 1
    Optimize = 2
    LRSched = 16
    Loss = 0x100


# two primes: an output dim that differs between the two inference runs
# depends on a dynamic input dim
_DYN_SENTINEL = 509
_DYN_SENTINEL_B = 521
_INFER_WARNED: set = set()
# the JSON form of a Block-valued attr: {BLOCK_REF: block index}
BLOCK_REF = "__block__"


def _json_attr(v):
    """An attr value as JSON takes it. A Block (``block_call``'s
    ``sub_block``, also inside a ``__vjp_grad__``'s ``fwd_attrs``) is
    written as ``{"__block__": idx}``, which ``Program.from_dict`` turns
    back into the program's block of that index."""
    if isinstance(v, Block):
        return {BLOCK_REF: v.idx}
    if isinstance(v, dict):
        return {k: _json_attr(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_json_attr(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.dtype):
        return str(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


@dataclass
class VarDesc:
    """Variable metadata (reference: framework.proto VarDesc:165)."""

    name: str
    shape: Optional[tuple] = None  # None = unknown; -1 = dynamic dim
    dtype: Any = np.float32
    type: VarType = VarType.DENSE_TENSOR
    persistable: bool = False
    stop_gradient: bool = False
    lod_level: int = 0
    is_parameter: bool = False
    trainable: bool = True
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.shape is not None:
            self.shape = tuple(int(d) for d in self.shape)
        self.dtype = convert_dtype(self.dtype)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": dtype_name(self.dtype),
            "type": self.type.value,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_parameter": self.is_parameter,
            "trainable": self.trainable,
            "attrs": {k: _json_attr(v) for k, v in self.attrs.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "VarDesc":
        return VarDesc(
            name=d["name"],
            shape=tuple(d["shape"]) if d.get("shape") is not None else None,
            dtype=d.get("dtype", "float32"),
            type=VarType(d.get("type", "dense_tensor")),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            lod_level=d.get("lod_level", 0),
            is_parameter=d.get("is_parameter", False),
            trainable=d.get("trainable", True),
            attrs=dict(d.get("attrs", {})),
        )


class OpDesc:
    """One operator invocation (reference: framework.proto OpDesc:42).

    inputs/outputs map slot names to lists of variable names."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "callstack")

    def __init__(self, type: str, inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]],
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})
        # build-site stack, for errors raised while the op runs
        self.callstack = traceback.format_stack(limit=6)[:-2]

    def input_names(self) -> List[str]:
        return [n for names in self.inputs.values() for n in names]

    def output_names(self) -> List[str]:
        return [n for names in self.outputs.values() for n in names]

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def _rename_output(self, old: str, new: str):
        for slot in self.outputs:
            self.outputs[slot] = [new if n == old else n
                                  for n in self.outputs[slot]]

    @property
    def op_role(self) -> int:
        return self.attrs.get("op_role", OpRole.Forward)

    def is_backward_op(self) -> bool:
        return (self.op_role & 0xF) == OpRole.Backward

    def is_optimize_op(self) -> bool:
        return (self.op_role & 0xF) == OpRole.Optimize

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: _json_attr(v) for k, v in self.attrs.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "OpDesc":
        """The op of ``to_dict``, its ``__block__`` references left for
        ``Program.from_dict`` to resolve."""
        return OpDesc(d["type"], d["inputs"], d["outputs"],
                      d.get("attrs", {}))

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"Op({self.type}: {ins} -> {outs})"


class Variable:
    """Python handle to a VarDesc in a Block (reference: framework.py:924).

    The arithmetic operators inside a program build append elementwise
    ops to the variable's block (``a - b`` an ``elementwise_sub``,
    ``a ** b`` an ``elementwise_pow``, ...); a Python scalar operand
    becomes a ``fill_constant`` var. ``-a`` is a ``scale`` by -1, ``a @
    b`` a ``matmul``, the comparisons are ``less_than`` and its kin,
    ``a[...]`` a ``slice`` and ``a.astype(t)`` a ``cast``, as in the
    reference (``paddle_tpu/core/ir.py:235-300``)."""

    def __init__(self, block: "Block", desc: VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self) -> Optional[tuple]:
        return self.desc.shape

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    def astype(self, dtype) -> "Variable":
        from .. import layers

        return layers.cast(self, dtype)

    def _binary(self, other, op, reverse=False):
        from .. import layers

        return layers._elementwise_binary(self, other, op, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from .. import layers

        return layers.scale(self, scale=-1.0)

    def __matmul__(self, other):
        from .. import layers

        return layers.matmul(self, other)

    def _cmp(self, other, op):
        from .. import layers

        return layers._compare(self, other, op)

    def __lt__(self, other):
        return self._cmp(other, "less_than")

    def __le__(self, other):
        return self._cmp(other, "less_equal")

    def __gt__(self, other):
        return self._cmp(other, "greater_than")

    def __ge__(self, other):
        return self._cmp(other, "greater_equal")

    def __getitem__(self, idx):
        from .. import layers

        return layers._getitem(self, idx)

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")

    __str__ = __repr__


class Parameter(Variable):
    """Persistable, trainable variable (reference: framework.py:5116)."""

    def __init__(self, block: "Block", desc: VarDesc, trainable: bool = True):
        desc.persistable = True
        desc.is_parameter = True
        desc.trainable = trainable
        super().__init__(block, desc)

    @property
    def trainable(self) -> bool:
        return self.desc.trainable


class Block:
    """Ordered list of ops + var table (reference: framework.py:2507)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[OpDesc] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, name: Optional[str] = None, shape=None,
                   dtype="float32", type: VarType = VarType.DENSE_TENSOR,
                   persistable: bool = False, stop_gradient: bool = False,
                   lod_level: int = 0) -> Variable:
        name = name or unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        desc = VarDesc(name=name,
                       shape=tuple(shape) if shape is not None else None,
                       dtype=dtype, type=type, persistable=persistable,
                       stop_gradient=stop_gradient, lod_level=lod_level)
        var = Variable(self, desc)
        self.vars[name] = var
        return var

    def create_parameter(self, name: str, shape, dtype="float32",
                         trainable: bool = True) -> Parameter:
        desc = VarDesc(name=name, shape=tuple(shape), dtype=dtype,
                       persistable=True)
        param = Parameter(self, desc, trainable=trainable)
        self.vars[name] = param
        return param

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"Variable '{name}' not found in block "
                             f"{self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    @staticmethod
    def _normalize_io(io: Optional[Dict[str, Any]]) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for slot, vals in (io or {}).items():
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            names = []
            for v in vals:
                if isinstance(v, Variable):
                    names.append(v.name)
                elif isinstance(v, str):
                    names.append(v)
                else:
                    raise TypeError(f"bad io entry for slot {slot}: "
                                    f"{type(v)}")
            out[slot] = names
        return out

    def append_op(self, type: str, inputs: Optional[Dict] = None,
                  outputs: Optional[Dict] = None,
                  attrs: Optional[Dict] = None,
                  infer_shape: bool = True) -> OpDesc:
        op = OpDesc(type, self._normalize_io(inputs),
                    self._normalize_io(outputs), attrs)
        if "op_role" not in op.attrs:
            op.attrs["op_role"] = self.program._current_role
        dev = current_device()
        if dev is not None and "__device__" not in op.attrs:
            op.attrs["__device__"] = dev   # pipeline-stage tag
        self.ops.append(op)
        if infer_shape:
            self._infer_op_shapes(op)
        return op

    def _infer_op_shapes(self, op: OpDesc):
        """Build-time shape/dtype inference: run the op's torch lowering
        on meta tensors, at two sentinel substitutions of the dynamic
        dims. Best-effort, like the reference: a lowering that cannot
        run on meta leaves its outputs shapeless and warns once per op
        type. Dtypes follow the reference's 64-bit-off rule (int64 ->
        int32), so both packages record the same VarDescs."""
        from . import registry

        opdef = registry.lookup(op.type)
        if opdef is None or opdef.forward is None or opdef.skip_infer_shape:
            return
        ins_a: Dict[str, List[Any]] = {}
        ins_b: Dict[str, List[Any]] = {}
        has_dyn = False
        for slot, names in op.inputs.items():
            lst_a, lst_b = [], []
            for n in names:
                v = self._find_var_recursive(n)
                if v is None or v.shape is None:
                    return
                has_dyn = has_dyn or -1 in v.shape
                dt = x64_off(to_torch_dtype(v.dtype))
                lst_a.append(torch.empty(
                    [_DYN_SENTINEL if d == -1 else d for d in v.shape],
                    dtype=dt, device="meta"))
                lst_b.append(torch.empty(
                    [_DYN_SENTINEL_B if d == -1 else d for d in v.shape],
                    dtype=dt, device="meta"))
            ins_a[slot] = lst_a
            ins_b[slot] = lst_b
        try:
            with registry.creating_on("meta"):
                out_a = registry.normalize_outputs(
                    opdef.forward(ins_a, dict(op.attrs)))
                out_b = registry.normalize_outputs(
                    opdef.forward(ins_b, dict(op.attrs))) \
                    if has_dyn else out_a
        except Exception as e:
            if op.type not in _INFER_WARNED:
                _INFER_WARNED.add(op.type)
                warnings.warn(
                    f"infer_shape[{op.type}]: lowering raised on meta "
                    f"tensors ({type(e).__name__}: {e}); output shapes "
                    f"unknown", stacklevel=4)
            return
        for slot, names in op.outputs.items():
            vals_a, vals_b = out_a.get(slot), out_b.get(slot)
            if vals_a is None:
                continue
            for n, ta, tb in zip(names, vals_a, vals_b):
                v = self._find_var_recursive(n)
                if v is None or ta is None or ta.dim() != tb.dim():
                    continue
                v.desc.shape = tuple(
                    int(da) if da == db else -1
                    for da, db in zip(ta.shape, tb.shape))
                v.desc.dtype = convert_dtype(x64_off(ta.dtype))

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.desc.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def _load_dict(self, d: dict):
        for vd in d.get("vars", []):
            desc = VarDesc.from_dict(vd)
            if desc.is_parameter:
                self.vars[desc.name] = Parameter(self, desc,
                                                 trainable=desc.trainable)
            else:
                self.vars[desc.name] = Variable(self, desc)
        for od in d.get("ops", []):
            self.ops.append(OpDesc.from_dict(od))

    def __repr__(self):
        return (f"Block(idx={self.idx}, vars={len(self.vars)}, "
                f"ops={len(self.ops)})")


class Program:
    """A whole computation (reference: framework.py Program:3969).
    Block 0 is the global block."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0, -1)]
        self.current_block_idx = 0
        self.random_seed: int = 0
        self._current_role = OpRole.Forward
        # filled by append_backward: var name -> grad var name
        self.grad_var_map: Dict[str, str] = {}
        self._seed_counter = 0

    def next_op_seed(self) -> int:
        """Per-op RNG seed assigned at build time; the run folds in the
        global step, so random ops vary per run but stay reproducible."""
        self._seed_counter += 1
        return self.random_seed * 1000003 + self._seed_counter

    @contextlib.contextmanager
    def _role_guard(self, role: int):
        old = self._current_role
        self._current_role = role
        try:
            yield
        finally:
            self._current_role = old

    def all_parameters(self) -> List[Parameter]:
        return [p for blk in self.blocks for p in blk.all_parameters()]

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """A deep copy (reference: ``Program.clone``, ``core/ir.py:664``).
        ``for_test`` keeps only the forward ops, sets every ``is_test``
        attr and drops the non-persistable vars whose only producers went
        with the backward and optimizer ops."""
        p = Program()
        p.random_seed = self.random_seed
        p._seed_counter = self._seed_counter
        p.blocks = [Block(p, blk.idx, blk.parent_idx) for blk in self.blocks]
        # deepcopy's memo maps each block to the clone's block of its index,
        # so a Block-valued attr points into the clone
        memo = {id(blk): nb for blk, nb in zip(self.blocks, p.blocks)}
        for blk, nb in zip(self.blocks, p.blocks):
            for name, var in blk.vars.items():
                desc = copy.deepcopy(var.desc)
                nb.vars[name] = Parameter(nb, desc, trainable=var.trainable) \
                    if isinstance(var, Parameter) else Variable(nb, desc)
            for op in blk.ops:
                if for_test and (op.is_backward_op() or op.is_optimize_op()):
                    continue
                nop = OpDesc(op.type, op.inputs, op.outputs,
                             copy.deepcopy(op.attrs, dict(memo)))
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
        if not p.blocks:
            p.blocks = [Block(p, 0, -1)]
        if for_test:
            produced = {n for blk in self.blocks for op in blk.ops
                        for n in op.output_names()}
            refs, seen = set(), set()
            for nb in p.blocks:
                _collect_op_refs(nb.ops, refs, seen)
            for nb in p.blocks:
                for name in [n for n, v in nb.vars.items()
                             if n in produced and n not in refs
                             and not v.desc.persistable]:
                    del nb.vars[name]
        p.grad_var_map = dict(self.grad_var_map)
        return p

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block, child of the current one (or of ``parent_idx``),
        made current (reference: ``Program.create_block``)."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def to_dict(self) -> dict:
        return {
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd.get("parent_idx", -1))
            blk._load_dict(bd)
            p.blocks.append(blk)
        if not p.blocks:
            p.blocks = [Block(p, 0, -1)]
        for blk in p.blocks:     # every block exists: resolve references
            for op in blk.ops:
                op.attrs = _resolve_blocks(op.attrs, p)
        return p

    def __repr__(self):
        nops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


def _resolve_blocks(val, program: "Program"):
    """``val`` with every ``{"__block__": idx}`` replaced by the block."""
    if isinstance(val, dict):
        if len(val) == 1 and BLOCK_REF in val:
            return program.block(int(val[BLOCK_REF]))
        return {k: _resolve_blocks(v, program) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return type(val)(_resolve_blocks(v, program) for v in val)
    return val


def _collect_op_refs(ops, refs: set, seen: set):
    """Every var name the ops reference: their io slots and any string
    reachable through their attr values, recursing into the sub-blocks
    their attrs hold (reference: ``core/ir.py`` ``_collect_op_refs``)."""

    def scan(val):
        if isinstance(val, str):
            refs.add(val)
        elif isinstance(val, Block):
            if id(val) not in seen:
                seen.add(id(val))
                _collect_op_refs(val.ops, refs, seen)
        elif isinstance(val, dict):
            for v in val.values():
                scan(v)
        elif isinstance(val, (list, tuple)):
            for v in val:
                scan(v)

    for op in ops:
        refs.update(op.input_names())
        refs.update(op.output_names())
        for val in op.attrs.values():
            scan(val)


def _string_refs(val, out: set):
    """Every string reachable through list/tuple/dict attr values."""
    if isinstance(val, str):
        out.add(val)
    elif isinstance(val, dict):
        for v in val.values():
            _string_refs(v, out)
    elif isinstance(val, (list, tuple)):
        for v in val:
            _string_refs(v, out)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    """Scope the default programs (reference: framework.py:5455)."""
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


# device_guard: pins the ops built inside it to a pipeline stage
# (reference: framework.py:5591); the tag is part of the program's JSON
_current_device: Optional[str] = None


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    global _current_device
    old = _current_device
    _current_device = device
    try:
        yield
    finally:
        _current_device = old


def current_device() -> Optional[str]:
    return _current_device


# the imperative mode switch (reference :793): the active dygraph Tracer,
# or None in static mode
_dygraph_tracer_holder = [None]


def in_dygraph_mode() -> bool:
    return _dygraph_tracer_holder[0] is not None
