"""Operator registry: op type -> {torch lowering, grad maker}.

The port of ``paddle_tpu/core/registry.py``. A lowering is a plain
function on tensors, ``forward(inputs: {slot: [Tensor, ...]}, attrs) ->
{slot: Tensor or [Tensor, ...]}``, run eagerly by the executor and on
``meta`` tensors by shape inference.

Gradients are ops in the program, built by a grad maker. The default
maker emits one generic ``__vjp_grad__`` op; its lowering re-runs the
forward lowering under ``torch.enable_grad()`` on detached inputs and
calls ``torch.autograd.grad`` with the incoming cotangents (the
counterpart of ``jax.vjp`` on the forward lowering). ``autograd.grad``
was chosen over ``torch.func.vjp`` because the lowerings take and return
dicts of lists with ``None`` holes and integer tensors, which
``autograd.grad`` handles by simply not listing them, while ``func.vjp``
wants every primal and output to be a differentiable tensor pytree.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from .ir import OpDesc

# Sentinel variable name meaning "no tensor" in an op's input list.
EMPTY_VAR = "@EMPTY@"

LoweringFn = Callable[[Dict[str, List[Any]], Dict[str, Any]], Dict[str, Any]]
# grad_maker(fwd_op, out_grads, in_grads) -> list of grad OpDescs.
#   out_grads: fwd output slot -> [grad var name or None, ...]
#   in_grads:  fwd input slot  -> [grad var name to produce or None, ...]
GradMakerFn = Callable[[OpDesc, Dict[str, List[Optional[str]]],
                        Dict[str, List[Optional[str]]]], List[OpDesc]]


@dataclass
class OpDef:
    type: str
    forward: Optional[LoweringFn] = None
    grad_maker: Optional[GradMakerFn] = None
    skip_infer_shape: bool = False
    # slots whose inputs are never differentiable (indices, masks, seeds)
    non_diff_inputs: tuple = ()
    # attrs the lowering dereferences unconditionally
    required_attrs: tuple = ()
    # False for a lowering a captured CUDA graph cannot replay as it ran
    # (one that draws through a torch.Generator seeded on the host): a
    # compiled step that holds it raises
    capturable: bool = True
    # True (or a predicate of the op's attrs) for a lowering that reads a
    # predicate on the host to decide what runs: a compiled step that
    # holds it runs uncaptured (executor.host_decider)
    decides_on_host: Any = False


_REGISTRY: Dict[str, OpDef] = {}

# every op type whose lowering has run in this process, on any path
EXECUTED_OP_TYPES: set = set()


def _recorded(op_type: str, fn: LoweringFn) -> LoweringFn:
    @functools.wraps(fn)
    def wrapper(ins, attrs):
        EXECUTED_OP_TYPES.add(op_type)
        return fn(ins, attrs)

    return wrapper


def register_op(type: str, *, grad_maker: Optional[GradMakerFn] = None,
                skip_infer_shape: bool = False, non_diff_inputs: tuple = (),
                required_attrs: tuple = (), capturable: bool = True,
                decides_on_host=False):
    """Decorator registering a forward lowering for ``type``."""

    def deco(fn: LoweringFn) -> LoweringFn:
        od = _REGISTRY.setdefault(type, OpDef(type=type))
        od.forward = _recorded(type, fn)
        od.skip_infer_shape = skip_infer_shape
        od.non_diff_inputs = tuple(non_diff_inputs)
        od.required_attrs = tuple(required_attrs)
        od.capturable = capturable
        od.decides_on_host = decides_on_host
        if grad_maker is not None:
            od.grad_maker = grad_maker
        return fn

    return deco


def register_grad_maker(type: str):
    """Decorator attaching a custom grad maker to an op registered
    before or after it."""

    def deco(fn: GradMakerFn) -> GradMakerFn:
        _REGISTRY.setdefault(type, OpDef(type=type)).grad_maker = fn
        return fn

    return deco


# where a lowering without tensor inputs (fill_constant, the random
# initializers) creates its output: the running executor's device, or
# "meta" during shape inference
_CREATION_DEVICE = [torch.device("cpu")]


def creation_device() -> torch.device:
    return _CREATION_DEVICE[-1]


@contextlib.contextmanager
def creating_on(device):
    _CREATION_DEVICE.append(torch.device(device))
    try:
        yield
    finally:
        _CREATION_DEVICE.pop()


def lookup(type: str) -> Optional[OpDef]:
    return _REGISTRY.get(type)


def get(type: str) -> OpDef:
    od = _REGISTRY.get(type)
    if od is None:
        raise KeyError(
            f"Operator '{type}' is not registered in the port. Known ops: "
            f"{sorted(_REGISTRY)}")
    return od


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


def normalize_outputs(outs: Dict[str, Any]) -> Dict[str, List[Any]]:
    """Lowerings may return bare tensors per slot; normalise to lists."""
    return {k: list(v) if isinstance(v, (list, tuple)) else [v]
            for k, v in outs.items()}


# ---------------------------------------------------------------------------
# Generic vjp-based gradient
# ---------------------------------------------------------------------------

_IN_PREFIX = "In__"
_OG_PREFIX = "OG__"
_IG_PREFIX = "IG__"


def default_grad_maker(op: OpDesc, out_grads: Dict[str, List[Optional[str]]],
                       in_grads: Dict[str, List[Optional[str]]]
                       ) -> List[OpDesc]:
    """Build one ``__vjp_grad__`` op whose lowering differentiates the
    forward lowering (reference: registry.py default_grad_maker)."""
    inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        inputs[_IN_PREFIX + slot] = list(names)
    for slot, names in op.outputs.items():
        gnames = out_grads.get(slot)
        if gnames is None:
            gnames = [None] * len(names)
        inputs[_OG_PREFIX + slot] = [g if g is not None else EMPTY_VAR
                                     for g in gnames]
    outputs: Dict[str, List[str]] = {}
    for slot, gnames in in_grads.items():
        if gnames is None or all(g is None for g in gnames):
            continue
        outputs[_IG_PREFIX + slot] = [g if g is not None else EMPTY_VAR
                                      for g in gnames]
    if not outputs:
        return []
    return [OpDesc("__vjp_grad__", inputs, outputs, {
        "fwd_type": op.type,
        "fwd_attrs": dict(op.attrs),
        "fwd_out_slots": list(op.outputs.keys()),
        "fwd_out_arity": {s: len(n) for s, n in op.outputs.items()},
    })]


def _inexact(t) -> bool:
    return t.is_floating_point() or t.is_complex()


@register_op("__vjp_grad__", skip_infer_shape=True,
             required_attrs=("fwd_type", "fwd_attrs"))
def _vjp_grad_lowering(ins: Dict[str, List[Any]], attrs: Dict[str, Any]):
    """Gradients of the forward op ``fwd_type`` with respect to every
    input slot, from the cotangents in the ``OG__*`` slots.

    The forward lowering is re-run on detached inputs (the floating-point
    ones of differentiable slots marked ``requires_grad``) with the
    runtime ``__step__`` (or, in a compiled step, the ``__seed__`` and
    ``__key__`` slots, and the ``__seeds__`` slots of a sub-block's ops)
    threaded into its attrs, so a stochastic forward (dropout) recomputes the mask the
    forward op drew. The forward of a ``block_call`` runs its sub-block
    here under autograd: its generic gradient is segment recompute.
    Missing cotangents count as zeros, integer outputs are skipped, and
    an input the outputs do not depend on gets a zero gradient of its own
    shape and dtype (float32 for an integer input)."""
    fwd_def = get(attrs["fwd_type"])
    fwd_attrs = dict(attrs["fwd_attrs"])
    for k in ("__step__", "__seed__", "__key__", "__seeds__"):
        if k in attrs:
            fwd_attrs[k] = attrs[k]
    non_diff = set(fwd_def.non_diff_inputs)
    fwd_ins: Dict[str, List[Any]] = {}
    leaves = []
    for s, vals in ins.items():
        if not s.startswith(_IN_PREFIX):
            continue
        slot = s[len(_IN_PREFIX):]
        lst = []
        for v in vals:
            if v is not None:
                v = v.detach()
                if _inexact(v) and slot not in non_diff:
                    v.requires_grad_(True)
                    leaves.append(v)
            lst.append(v)
        fwd_ins[slot] = lst

    with torch.enable_grad():
        outs = normalize_outputs(fwd_def.forward(fwd_ins, fwd_attrs))
    roots, cts = [], []
    for slot, vals in outs.items():
        ogs = ins.get(_OG_PREFIX + slot, [])
        for i, y in enumerate(vals):
            og = ogs[i] if i < len(ogs) else None
            if y is None or og is None or not _inexact(y) \
                    or not y.requires_grad:
                continue
            roots.append(y)
            cts.append(og.to(y.dtype).reshape(y.shape))
    grads = torch.autograd.grad(roots, leaves, cts, allow_unused=True) \
        if roots and leaves else [None] * len(leaves)
    by_leaf = {id(x): g for x, g in zip(leaves, grads)}

    result: Dict[str, List[Any]] = {}
    for slot, vals in fwd_ins.items():
        fixed = []
        for x in vals:
            if x is None:
                fixed.append(None)
                continue
            g = by_leaf.get(id(x))
            if g is None:
                g = torch.zeros(x.shape, device=x.device,
                                dtype=x.dtype if _inexact(x)
                                else torch.float32)
            fixed.append(g)
        result[_IG_PREFIX + slot] = fixed
    return result
