"""Imperative tracer: eager op execution with autograd.

The port of ``paddle_tpu/dygraph/tracer.py``: ``trace_op`` (:130),
``trace_fn`` (:204), ``run_backward`` (:246) and ``grad`` (:346), with
the AMP hook ``_maybe_autocast`` (:97) and the ``@to_static`` capture
hook ``_maybe_capture`` (:195): an op is recorded into an active capture
after it has run, without the casts ``_maybe_autocast`` put around it,
as the reference records it.

The reference takes a ``jax.vjp`` closure of the op's lowering in the
same forward pass and replays the closures in reverse tape order. Here
the op's torch lowering runs under torch autograd (``enable_grad``)
when an input needs a gradient, so the forward records its own backward
graph, again with no recompute: ``run_backward`` is
``torch.autograd.backward`` and ``grad`` is ``torch.autograd.grad``. A
lowering that calls a kernel needing a gradient gives autograd a
``torch.autograd.Function`` there (``flash_attention`` runs
``FlashAttentionFunction``, whose backward is the backward kernel).

The reference's semantics carry over: an input that stops gradients,
or sits in one of the op's ``non_diff_inputs`` slots, gets none;
``.grad`` accumulates across ``backward()`` calls until
``clear_gradient``; without ``retain_graph`` the graph is freed, a
second ``backward()`` of the same tensor does nothing and one through
the freed graph from another output raises; ``no_grad`` records
nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core import registry
from ..core.ir import _dygraph_tracer_holder
from ..core.types import to_torch_dtype
from .varbase import VarBase


def resolve_device(place) -> torch.device:
    """A guard's place as a torch device: None means the card (and raises
    without one); a string or ``torch.device`` names it."""
    if place is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dygraph runs on the GPU by default and no CUDA device is "
                "available; pass place='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(place)


class Tracer:
    """Per-guard tracer state (reference: imperative/tracer.h:45) and the
    device every eager tensor of the guard lives on."""

    def __init__(self, device=None):
        self.has_grad = True
        self.train_mode = True
        self.device = resolve_device(device)

    def trace(self, enabled: bool):
        self.has_grad = enabled


def get_tracer() -> Optional[Tracer]:
    return _dygraph_tracer_holder[0]


def _require_tracer() -> Tracer:
    tr = _dygraph_tracer_holder[0]
    if tr is None:
        raise RuntimeError(
            "not in dygraph mode — wrap the code in "
            "`with paddle_tpu_torch.dygraph.guard(place):` or call "
            "enable_dygraph()")
    return tr


def _maybe_autocast(op_type: str, forward):
    """AMP autocast (reference: imperative/amp_auto_cast.cc): a white-list
    op casts its fp32 inputs to the AMP dtype, a black-list op its AMP-
    dtype inputs to fp32. The casts run inside the recorded forward, so
    the gradients flow back through them in the input's own dtype."""
    from ..amp import amp_state

    st = amp_state()
    if st is None:
        return forward
    low = to_torch_dtype(st["dtype"])
    if op_type in st["white"]:
        src, to = torch.float32, low
    elif op_type in st["black"]:
        src, to = low, torch.float32
    else:
        return forward

    def wrapped(ins, attrs, _f=forward):
        ins = {s: [v.to(to) if isinstance(v, torch.Tensor)
                   and v.dtype == src else v for v in vals]
               for s, vals in ins.items()}
        return _f(ins, attrs)

    return wrapped


def _norm_inputs(inputs) -> Dict[str, List[Optional[VarBase]]]:
    norm: Dict[str, List[Optional[VarBase]]] = {}
    for slot, vals in (inputs or {}).items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        norm[slot] = [v if v is None or isinstance(v, VarBase)
                      else VarBase(v) for v in vals]
    return norm


def _needs_grad(v: Optional[VarBase]) -> bool:
    return v is not None and not v.stop_gradient and \
        v._tensor.requires_grad


def trace_op(op_type: str, inputs: Dict[str, Any],
             attrs: Optional[Dict[str, Any]] = None,
             stop_gradient: bool = False) -> Dict[str, List[VarBase]]:
    """Run a registered op now; record its backward when an input needs
    a gradient. ``inputs`` values may be VarBases, array-likes, None or
    lists of them. Returns {slot: [VarBase, ...]} as the lowering's
    output dict."""
    tracer = _require_tracer()
    opdef = registry.get(op_type)
    if opdef.forward is None:
        raise RuntimeError(f"op '{op_type}' has no registered lowering")
    attrs = dict(attrs or {})
    forward = _maybe_autocast(op_type, opdef.forward)
    norm = _norm_inputs(inputs)
    record = tracer.has_grad and not stop_gradient and any(
        _needs_grad(v) for slot, vals in norm.items()
        if slot not in opdef.non_diff_inputs for v in vals)
    ins = {}
    for slot, vals in norm.items():
        cut = not record or slot in opdef.non_diff_inputs
        ins[slot] = [None if v is None else
                     (v._tensor.detach() if cut or v.stop_gradient
                      else v._tensor) for v in vals]
    with torch.enable_grad() if record else torch.no_grad():
        outs = registry.normalize_outputs(forward(ins, attrs))
    out_vars = {slot: [None if t is None else VarBase._wrap(t)
                       for t in vals] for slot, vals in outs.items()}
    _maybe_capture(op_type, norm, attrs, out_vars)
    return out_vars


def _maybe_capture(op_type, norm_inputs, attrs, out_vars):
    """Record the op that has just run into an active ``@to_static``
    capture (``jit.capture_op``), as the reference's tracer does after
    running it."""
    from . import jit

    if jit._capture_stack:
        jit.capture_op(op_type, norm_inputs, attrs, out_vars)


def trace_fn(fn, *inputs) -> VarBase:
    """Run an ad-hoc one-output torch function over VarBases (the
    VarBase methods and operators), recorded as ``trace_op`` records an
    op; a capture records it as a ``__jax_fn__`` op holding the
    closure."""
    tracer = get_tracer()
    vbs = [v if isinstance(v, VarBase) else VarBase(v) for v in inputs]
    record = tracer is not None and tracer.has_grad and \
        any(_needs_grad(v) for v in vbs)
    args = [v._tensor if record and not v.stop_gradient
            else v._tensor.detach() for v in vbs]
    with torch.enable_grad() if record else torch.no_grad():
        out = VarBase._wrap(fn(*args))
    _maybe_capture("__jax_fn__", {"X": vbs},
                   {"fn": lambda *a, _f=fn: (_f(*a),)}, {"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _seed(var: VarBase, grad) -> torch.Tensor:
    t = var._tensor
    if grad is None:
        if t.numel() != 1:
            raise RuntimeError(
                f"backward() on non-scalar (shape {var.shape}) requires an "
                f"explicit grad argument")
        return torch.ones_like(t)
    g = grad._tensor if isinstance(grad, VarBase) else \
        torch.as_tensor(grad, device=t.device)
    return g.to(t.dtype).reshape(t.shape)


def run_backward(var: VarBase, grad=None, retain_graph: bool = False):
    """Accumulate d var / d leaf into every reachable leaf's ``.grad``
    (reference: BasicEngine::Execute). A tensor no op with a gradient made
    (a leaf, or a result already run backward without ``retain_graph``)
    does nothing."""
    if var._tensor.grad_fn is None or var._freed:
        return
    torch.autograd.backward([var._tensor], [_seed(var, grad)],
                            retain_graph=retain_graph)
    if not retain_graph:
        var._freed = True


def grad(outputs: Sequence[VarBase], inputs: Sequence[VarBase],
         grad_outputs=None, retain_graph: bool = False,
         create_graph: bool = False, allow_unused: bool = False):
    """paddle.grad: d outputs / d inputs without touching ``.grad``
    (reference: imperative/partial_grad_engine.cc). ``grad_outputs``
    seeds each output (None: ones, for a one-element output). An input
    the outputs do not depend on raises unless ``allow_unused``, and then
    gives None. ``create_graph=True`` records the gradients' own graph,
    so they can be differentiated again: the reference raises
    NotImplementedError there; torch's autograd has it."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = list(grad_outputs) if isinstance(
        grad_outputs, (list, tuple)) else [grad_outputs]
    roots, seeds = [], []
    for out, og in zip(outputs, grad_outputs):
        if out._tensor.grad_fn is None or out._freed:
            continue
        roots.append(out._tensor)
        seeds.append(_seed(out, og))
    live = [i for i, v in enumerate(inputs) if v._tensor.requires_grad]
    got: List[Optional[torch.Tensor]] = [None] * len(inputs)
    if roots and live:
        res = torch.autograd.grad(
            roots, [inputs[i]._tensor for i in live], seeds,
            retain_graph=retain_graph or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    results = []
    for v, g in zip(inputs, got):
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    f"input {v.name} unused in the graph "
                    f"(pass allow_unused=True to permit)")
            results.append(None)
        else:
            results.append(VarBase._wrap(g, v.name + "@GRAD"))
    if not retain_graph and not create_graph:
        for out in outputs:
            out._freed = True
    return results
