"""Op-by-op execution of a block on torch tensors.

The port of ``run_op``/``run_block`` (``paddle_tpu/core/executor.py``
:101, :141) and of the ``Executor`` class's interpreting path
(``_run_interpreted`` :528). PyTorch runs eagerly, so the interpreting
path is the only path: the decode engine runs each program's block
through ``run_block`` with its params, pools and feeds in one env dict,
and training goes through ``Executor.run``. There is no compiled path.

Forward lowerings run under ``torch.no_grad()``, so no autograd graph
outlives an op; ``__vjp_grad__`` re-enables grad inside its lowering.

The reference leaves the liveness of a step's temporaries to its
compiler. An eager env that kept every var of a training step alive
would hold all activations, all their gradients and every recompute
temporary at once, so ``Executor.run`` computes each var's last reader
once per program and drops a non-persistable, non-fetched var from the
env right after it.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import registry
from .ir import Block, OpDesc, Program, Variable, default_main_program
from .registry import EMPTY_VAR
from .scope import STEP_COUNTER, Scope, global_scope
from .types import to_torch_dtype, x64_off

_MISSING = object()


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


def run_op(op: OpDesc, env: Dict[str, Any], step=None) -> Dict[str, Any]:
    """Run one op's lowering against env and bind its outputs there.
    ``step`` (the global step counter) is handed to the lowering as the
    ``__step__`` attr: random ops fold it into their seed."""
    opdef = registry.get(op.type)
    if opdef.forward is None:
        raise ExecutionError(f"op '{op.type}' has no registered lowering")
    ins = _resolve_inputs(op, env)
    attrs = dict(op.attrs)
    if step is not None:
        attrs["__step__"] = step
    try:
        with torch.no_grad():
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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor on the host; bf16 as ml_dtypes.bfloat16 bits, or
    as float32 without ml_dtypes (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


class Executor:
    """User-facing run loop (reference: ``Executor``,
    ``paddle_tpu/core/executor.py:276``): ``run(program, feed,
    fetch_list)`` executes block 0 op by op on ``device``.

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

    def close(self):
        self._dead.clear()

    def _to_device(self, value, dtype=None):
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        want = x64_off(to_torch_dtype(dtype) if dtype is not None
                       else value.dtype)
        return value.to(device=self.device, dtype=want)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_compiled: bool = False):
        """Run block 0 of ``program`` once. Feeds are cast to their
        declared dtypes (64-bit types to 32, as the reference does),
        persistable vars are read from and written back to ``scope``,
        and the scope's step counter goes up by one. ``use_compiled`` is
        accepted and ignored: PyTorch runs eagerly. With ``return_numpy``
        fetches come back as numpy arrays; a bf16 fetch comes back as an
        ``ml_dtypes.bfloat16`` array, as the reference returns it, where
        ``ml_dtypes`` imports, and as float32 where it does not."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        block = program.global_block()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]

        env: Dict[str, Any] = dict(scope.items())
        for name, val in (feed or {}).items():
            dtype = block.var(name).dtype if block.has_var(name) else None
            env[name] = self._to_device(val, dtype)
        step = scope.find_var(STEP_COUNTER)
        step = 0 if step is None else int(step)

        persist = {v.name for v in block.vars.values() if v.persistable}
        plans = self._dead.setdefault(program, {})
        key = (len(block.ops), tuple(fetch_names))
        dead = plans.get(key)
        if dead is None:
            dead = plans[key] = _last_readers(block,
                                              persist | set(fetch_names))
        with registry.creating_on(self.device):
            for op, drop in zip(block.ops, dead):
                run_op(op, env, step=step)
                for n in drop:
                    env.pop(n, None)

        for name in persist:
            if name in env:
                scope.set(name, env[name])
        scope.set(STEP_COUNTER, np.int32(step + 1))
        out = []
        for n in fetch_names:
            if n not in env:
                raise ExecutionError(f"fetch target '{n}' was not produced")
            v = env[n]
            if return_numpy:
                v = _to_numpy(v)
            out.append(v)
        return out
