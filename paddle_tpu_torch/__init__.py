"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

Same Fluid-style shape as the JAX package: Python appends OpDescs to a
Program (``core/ir.py``), each op type is a torch lowering in a registry
(``core/registry.py``), and the executor runs a block op by op
(``core/executor.py``). The kernels that the JAX package wrote in Pallas
for the TPU are CUDA C++ kernels for Hopper here (``kernels/`` +
``csrc/``); on a CPU or ``meta`` tensor every kernel wrapper takes its
plain PyTorch version instead.

Three paths are ported. Generative serving: ``serving.DecodeEngine``
over ``models.decoder_lm``'s prefill and decode-step programs. Inference
serving: ``io.save_inference_model`` -> ``inference.create_predictor``
(the seven passes, one CUDA graph per feed signature) ->
``serving.ServingEngine`` (micro-batching) -> ``serving.serve`` and the
cluster controller's rolling swap. Training: the models' programs (IR
build, ``append_backward``, optimizer ops) run step by step by
``core.executor.Executor`` over a ``core.scope.Scope``.

The imperative mode and the 2.0 API run the same lowerings eagerly:
``dygraph`` (``guard(place)``, ``VarBase``, torch autograd), ``nn``,
``optimizer`` (``step()`` through a cached micro-program) with
``optimizer.lr``, ``amp.auto_cast``, ``reader.DataLoader``, ``metric``,
``hapi.Model`` and ``vision``. Like the executor, a guard runs on the
card unless given ``"cpu"``. ``jit.to_static`` captures a 2.0 function
as one program, replayed as CUDA graphs on the card; ``static`` is the
2.0 static-graph namespace.
"""

from __future__ import annotations

from . import ops  # noqa: F401  (registers every op lowering)
from .core.backward import gradients  # noqa: F401
from .core.executor import Executor  # noqa: F401
from .core.ir import (Program, default_main_program,  # noqa: F401
                      default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .core.ir import in_dygraph_mode  # noqa: F401
from . import amp, dygraph, metric, nn, optimizer, reader  # noqa: F401
from . import hapi, tensor, vision  # noqa: F401
from . import static  # noqa: F401
from .static import disable_static, enable_static  # noqa: F401
from .dygraph import jit  # noqa: F401
from .reader import DataLoader  # noqa: F401
from .tensor import to_tensor  # noqa: F401

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "Executor", "Scope", "global_scope",
           "scope_guard", "gradients", "in_dygraph_mode", "to_tensor",
           "DataLoader", "summary", "static", "jit", "enable_static",
           "disable_static"]


def summary(net, input_size, dtypes=None):
    """paddle.summary: the per-layer table of a dygraph Layer
    (``hapi/model_summary.py``)."""
    return hapi.summary(net, input_size, dtypes=dtypes)
