"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

Same Fluid-style shape as the JAX package: Python appends OpDescs to a
Program (``core/ir.py``), each op type is a torch lowering in a registry
(``core/registry.py``), and the executor runs a block op by op
(``core/executor.py``). The kernels that the JAX package wrote in Pallas
for the TPU are CUDA C++ kernels for Hopper here (``kernels/`` +
``csrc/``); on a CPU or ``meta`` tensor every kernel wrapper takes its
plain PyTorch version instead.

Two paths are ported. Serving: ``serving.DecodeEngine`` over
``models.decoder_lm``'s prefill and decode-step programs. Training:
``models.bert.build_pretraining_program`` (IR build, ``append_backward``,
AdamW ops) run step by step by ``core.executor.Executor`` over a
``core.scope.Scope``.
"""

from __future__ import annotations

from . import ops  # noqa: F401  (registers every op lowering)
from .core.executor import Executor  # noqa: F401
from .core.ir import (Program, default_main_program,  # noqa: F401
                      default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "Executor", "Scope", "global_scope",
           "scope_guard"]
