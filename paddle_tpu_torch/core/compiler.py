"""CompiledProgram: a Program with its build and execution strategies.

The port of ``paddle_tpu/core/compiler.py`` (the reference's
``fluid/compiler.py:87``). ``Executor.run`` and ``run_steps`` take a
``CompiledProgram`` as they take its Program: the executor compiles
every program already (a key's second run is a captured CUDA graph), so
the strategies' knobs are kept for the API and change nothing.
``with_data_parallel`` over the one device runs the program as it is; a
mesh or more than one place raises, naming ROADMAP A8 (parallelism).
"""

from __future__ import annotations

from typing import Optional

from .ir import Program


class BuildStrategy:
    """Knobs kept for the API (reference: details/build_strategy.h:50)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """Knobs kept for the API (reference: details/execution_strategy.h:22).
    ``num_iteration_per_drop_scope`` is the reference's k for
    ``train_from_dataset``'s fused dispatch, which comes with ROADMAP
    A9."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class CompiledProgram:
    def __init__(self, program: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._loss_name = None
        self._places = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           places=None, mesh=None,
                           data_axis: Optional[str] = None):
        """Data parallelism over the places given: over one device the
        program runs as it is; a mesh or more than one place raises
        NotImplementedError (ROADMAP A8)."""
        if mesh is not None or (places is not None and len(places) > 1):
            raise NotImplementedError(
                "CompiledProgram.with_data_parallel over a mesh or more "
                "than one device is not in the port yet (ROADMAP A8)")
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        self._places = places
        return self


def program_of(program):
    """The Program of a CompiledProgram, or ``program`` itself."""
    return program._program if isinstance(program, CompiledProgram) \
        else program
