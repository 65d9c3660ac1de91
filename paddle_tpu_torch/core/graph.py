"""A step captured once and replayed: the port's counterpart of a jitted
step (the reference's ``Executor._compile``,
``paddle_tpu/core/executor.py:1031``, and the decode engine's jit of
each (phase, bucket) program, ``paddle_tpu/serving/decode.py:552``).

``StepGraph(fn, device)`` wraps a step function that reads only tensors
which outlive it (static input buffers filled before each call, state
updated in place) and returns a list of output tensors. On a CUDA device
``capture()`` records every launch of one call of ``fn`` into a
``torch.cuda.CUDAGraph`` (its temporaries in the graph's private memory
pool, or in ``pool``, shared with other graphs that never run at once),
and ``replay()`` launches them again and returns the same output
tensors: no op is dispatched from the host. On the CPU there is no graph:
``capture()`` does nothing and ``replay()`` calls ``fn``, which is how the
CPU tests hold the step against the op-by-op path.

A capture does not run the step. The kernel wrappers count their
launches while ``fn`` is captured; ``capture()`` takes those counts back
out and keeps them, and every replay adds them
(``kernels.add_counts``): the counters count what ran, and a replayed
step counts what the step run op by op counts.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .. import kernels


class StepGraph:
    def __init__(self, fn: Callable[[], List[torch.Tensor]], device,
                 pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outs: List[torch.Tensor] = []
        self.delta = {}            # launches of one replay, by counter

    def capture(self):
        """Record one call of ``fn`` into a CUDA graph (CUDA devices
        only). A lowering that cannot be captured (a host sync, an
        allocation outside the caching allocator) raises here."""
        if self.device.type != "cuda":
            return
        before = kernels.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self.pool):
            self.outs = self.fn()
        self.delta = kernels.count_delta(before, kernels.snapshot_counts())
        kernels.add_counts({k: -n for k, n in self.delta.items()})
        self.graph = graph
        # the graph holds the work; dropping fn (which may refer back to
        # this graph's owner) frees the pool as soon as the owner goes
        self.fn = None

    def replay(self) -> List[torch.Tensor]:
        """Run the step once: replay the graph on the current stream, or
        call ``fn`` where there is none. Returns the step's outputs,
        which the next replay overwrites."""
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        kernels.add_counts(self.delta)
        return self.outs
