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


class BlockGraphs:
    """A ``run_program`` block (``ops/control_flow_ops.py``) captured as
    CUDA graphs for one key of its feeds' and parameters' shapes,
    dtypes and grad flags: the port's counterpart of the reference's
    ``jax.jit`` of the block, differentiated as one node
    (``paddle_tpu/ops/control_flow_ops.py:380-435``).

    The forward graph reads static feed buffers, filled before each
    replay, and the parameters' own tensors (detached aliases of them:
    the eager optimizer updates them in place, so a replay reads the live
    weights with no copy). With ``train`` it runs the block under
    autograd while captured, and a backward graph captured after it
    computes the gradients of the inputs that need one from static
    cotangent buffers, reading the activations the forward graph left in
    the shared memory pool; the backward of a replay is one replay of it
    (``_Replay``, an autograd Function), where the reference's vjp runs
    the forward again. A call whose backward comes after another forward
    replay of the same graphs replays its own forward again first.

    Every random op reads its slots of a seed table on the device, filled
    once with the seeds of step 0 (``rng.seed_values``), which is what
    the reference's jitted call passes, so every replay draws the
    reference's mask. The truncation flags of bounded loops
    (``executor.truncation_guard``) are computed in the graph, copied to
    the host without a wait and warned on once read. As ``StepGraph``,
    the launch counters count replays: the launches of the warm-up and
    of the captures are taken back out, and each replay adds its
    graph's."""

    def __init__(self, block, feeds, params, fetch_names, feed_names,
                 param_names, device, train):
        from . import rng
        from .executor import _last_readers

        # the block's ops, not the block: the graphs are kept beside the
        # Program, which they must not keep alive
        ops = self.ops = list(block.ops)
        # each op's vars that no later op reads leave the env after it,
        # so a capture's temporaries can share memory
        self.dead = _last_readers(block, set(fetch_names))
        self.device, self.train = device, train
        self.feed_names, self.param_names = feed_names, param_names
        self.fetch_names = fetch_names
        slots = rng.seed_slots(ops)
        seeds = [s for _, s in slots]
        self.tables = torch.tensor(
            [rng.seed_values(seeds, 0), rng.key_values(seeds, 0)],
            dtype=torch.int64).reshape(2, len(slots)).to(device)
        self.seed_of = {key: (self.tables[0, k], self.tables[1, k])
                        for k, (key, _) in enumerate(slots)}
        self.runs_sub = {i for i, op in enumerate(ops) if rng.sub_blocks(op)}
        self.static_feeds = [self._static(f, copy=True) for f in feeds]
        self.static_params = [self._static(p, copy=False) for p in params]
        self.gen = 0               # forward replays so far
        self.guard_messages: List[str] = []
        self.guard_flags = None
        self.pending_guards: List[tuple] = []
        self._capture()

    @staticmethod
    def _static(t, copy):
        s = t.detach().clone() if copy else t.detach()
        if t.requires_grad:
            s.requires_grad_(True)
        return s

    def inputs(self):
        return self.static_feeds + self.static_params

    def _run(self):
        """One run of the block's ops on the static inputs: the fetches."""
        from . import registry
        from .executor import _GUARDS, run_op

        env = dict(zip(self.param_names, self.static_params))
        env.update(zip(self.feed_names, self.static_feeds))
        guards: List[tuple] = []
        _GUARDS.append(guards)
        try:
            with registry.creating_on(self.device):
                for i, (op, drop) in enumerate(zip(self.ops, self.dead)):
                    run_op(op, env, seed=self.seed_of.get(i),
                           seeds=self.seed_of if i in self.runs_sub
                           else None, autograd=True)
                    for n in drop:
                        env.pop(n, None)
            if guards:
                self.guard_flags = torch.stack(
                    [f.reshape(()).bool() for f, _ in guards])
                self.guard_messages = [m for _, m in guards]
        finally:
            _GUARDS.pop()
        return [env[n] for n in self.fetch_names]

    def _grads(self, outs, cotangents):
        diff_in = [t for t in self.inputs() if t.requires_grad]
        got = torch.autograd.grad(
            [o for o, d in zip(outs, self.out_diff) if d], diff_in,
            cotangents, allow_unused=True)
        it = iter(got)
        return [next(it) if t.requires_grad else None
                for t in self.inputs()]

    def _capture(self):
        grad_mode = torch.enable_grad if self.train else torch.no_grad
        before = kernels.snapshot_counts()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        # one warm-up run on a side stream, as make_graphed_callables
        # does: libraries and kernels that set themselves up on a first
        # call do so outside the capture
        with torch.cuda.device(self.device), torch.cuda.stream(side), \
                grad_mode():
            outs = self._run()
            self.out_diff = [o.requires_grad for o in outs]
            if self.train and any(self.out_diff):
                self._grads(outs, [torch.zeros_like(o) for o, d in
                                   zip(outs, self.out_diff) if d])
            del outs
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            at_fwd = kernels.snapshot_counts()
            with torch.cuda.graph(self.fwd), grad_mode():
                self.static_outs = self._run()
            at_bwd = kernels.snapshot_counts()
            self.bwd = None
            self.static_cots: List[torch.Tensor] = []
            self.static_grads: List[Optional[torch.Tensor]] = []
            if self.train and any(self.out_diff):
                self.static_cots = [torch.empty_like(o) for o, d in zip(
                    self.static_outs, self.out_diff) if d]
                self.bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
                    self.static_grads = self._grads(self.static_outs,
                                                    self.static_cots)
            after = kernels.snapshot_counts()
        self.fwd_delta = kernels.count_delta(at_fwd, at_bwd)
        self.bwd_delta = kernels.count_delta(at_bwd, after)
        kernels.add_counts({k: -n for k, n in
                            kernels.count_delta(before, after).items()})

    def forward(self, feeds, params) -> List[torch.Tensor]:
        """Replay the forward graph on these inputs: copies of its
        fetches (the next replay overwrites the graph's own)."""
        from .executor import copy_guards

        self.check_guards()
        with torch.no_grad():
            for buf, t in zip(self.static_feeds, feeds):
                if buf.data_ptr() != t.data_ptr():
                    buf.copy_(t)
            for buf, t in zip(self.static_params, params):
                if buf.data_ptr() != t.data_ptr():
                    buf.copy_(t)
        self.fwd.replay()
        kernels.add_counts(self.fwd_delta)
        self.gen += 1
        if self.guard_flags is not None:
            self.pending_guards.append(copy_guards(self.guard_flags))
        return [o.detach().clone() for o in self.static_outs]

    def backward(self, cotangents) -> List[Optional[torch.Tensor]]:
        """Replay the backward graph for these cotangents of the
        differentiable fetches: a gradient (a copy) for each input that
        needs one, None for the others."""
        with torch.no_grad():
            for buf, g in zip(self.static_cots, cotangents):
                buf.copy_(g)
        self.bwd.replay()
        kernels.add_counts(self.bwd_delta)
        return [None if g is None else g.clone() for g in self.static_grads]

    def check_guards(self):
        """Warn with the message of each truncation flag set in a replay
        whose host copy has completed (never waits for the card)."""
        from .executor import warn_guards

        warn_guards(self.pending_guards, self.guard_messages)


class _Replay(torch.autograd.Function):
    """One replay of a ``BlockGraphs`` on the autograd tape: its backward
    replays the backward graph."""

    @staticmethod
    def forward(ctx, graphs, n_feeds, *inputs):
        feeds, params = inputs[:n_feeds], inputs[n_feeds:]
        outs = graphs.forward(feeds, params)
        ctx.graphs, ctx.gen = graphs, graphs.gen
        ctx.replay_inputs = (feeds, params)
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, graphs.out_diff)
                                      if not d])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        graphs = ctx.graphs
        if graphs.gen != ctx.gen:
            # another call replayed the forward since: its activations
            # are in the pool now, so this call's forward runs again
            graphs.forward(*ctx.replay_inputs)
        grads = graphs.backward([c for c, d in zip(cotangents,
                                                   graphs.out_diff) if d])
        return (None, None) + tuple(grads)


def replay(graphs: BlockGraphs, feeds, params) -> List[torch.Tensor]:
    """The block's fetches for these inputs from its graphs, on the
    autograd tape when they were captured for training."""
    if graphs.bwd is None:
        return graphs.forward(feeds, params)
    return list(_Replay.apply(graphs, len(feeds), *feeds, *params))
