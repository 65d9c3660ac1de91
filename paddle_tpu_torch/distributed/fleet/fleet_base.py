"""Fleet (port of ``paddle_tpu/distributed/fleet/fleet_base.py``;
reference fleet/base/fleet_base.py :125 init, :544 distributed_optimizer,
:920 minimize and strategy_compiler.py's chain), for one device.

``DistributedOptimizer`` wraps the user's optimizer in the strategy's
meta-optimizers in the reference's order (the LARS/LAMB swap, recompute,
AMP, gradient merge), builds the backward, inserts the gradient allreduce
(nothing at one rank) and applies the update. ``dgc``, ``localsgd`` and
``sharding`` (ROADMAP A8, with data parallelism) are not in the port and
raise, as does a world of more than one worker."""

from __future__ import annotations

from typing import Optional

from .distributed_strategy import DistributedStrategy
from .meta_optimizers import (AMPOptimizer, GradientMergeOptimizer,
                              RecomputeOptimizer, insert_grad_allreduce,
                              maybe_swap_large_batch_optimizer)
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase

# strategy flag -> the ROADMAP item that would bring it to the port
_NOT_PORTED = {"dgc": "A8", "localsgd": "A8", "sharding": "A8"}


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._is_collective = True
        self._strategy: Optional[DistributedStrategy] = None

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None):
        from ..parallel import init_parallel_env

        self._is_collective = is_collective
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._strategy = strategy
        init_parallel_env()
        return self

    def _assert_init(self):
        if self._role_maker is None:
            self.init()

    def worker_num(self) -> int:
        self._assert_init()
        return self._role_maker.worker_num()

    def worker_index(self) -> int:
        self._assert_init()
        return self._role_maker.worker_index()

    def is_first_worker(self) -> bool:
        self._assert_init()
        return self._role_maker.is_first_worker()

    def is_worker(self) -> bool:
        self._assert_init()
        return self._role_maker.is_worker()

    def is_server(self) -> bool:
        self._assert_init()
        return self._role_maker.is_server()

    def barrier_worker(self):
        """Nothing to wait for with one worker."""

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        self._assert_init()
        self._strategy = strategy or self._strategy or DistributedStrategy()
        return DistributedOptimizer(self, optimizer, self._strategy)


class DistributedOptimizer:
    """The meta-optimizer chain over ``inner`` (reference order,
    strategy_compiler.py: the LARS/LAMB swap, recompute, AMP, gradient
    merge)."""

    def __init__(self, fleet_obj: Fleet, inner, strategy: DistributedStrategy):
        on = [k for k in _NOT_PORTED if getattr(strategy, k)]
        if on:
            raise NotImplementedError(
                f"strategy {', '.join(on)} is not in the port: ROADMAP "
                f"{', '.join(_NOT_PORTED[k] for k in on)}")
        if fleet_obj.worker_num() > 1:
            raise NotImplementedError(
                f"a fleet of {fleet_obj.worker_num()} workers (data "
                f"parallelism) is not in the port: ROADMAP A8")
        self.fleet = fleet_obj
        self.strategy = strategy
        inner = maybe_swap_large_batch_optimizer(inner, strategy)
        if strategy.recompute:
            inner = RecomputeOptimizer(
                inner, strategy.recompute_configs.get("checkpoints", []))
        if strategy.amp:
            inner = AMPOptimizer(inner, strategy.amp_configs)
        if strategy.gradient_merge:
            inner = GradientMergeOptimizer(
                inner, strategy.gradient_merge_configs.get("k_steps", 1),
                strategy.gradient_merge_configs.get("avg", True))
        self.inner = inner

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.inner.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        insert_grad_allreduce(loss.block.program, params_grads,
                              self.fleet.worker_num())
        return self.inner.apply_gradients(params_grads), params_grads

    def __getattr__(self, item):
        return getattr(self.inner, item)


fleet = Fleet()


def init(role_maker=None, is_collective: bool = True, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def worker_num() -> int:
    return fleet.worker_num()


def worker_index() -> int:
    return fleet.worker_index()


def is_first_worker() -> bool:
    return fleet.is_first_worker()


def barrier_worker():
    return fleet.barrier_worker()
