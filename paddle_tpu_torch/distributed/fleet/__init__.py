"""Fleet (port of ``paddle_tpu/distributed/fleet``) for one device:
``fleet.init``, ``fleet.distributed_optimizer(opt, strategy)`` and its
meta-optimizer chain (AMP with dynamic loss scaling, recompute, the
LARS/LAMB swap)."""

from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (Fleet, barrier_worker,  # noqa: F401
                         distributed_optimizer, fleet, init,
                         is_first_worker, worker_index, worker_num)
from .role_maker import PaddleCloudRoleMaker, UserDefinedRoleMaker  # noqa: F401
from . import meta_optimizers  # noqa: F401
