"""DistributedStrategy: the composable training-strategy config (port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``; reference
fleet/base/distributed_strategy.py). A plain object saved and loaded as
JSON; each flag turns on a meta-optimizer of ``fleet.distributed_
optimizer``'s chain (``fleet_base.py``). The same fields and defaults as
the reference: a strategy file loads in either package."""

from __future__ import annotations

import json
from typing import Any, Dict


class DistributedStrategy:
    def __init__(self):
        # mixed precision (reference :316)
        self.amp = False
        self.amp_configs: Dict[str, Any] = {
            "init_loss_scaling": 32768.0, "use_dynamic_loss_scaling": False,
            "custom_white_list": [], "custom_black_list": [],
            "use_pure_bf16": False}
        # activation recompute (reference :381)
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        # pipeline parallelism (reference :615)
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "micro_batch_size": 1}
        # gradient merge / accumulation (reference :872)
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1,
                                                       "avg": True}
        # large-batch optimizers (reference :929, :989)
        self.lars = False
        self.lars_configs: Dict[str, Any] = {"lars_coeff": 0.001,
                                             "lars_weight_decay": 0.0005}
        self.lamb = False
        self.lamb_configs: Dict[str, Any] = {"lamb_weight_decay": 0.01}
        # gradient compression (reference :808)
        self.dgc = False
        self.dgc_configs: Dict[str, Any] = {"rampup_begin_step": 0}
        # local sgd (reference localsgd_optimizer.py)
        self.localsgd = False
        self.localsgd_configs: Dict[str, Any] = {"k_steps": 1}
        # async parameter server (reference :235)
        self.a_sync = False
        self.a_sync_configs: Dict[str, Any] = {}
        # collective topology (reference :421)
        self.hierarchical_allreduce = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        # tensor parallelism
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict[str, Any] = {
            "tensor_parallel_degree": 1}
        # optimizer-state sharding (reference :1026)
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"sharding_degree": 0,
                                                 "stage": 1}
        self.elastic = False
        self.auto = False

    # -- serialisation (reference: save_to_prototxt / load_from_prototxt) --
    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def save_to_file(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @staticmethod
    def load_from_file(path: str) -> "DistributedStrategy":
        s = DistributedStrategy()
        with open(path) as f:
            s.__dict__.update(json.load(f))
        return s

    def __repr__(self):
        on = [k for k, v in self.to_dict().items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
