"""DistributedStrategy: the configuration object of fleet.

Counterpart of ``paddle_tpu/distributed/fleet/base/distributed_strategy.py``
(itself Paddle's ``DistributedStrategy``, a protobuf of 228 fields):
plain attributes with the reference's knob names. ``hybrid_configs``'
degrees lay out the mesh; the other knobs are accepted and, as in the
reference, read by nothing.
"""
from __future__ import annotations


class DistributedStrategy:
    def __init__(self):
        # hybrid parallel degrees (the load-bearing config)
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "mp_configs": {},
            "pp_configs": {},
        }
        # feature switches (reference proto field names)
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.lamb = False
        self.lamb_configs = {}
        self.dgc = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.without_graph_optimization = True
        self.asp = False
        self.qat = False
        self.qat_configs = {}
        self.fuse_all_reduce_ops = True
        self.last_comm_group_size_MB = 1

    def __repr__(self):
        degrees = {k: v for k, v in self.hybrid_configs.items()
                   if k.endswith("_degree")}
        return f"DistributedStrategy(hybrid={degrees})"
