"""ZeRO family (counterpart of ``deepspeed_tpu/runtime/zero/``): the
partition policy over data-parallel ranks (``partition.py``), tiled
linear layers (``tiling.py``), the host optimizer of ZeRO-Offload
(``offload.py``), parameter offload (``param_offload.py``) and the memory
estimators.
"""
from deepspeed_tpu_torch.runtime.zero.memory_estimators import (
    estimate_zero2_model_states_mem_needs_all_cold,
    estimate_zero2_model_states_mem_needs_all_live,
    estimate_zero3_model_states_mem_needs_all_cold,
    estimate_zero3_model_states_mem_needs_all_live,
    estimate_zero_model_states_mem_needs)
from deepspeed_tpu_torch.runtime.zero.partition import (ZeroShardingPolicy,
                                                        shard_leaf_spec)
from deepspeed_tpu_torch.runtime.zero.tiling import (TiledLinear,
                                                     TiledLinearReturnBias)

__all__ = [
    "ZeroShardingPolicy", "shard_leaf_spec", "TiledLinear",
    "TiledLinearReturnBias",
    "estimate_zero_model_states_mem_needs",
    "estimate_zero2_model_states_mem_needs_all_live",
    "estimate_zero2_model_states_mem_needs_all_cold",
    "estimate_zero3_model_states_mem_needs_all_live",
    "estimate_zero3_model_states_mem_needs_all_cold",
]
