"""ZeRO family (counterpart of ``deepspeed_tpu/runtime/zero/``): the
host optimizer of ZeRO-Offload (``offload.py``), parameter offload
(``param_offload.py``) and the memory estimators.

At world size 1 every placement of JAX's ``ZeroShardingPolicy`` is the one
device, so the engine runs stages 1-3 as stage 0. ``ZeroShardingPolicy``
and ``shard_leaf_spec`` (partitioning across ranks) come with several
processes (ROADMAP.md A6b); ``TiledLinear`` with the long tail (A9).
"""
from deepspeed_tpu_torch.runtime.zero.memory_estimators import (
    estimate_zero2_model_states_mem_needs_all_cold,
    estimate_zero2_model_states_mem_needs_all_live,
    estimate_zero3_model_states_mem_needs_all_cold,
    estimate_zero3_model_states_mem_needs_all_live,
    estimate_zero_model_states_mem_needs)

__all__ = [
    "estimate_zero_model_states_mem_needs",
    "estimate_zero2_model_states_mem_needs_all_live",
    "estimate_zero2_model_states_mem_needs_all_cold",
    "estimate_zero3_model_states_mem_needs_all_live",
    "estimate_zero3_model_states_mem_needs_all_cold",
]
