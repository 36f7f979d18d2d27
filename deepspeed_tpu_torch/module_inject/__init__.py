"""Checkpoints and trained models → the fused inference tree.

Counterpart of ``deepspeed_tpu/module_inject``: the policy table converts
an HF model (live, or a view over checkpoint files) into
``(InferenceTransformerConfig, params)`` (``policies.py``,
``state_dict_loader.py``, ``megatron_shards.py``), ``from_training``
converts a model the port trained, ``quantize`` stores weights as int8,
and ``from_jax`` carries the JAX package's trees across.
"""
from deepspeed_tpu_torch.module_inject.from_jax import (  # noqa: F401
    load_engine_state_from_numpy, paged_cache_from_numpy, params_from_numpy)
from deepspeed_tpu_torch.module_inject.from_training import (  # noqa: F401
    convert_trained_model, gpt2_to_inference, llama_to_inference)
from deepspeed_tpu_torch.module_inject.policies import (  # noqa: F401
    POLICIES, HFPolicy, convert_hf_model, register_policy)
from deepspeed_tpu_torch.module_inject.quantize import (  # noqa: F401
    GroupQuantizer)

__all__ = ["convert_hf_model", "convert_trained_model", "POLICIES",
           "HFPolicy", "register_policy", "GroupQuantizer"]
