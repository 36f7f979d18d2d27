"""Fused inference model implementations (counterpart of
``deepspeed_tpu/model_implementations``)."""
from deepspeed_tpu_torch.model_implementations.transformer import (  # noqa: F401
    InferenceTransformerConfig, causal_forward, decode_step, init_params,
    prefill)
