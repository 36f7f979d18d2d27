"""Inference subsystem — engine, config, dense and paged KV caches, and
the continuous-batching server (counterpart of
``deepspeed_tpu/inference``).

``InferenceEngine`` and ``ContinuousBatchingServer`` resolve lazily (PEP
562): the model implementation imports ``inference.kv_cache``, so an eager
engine import here would close an import cycle."""
from deepspeed_tpu_torch.inference.config import (  # noqa: F401
    DeepSpeedInferenceConfig, DeepSpeedMoEConfig, DeepSpeedTPConfig,
    ReplicationConfig)
from deepspeed_tpu_torch.inference.kv_cache import (  # noqa: F401
    KVCache, PagedKVCache, init_cache, init_paged_cache)


def __getattr__(name):
    if name == "InferenceEngine":
        from deepspeed_tpu_torch.inference.engine import InferenceEngine
        return InferenceEngine
    if name == "ContinuousBatchingServer":
        from deepspeed_tpu_torch.inference.server import \
            ContinuousBatchingServer
        return ContinuousBatchingServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
