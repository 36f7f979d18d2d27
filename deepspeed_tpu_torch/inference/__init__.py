"""Inference subsystem — engine, config, dense KV cache (counterpart of
``deepspeed_tpu/inference``; the paged server is a later slice).

``InferenceEngine`` resolves lazily (PEP 562): the model implementation
imports ``inference.kv_cache``, so an eager engine import here would close
an import cycle."""
from deepspeed_tpu_torch.inference.config import (  # noqa: F401
    DeepSpeedInferenceConfig, DeepSpeedMoEConfig, DeepSpeedTPConfig,
    ReplicationConfig)
from deepspeed_tpu_torch.inference.kv_cache import (  # noqa: F401
    KVCache, init_cache)


_LATER_SLICE = {"ContinuousBatchingServer", "PagedKVCache"}


def __getattr__(name):
    if name == "InferenceEngine":
        from deepspeed_tpu_torch.inference.engine import InferenceEngine
        return InferenceEngine
    if name in _LATER_SLICE:
        raise NotImplementedError(
            f"{name} (the paged server) is not ported to "
            "deepspeed_tpu_torch yet (ROADMAP.md queue C)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
