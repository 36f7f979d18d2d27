from deepspeed_tpu_torch.module_inject.from_jax import (  # noqa: F401
    paged_cache_from_numpy, params_from_numpy)
