from deepspeed_tpu_torch.module_inject.from_jax import (  # noqa: F401
    load_engine_state_from_numpy, paged_cache_from_numpy, params_from_numpy)
from deepspeed_tpu_torch.module_inject.from_training import (  # noqa: F401
    convert_trained_model, gpt2_to_inference, llama_to_inference)
