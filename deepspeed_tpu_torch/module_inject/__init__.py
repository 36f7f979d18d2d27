from deepspeed_tpu_torch.module_inject.from_jax import \
    params_from_numpy  # noqa: F401
