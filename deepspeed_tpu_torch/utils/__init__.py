from deepspeed_tpu_torch.utils.logging import logger  # noqa: F401
