from deepspeed_tpu_torch.config.config_utils import \
    DeepSpeedConfigModel  # noqa: F401
