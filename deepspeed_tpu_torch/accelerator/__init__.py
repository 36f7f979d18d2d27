from deepspeed_tpu_torch.accelerator.abstract_accelerator import \
    DeepSpeedAccelerator  # noqa: F401
from deepspeed_tpu_torch.accelerator.real_accelerator import (  # noqa: F401
    get_accelerator, set_accelerator)
