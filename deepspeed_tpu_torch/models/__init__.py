from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: F401
                                             GPT2LMModel, config_for)
