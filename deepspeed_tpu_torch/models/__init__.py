from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: F401
                                             GPT2LMModel, config_for)
from deepspeed_tpu_torch.models.bert import (BertConfig,  # noqa: F401
                                             BertPreTrainingModel)
from deepspeed_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                              LlamaLMModel)
