"""Checkpoint toolkit (counterpart of ``deepspeed_tpu/checkpoint``; the
reference's ``deepspeed/checkpoint/`` + ``runtime/checkpoint_engine/``):
the engine abstraction (sync/async), universal checkpoint inspection and
reshaping, ZeRO→fp32 consolidation, and IMPORT of reference-format
DeepSpeed checkpoints (the migration path)."""
from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
    AsyncCheckpointEngine, CheckpointEngine, TorchCheckpointEngine,
    make_checkpoint_engine)
from deepspeed_tpu_torch.checkpoint.import_deepspeed import (
    import_into_engine, load_reference_fp32_state_dict, to_param_tree)
from deepspeed_tpu_torch.checkpoint.universal import (DeepSpeedCheckpoint,
                                                      reshape_checkpoint)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (
    convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint,
    load_state_dict_from_zero_checkpoint)

__all__ = ["CheckpointEngine", "TorchCheckpointEngine",
           "AsyncCheckpointEngine", "make_checkpoint_engine",
           "DeepSpeedCheckpoint", "reshape_checkpoint",
           "get_fp32_state_dict_from_zero_checkpoint",
           "convert_zero_checkpoint_to_fp32_state_dict",
           "load_state_dict_from_zero_checkpoint",
           "load_reference_fp32_state_dict", "to_param_tree",
           "import_into_engine"]
