"""NVMe tensor swapping (counterpart of ``deepspeed_tpu/runtime/
swap_tensor``)."""
from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
    OptimizerStateSwapper  # noqa: F401

__all__ = ["OptimizerStateSwapper"]
