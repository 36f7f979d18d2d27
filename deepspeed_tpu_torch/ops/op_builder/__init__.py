"""CUDA kernel build system (counterpart of
``deepspeed_tpu/ops/op_builder``): nvcc into cached shared libraries with a
plain C interface, bound through ctypes."""
from deepspeed_tpu_torch.ops.op_builder.builder import (  # noqa: F401
    BUILD_DIR, CUDAOpBuilder, build_all, check_launch, find_nvcc, sm_count)
