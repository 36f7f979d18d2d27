"""Kernel build system (counterpart of ``deepspeed_tpu/ops/op_builder``):
nvcc (CUDA kernels) and g++ (host ops) into cached shared libraries with a
plain C interface, bound through ctypes."""
from deepspeed_tpu_torch.ops.op_builder.builder import (  # noqa: F401
    BUILD_DIR, CUDAOpBuilder, HostOpBuilder, build_all, check_launch,
    find_cxx, find_nvcc, sm_count)
