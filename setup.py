"""Packaging for deepspeed_tpu (reference setup.py analog).

The reference gates native-op AOT builds behind DS_BUILD_* env flags
(setup.py:114-166); here the C++ host ops (cpu_adam, aio) JIT-compile on
first use through ops/op_builder (g++ + ctypes), so the wheel is pure
Python — set DSTPU_PREBUILD_OPS=1 to compile them at install time instead.
"""
import os

from setuptools import find_packages, setup

if os.environ.get("DSTPU_PREBUILD_OPS"):
    from deepspeed_tpu.ops.op_builder import ALL_OPS
    for name, builder in ALL_OPS.items():
        if builder().is_compatible():
            builder().load()

setup(
    name="deepspeed-tpu",
    version="0.1.0",
    description="TPU-native large-model training & inference framework "
                "with the DeepSpeed capability surface",
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["deepspeed_tpu*"]),
    # the PyTorch/CUDA port builds its kernels from these sources on first
    # use (deepspeed_tpu_torch/ops/op_builder)
    package_data={"deepspeed_tpu_torch": ["ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "ml_dtypes", "psutil", "pydantic"],
    extras_require={"hf": ["transformers", "safetensors"],
                    "monitor": ["tensorboard", "wandb"]},
    scripts=["bin/dstpu", "bin/dstpu_report", "bin/dstpu_elastic",
             "bin/dstpu_bench", "bin/dstpu_ssh", "bin/dstpu_aio",
             "bin/dstpu_autotune"],
)
