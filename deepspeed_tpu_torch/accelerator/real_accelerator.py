"""Accelerator selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``): ``get_accelerator()``
resolves lazily to CUDA when a card is present, else the CPU;
``set_accelerator()`` installs a custom implementation."""
from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import (
    DeepSpeedAccelerator)

_ACCELERATOR: Optional[DeepSpeedAccelerator] = None


def set_accelerator(accel: DeepSpeedAccelerator) -> None:
    global _ACCELERATOR
    if not isinstance(accel, DeepSpeedAccelerator):
        raise TypeError("set_accelerator expects a DeepSpeedAccelerator")
    _ACCELERATOR = accel


def get_accelerator() -> DeepSpeedAccelerator:
    global _ACCELERATOR
    if _ACCELERATOR is None:
        from deepspeed_tpu_torch.accelerator.cuda_accelerator import (
            CPU_Accelerator, CUDA_Accelerator)
        _ACCELERATOR = (CUDA_Accelerator() if torch.cuda.is_available()
                        else CPU_Accelerator())
    return _ACCELERATOR
