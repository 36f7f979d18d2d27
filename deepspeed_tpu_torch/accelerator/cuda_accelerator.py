"""CUDA and CPU accelerator implementations.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py`` — the
concrete device layer behind
:func:`deepspeed_tpu_torch.accelerator.get_accelerator`.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import (
    DeepSpeedAccelerator)


class CUDA_Accelerator(DeepSpeedAccelerator):
    _name = "cuda"

    def device_name(self, device_index: Optional[int] = None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def memory_stats(self, device_index: Optional[int] = None) -> dict:
        # cudaMemGetInfo counts every allocation on the card, PyTorch's
        # caching allocator and other processes alike
        free, total = torch.cuda.mem_get_info(device_index)
        return {"bytes_limit": int(total), "bytes_in_use": int(total - free)}


class CPU_Accelerator(DeepSpeedAccelerator):
    """Host backend for the tests: same surface, no memory stats."""
    _name = "cpu"

    def device_name(self, device_index: Optional[int] = None) -> str:
        return self._name

    def device_count(self) -> int:
        return 1

    def is_available(self) -> bool:
        return True

    def memory_stats(self, device_index: Optional[int] = None) -> dict:
        return {}
