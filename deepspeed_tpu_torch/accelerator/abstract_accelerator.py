"""Pluggable accelerator abstraction.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``: the
seam through which the runtime asks about the device. The one-shot
inference slice needs the device's identity and its memory stats; the rest
of the JAX interface (RNG seeding, dtype support, the collectives backend)
comes with the slices that call it.
"""
from __future__ import annotations

import abc
from typing import Optional


class DeepSpeedAccelerator(abc.ABC):
    _name: str = "abstract"

    def name(self) -> str:
        return self._name

    @abc.abstractmethod
    def device_name(self, device_index: Optional[int] = None) -> str: ...

    @abc.abstractmethod
    def device_count(self) -> int: ...

    @abc.abstractmethod
    def is_available(self) -> bool: ...

    @abc.abstractmethod
    def memory_stats(self, device_index: Optional[int] = None) -> dict:
        """``bytes_limit`` / ``bytes_in_use`` (the keys the JAX backend
        reports, read by ``kv_cache.auto_max_tokens``); empty when the
        device reports none."""
