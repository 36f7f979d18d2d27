"""Live memory accounting, bucketed by component.

Counterpart of ``deepspeed_tpu/telemetry/memory.py``'s ``MemoryMonitor``:
the engines register their big trees (the params, the optimizer state)
by a getter that returns the CURRENT tree at snapshot time; a snapshot
sums each component's tensors (``nbytes``; a tensor two components
share is counted once, by the first), split into device and host
bytes, and publishes the totals as gauges. The device totals come from
PyTorch's allocator (``torch.cuda.memory_allocated`` and
``max_memory_allocated``) where the device is CUDA: what the allocator
holds beyond the registered components lands in ``other``, the bucket
that grows when something leaks. On the CPU the device totals are absent,
as JAX's are off the TPU. A tensor on the ``meta`` device (an NVMe-swapped
param) holds no memory and counts nothing.

Snapshots walk the registered trees (host-only), cheap at human cadence,
not a per-step operation: on demand, or from a daemon thread every
``telemetry.memory_interval_s``. The serving KV pool's accountant
(``KVPoolAccountant``) and the host components reported by byte count
(the KV host tier's) are ROADMAP.md A7b.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry,
                                                    get_registry)


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class MemoryMonitor:
    """Component registry + snapshot engine (see module docstring)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._components: Dict[str, Callable[[], object]] = {}
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop: Optional[threading.Event] = None

    # -------------------------------------------------------- components

    def register_component(self, name: str,
                           getter: Callable[[], object]) -> None:
        """Register (or replace) a named component. ``getter`` returns
        the component's CURRENT tree at snapshot time."""
        with self._lock:
            self._components[name] = getter

    def unregister_component(self, name: str,
                             getter: Optional[Callable] = None) -> None:
        """Remove a component. With the ``getter`` that was registered the
        removal is owner-safe: a newer registration of the same name by
        another engine is left alone."""
        with self._lock:
            if name in self._components and (
                    getter is None or self._components[name] is getter):
                del self._components[name]

    @property
    def components(self) -> List[str]:
        with self._lock:
            return sorted(self._components)

    # ----------------------------------------------------------- snapshot

    def snapshot(self, registry: Optional[MetricRegistry] = None) -> dict:
        """Sum every component's tensors; update gauges in ``registry``
        (default: the process registry); return the JSON view. Never
        raises: a getter that fails counts nothing."""
        reg = registry or get_registry()
        with self._lock:
            getters = dict(self._components)
        seen = set()
        buckets: Dict[str, dict] = {}
        for name, getter in getters.items():
            b = {"bytes": 0, "arrays": 0, "device_bytes": 0,
                 "host_bytes": 0}
            try:
                tensors = list(_tensors(getter()))
            except Exception:  # noqa: BLE001 — a dead getter ≠ no snapshot
                tensors = []
            for t in tensors:
                if t.device.type == "meta":
                    continue
                nbytes = int(t.nbytes)
                key = (t.data_ptr(), nbytes, str(t.device))
                if key in seen:
                    continue
                seen.add(key)
                b["bytes"] += nbytes
                b["arrays"] += 1
                b["host_bytes" if t.device.type == "cpu"
                  else "device_bytes"] += nbytes
            buckets[name] = b
        devices = self._device_stats(reg)
        claimed = sum(b["device_bytes"] for b in buckets.values())
        other = max(devices[0]["bytes_in_use"] - claimed, 0) if devices \
            else 0
        buckets["other"] = {"bytes": other, "arrays": 0,
                            "device_bytes": other, "host_bytes": 0}
        for name, b in buckets.items():
            reg.gauge(
                "memory_component_bytes",
                help="bytes of the tensors of each registered component "
                     "(device and host), 'other' the device allocator's "
                     "unclaimed rest",
                labels={"component": name}).set(b["bytes"])
        total = sum(b["bytes"] for b in buckets.values())
        arrays = sum(b["arrays"] for b in buckets.values())
        reg.gauge("memory_live_bytes_total",
                  help="bytes across the registered components and "
                       "'other'").set(total)
        reg.gauge("memory_live_arrays_total",
                  help="count of the registered components' tensors"
                  ).set(arrays)
        return {"components": buckets, "total_bytes": total,
                "total_arrays": arrays, "devices": devices}

    @staticmethod
    def _device_stats(reg: MetricRegistry) -> List[dict]:
        """The CUDA allocator's totals of the current device; empty
        without a card."""
        out: List[dict] = []
        try:
            if not torch.cuda.is_available() or \
                    not torch.cuda.is_initialized():
                return out
            d = torch.cuda.current_device()
            out.append({
                "device": f"cuda:{d}",
                "bytes_in_use": int(torch.cuda.memory_allocated(d)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    d).total_memory),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(
                    d))})
            reg.gauge("memory_device_bytes_in_use",
                      help="allocator bytes in use, current device"
                      ).set(out[0]["bytes_in_use"])
            reg.gauge("memory_device_bytes_limit",
                      help="the device's memory, current device"
                      ).set(out[0]["bytes_limit"])
        except Exception:  # noqa: BLE001
            pass
        return out

    # ----------------------------------------------------------- sampling

    def start_sampling(self, interval_s: float,
                       registry: Optional[MetricRegistry] = None):
        """Daemon thread snapshotting every ``interval_s`` seconds.
        Restarting replaces the previous sampler. Returns an OWNER TOKEN:
        pass it to :meth:`stop_sampling` so that only the current owner
        stops the shared sampler."""
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.stop_sampling()
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.snapshot(registry)
                except Exception:  # noqa: BLE001 — sampling never crashes
                    pass

        t = threading.Thread(target=loop, name="telemetry-memory",
                             daemon=True)
        with self._lock:
            self._sampler, self._sampler_stop = t, stop
        t.start()
        return stop

    def stop_sampling(self, token=None) -> None:
        """Stop the sampler. With ``token`` the stop is owner-matched: a
        no-op when a newer sampler has replaced the token's.
        ``token=None`` stops whatever runs."""
        with self._lock:
            if token is not None and token is not self._sampler_stop:
                return
            t, stop = self._sampler, self._sampler_stop
            self._sampler = self._sampler_stop = None
        if stop is not None:
            stop.set()
        if t is not None:
            t.join(timeout=5)


_default_monitor = MemoryMonitor()


def get_memory_monitor() -> MemoryMonitor:
    """The process-wide monitor the engines register components on."""
    return _default_monitor


def set_memory_monitor(monitor: MemoryMonitor) -> MemoryMonitor:
    """Swap the process default (tests); returns the previous one."""
    global _default_monitor
    prev, _default_monitor = _default_monitor, monitor
    return prev
