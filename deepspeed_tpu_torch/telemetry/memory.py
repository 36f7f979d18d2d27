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
``telemetry.memory_interval_s``. Host components reported by byte count
(the serving KV host tier's) sit beside them under ``host_components``.
:class:`KVPoolAccountant` is a host-pure copy of JAX's: the paged pool's
block lifetimes, age at eviction, tier swaps and free-list
fragmentation.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry,
                                                    get_registry)

# per-request peak block counts are small integers, not latencies —
# power-of-two buckets (1 … 4096) give the histogram sane resolution
BLOCK_COUNT_BUCKETS = [2.0 ** i for i in range(13)]


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
        # host-RAM residents reported by byte count (the serving KV host
        # tier's numpy payloads): a bucket family of their own
        self._host_components: Dict[str, Callable[[], int]] = {}
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop: Optional[threading.Event] = None

    # -------------------------------------------------------- components

    def register_component(self, name: str,
                           getter: Callable[[], object]) -> None:
        """Register (or replace) a named component. ``getter`` returns
        the component's CURRENT tree at snapshot time."""
        with self._lock:
            self._components[name] = getter

    def register_host_component(self, name: str,
                                bytes_getter: Callable[[], int]) -> None:
        """Register (or replace) a HOST-memory component by its byte
        count (the serving KV host tier); snapshots report it under
        ``host_components`` and the ``memory_host_component_bytes``
        gauge."""
        with self._lock:
            self._host_components[name] = bytes_getter

    def unregister_component(self, name: str,
                             getter: Optional[Callable] = None) -> None:
        """Remove a component (device or host). With the ``getter`` that
        was registered the removal is owner-safe: a newer registration of
        the same name by another engine is left alone."""
        with self._lock:
            for table in (self._components, self._host_components):
                if name in table:
                    if getter is None or table[name] is getter:
                        del table[name]
                    return

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
            host_getters = dict(self._host_components)
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
        host: Dict[str, dict] = {}
        for name, bytes_getter in host_getters.items():
            try:
                nbytes = int(bytes_getter())
            except Exception:  # noqa: BLE001 — a dead getter ≠ no snapshot
                continue
            host[name] = {"bytes": nbytes}
            reg.gauge(
                "memory_host_component_bytes",
                help="host-RAM bytes by registered host component "
                     "(numpy payloads outside jax.live_arrays — e.g. "
                     "the serving KV host tier)",
                labels={"component": name}).set(nbytes)
        return {"components": buckets, "total_bytes": total,
                "total_arrays": arrays, "host_components": host,
                "host_bytes_total": sum(b["bytes"] for b in host.values()),
                "devices": devices}

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


class KVPoolAccountant:
    """Block-pool lifetime & fragmentation accounting for the paged KV
    cache (docs/observability.md "Serving goodput & KV-pool
    accounting") — the measurements KV quantization / host offload
    (ROADMAP item 2) need before choosing eviction candidates:

    * **Residency lifetime** — acquire (refcount 0→1: fresh allocation
      or LRU resurrection) to release (refcount back to 0) per block,
      as a histogram: how long does a block actually stay pinned?
    * **Age at eviction** — park-in-LRU to eviction per cached block:
      how long does reusable prefix content survive before the free
      list runs dry? Short ages mean the LRU is churning and offload
      (demotion instead of eviction) would win.
    * **Free-list fragmentation** — longest contiguous run of free
      block ids over the free count (1.0 = one unbroken run). The pool
      is position-independent today, but tiered/offloaded blocks want
      contiguous spans for batched host DMA, so the gauge is the
      early-warning signal.
    * **Per-request peak blocks** — the high-water block count a
      request held across its (possibly preempted) residencies.
    * **Famine snapshot** — when an allocation cannot be covered even
      by eviction, the allocator's state (free/live/cached/reserved/
      fragmentation) freezes into the flight-recorder ring, once per
      famine episode (re-armed by the next successful allocation).

    Host-pure; ``clock`` is injectable (the property tests drive it
    manually). The :class:`~deepspeed_tpu_torch.inference.kv_cache.
    BlockAllocator` calls the ``on_*`` hooks; a server with
    ``telemetry.step_profile`` off builds no accountant and the
    allocator hot path never branches past a ``None`` check.
    """

    # admission-state transitions between periodic fragmentation
    # recomputes (the scan is O(free log free) — a 100k-block pool
    # serving short requests must not sort its free list per retire);
    # snapshot consumers and the famine path refresh unconditionally
    FRAG_EVERY = 64

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self._acquired: Dict[int, float] = {}   # block -> acquire ts
        self._parked: Dict[int, float] = {}     # block -> LRU-park ts
        self._famine_armed = True
        self._frag_tick = 0
        self.famines = 0
        self.swap_ins = 0       # host-tier promotions (mirrors)
        self.swap_outs = 0      # host-tier demotions
        self.last_host_blocks = 0
        self.last_fragmentation = 1.0
        self.last_longest_run = 0
        reg = self.registry
        self._h_lifetime = reg.histogram(
            "serve_kv_block_lifetime_seconds",
            help="pool-block residency lifetime: refcount 0->1 "
                 "(allocation or LRU resurrection) to refcount 0 "
                 "(release)")
        self._h_evict_age = reg.histogram(
            "serve_kv_block_age_at_eviction_seconds",
            help="cached-block age at LRU eviction: parked (released "
                 "with a registered prefix) to evicted because the "
                 "free list ran dry")
        self._h_peak = reg.histogram(
            "serve_request_peak_blocks",
            help="per-request peak pool blocks held across all of the "
                 "request's residencies (observed at finish)",
            buckets=BLOCK_COUNT_BUCKETS)
        # host tier (docs/serving.md "KV quantization & host tiering"):
        # swap traffic + residency — the numbers that say whether the
        # tier is extending capacity (occasional demote, rare swap-in)
        # or thrashing (the kv_swap_thrash ring event's inputs)
        self._c_swap_in = reg.counter(
            "serve_kv_swap_in_total",
            help="demoted blocks promoted back to the device on a "
                 "prefix hit (host->device copy through the jitted "
                 "staging writer)")
        self._c_swap_out = reg.counter(
            "serve_kv_swap_out_total",
            help="parked blocks demoted to the host tier when the free "
                 "list ran dry (device->host copy; content retained "
                 "under its chain hash instead of evicted)")
        self._g_host = reg.gauge(
            "serve_kv_host_blocks",
            help="blocks currently resident in the host tier")
        self._h_swap = reg.histogram(
            "serve_kv_swap_seconds",
            help="one block's tier copy wall time, either direction "
                 "(demotion: device->host fetch, synchronous by "
                 "np.asarray; swap-in: host->device dispatch of the "
                 "staging write)")
        self._g_frag = reg.gauge(
            "serve_kv_free_longest_run_ratio",
            help="longest contiguous run of free block ids / free-list "
                 "size (1.0 = unfragmented; recomputed every Nth "
                 "admission-state transition and at every snapshot/"
                 "famine)")

    # ----------------------------------------------------- block hooks

    def on_acquire(self, block: int) -> None:
        """Refcount 0→1: fresh allocation or LRU resurrection. The
        previous park timestamp (if any) rides along so a ROLLBACK can
        restore it instead of re-stamping the block's LRU age."""
        self._acquired[block] = (self.clock(),
                                 self._parked.pop(block, None))

    def on_release(self, block: int, parked: bool) -> None:
        """Refcount back to 0; ``parked`` = the block kept its prefix
        hash and entered the evictable LRU instead of the free list."""
        now = self.clock()
        entry = self._acquired.pop(block, None)
        if entry is not None:
            self._h_lifetime.observe(max(now - entry[0], 0.0))
        if parked:
            self._parked[block] = now

    def on_rollback(self, block: int) -> None:
        """Undo an acquisition that never became a residency (a failed
        admission rolling back its prefix-cache hits): NO lifetime
        observation — a blocked queue head retried every step must not
        flood the histogram with ~0s samples — and the block's
        original park timestamp is restored, so its age-at-eviction
        still measures from when it actually parked."""
        entry = self._acquired.pop(block, None)
        if entry is not None and entry[1] is not None:
            self._parked[block] = entry[1]

    def on_evict(self, block: int) -> None:
        """LRU eviction: the parked content is gone for good."""
        ts = self._parked.pop(block, None)
        if ts is not None:
            self._h_evict_age.observe(max(self.clock() - ts, 0.0))

    def on_demote(self, block: int) -> None:
        """LRU pop that DEMOTED the block to the host tier: the park
        timestamp retires without an eviction-age observation (the
        content survives — observing it as an eviction would tell the
        operator the cache is churning when it is actually tiering)."""
        self._parked.pop(block, None)

    def observe_swap(self, direction: str, seconds: float,
                     host_blocks: int) -> None:
        """One tier copy, timed by the owner (the server's demote /
        swap-in callbacks). ``direction``: "out" = device->host
        demotion, "in" = host->device promotion."""
        if direction == "out":
            self._c_swap_out.inc()
            self.swap_outs += 1
        else:
            self._c_swap_in.inc()
            self.swap_ins += 1
        self._h_swap.observe(max(seconds, 0.0))
        self.last_host_blocks = int(host_blocks)
        self._g_host.set(host_blocks)

    def on_alloc_ok(self) -> None:
        """A successful allocation re-arms the famine event."""
        self._famine_armed = True

    def on_famine(self, requested: int, state: dict) -> None:
        """Allocation failure even after eviction: freeze the allocator
        state into the event ring, once per episode."""
        if not self._famine_armed:
            return
        self._famine_armed = False
        self.famines += 1
        from deepspeed_tpu_torch.telemetry.events import POOL_FAMINE, \
            record_event
        record_event(POOL_FAMINE, requested_blocks=requested,
                     fragmentation=round(self.last_fragmentation, 4),
                     **state)

    # -------------------------------------------------------- requests

    def observe_request_peak(self, blocks: int) -> None:
        """High-water block count of a finished request (skipped for
        requests that never reached a slot — a zero would pollute the
        distribution with queue-only rejections)."""
        if blocks > 0:
            self._h_peak.observe(blocks)

    # --------------------------------------------------- fragmentation

    def maybe_update_fragmentation(
            self, free_ids_factory: Callable[[], Iterable[int]]) -> float:
        """Rate-limited recompute for the per-transition call site
        (every :data:`FRAG_EVERY`-th admission-state transition); the
        factory is only invoked when the scan actually runs, so a
        skipped call costs one counter increment."""
        self._frag_tick += 1
        if (self._frag_tick - 1) % self.FRAG_EVERY:
            return self.last_fragmentation
        return self.update_fragmentation(free_ids_factory())

    def update_fragmentation(self, free_ids: Iterable[int]) -> float:
        """Recompute the longest-contiguous-run ratio over the
        IMMEDIATELY free ids (the free list proper — evictable LRU
        blocks still hold content and are excluded). O(free log free);
        rate-limited on the transition path
        (:meth:`maybe_update_fragmentation`), unconditional from
        snapshot consumers and the famine path — never per decode
        step."""
        ids = sorted(free_ids)
        if not ids:
            ratio, longest = 1.0, 0
        else:
            longest = run = 1
            for prev, cur in zip(ids, ids[1:]):
                run = run + 1 if cur == prev + 1 else 1
                longest = max(longest, run)
            ratio = longest / len(ids)
        self.last_fragmentation = ratio
        self.last_longest_run = longest
        self._g_frag.set(ratio)
        return ratio

    # --------------------------------------------------------- export

    def snapshot(self) -> dict:
        """JSON-able view for ``/debug/goodput`` / ``server.stats`` /
        the bench blob."""
        return {
            "enabled": True,
            "live_tracked": len(self._acquired),
            "parked_tracked": len(self._parked),
            "free_longest_run_ratio": self.last_fragmentation,
            "free_longest_run": self.last_longest_run,
            "famine_episodes": self.famines,
            "swap_ins": self.swap_ins,
            "swap_outs": self.swap_outs,
            "host_blocks": self.last_host_blocks,
        }


_default_monitor = MemoryMonitor()


def get_memory_monitor() -> MemoryMonitor:
    """The process-wide monitor the engines register components on."""
    return _default_monitor


def set_memory_monitor(monitor: MemoryMonitor) -> MemoryMonitor:
    """Swap the process default (tests); returns the previous one."""
    global _default_monitor
    prev, _default_monitor = _default_monitor, monitor
    return prev
