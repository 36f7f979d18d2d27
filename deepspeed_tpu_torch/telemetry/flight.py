"""Shared flight-recorder arming for the engines.

Host-pure copy of ``deepspeed_tpu/telemetry/flight.py``; the port's
training engine arms it (``runtime/engine.py`` ``_init_flight_recorder``).

The training engine and the serving server arm the same config-gated
surfaces (event-ring sizing, fault dump, hang watchdog, live-HBM
component accounting) and must tear them down the same way. One helper
owns that sequence so a fix lands once, not twice-and-diverging:

    handle = arm_flight_recorder(tcfg, registry, "serve_watchdog",
                                 [("kv_block_pool", pool_getter), ...])
    ...
    handle.watchdog            # None unless config armed one
    handle.close()             # stop watchdog, release registrations

Ownership rules the handle enforces:

* memory components are unregistered GETTER-MATCHED — a newer engine's
  re-registration of a shared name (``params``) survives an older
  engine's close;
* the periodic memory sampler is stopped only by the handle that holds
  the CURRENT owner token — closing one engine never freezes another
  engine's sampling cadence.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry.events import (get_event_ring,
                                            install_fault_dump)
from deepspeed_tpu_torch.telemetry.memory import get_memory_monitor
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry
from deepspeed_tpu_torch.telemetry.watchdog import Watchdog

Component = Tuple[str, Callable[[], object]]


class FlightRecorderHandle:
    """What one engine armed; ``close()`` releases exactly that."""

    def __init__(self):
        self.watchdog: Optional[Watchdog] = None
        self._components: List[Component] = []
        self._sampler_token = None

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self._components or self._sampler_token is not None:
            mon = get_memory_monitor()
            if self._sampler_token is not None:
                # token-matched: a no-op unless WE are the current owner
                mon.stop_sampling(self._sampler_token)
                self._sampler_token = None
            for name, getter in self._components:
                mon.unregister_component(name, getter)
            self._components = []


def arm_flight_recorder(tcfg, registry: MetricRegistry,
                        watchdog_name: str,
                        components: List[Component]
                        ) -> FlightRecorderHandle:
    """Arm the config-gated flight-recorder surfaces
    (docs/observability.md "Flight recorder") for one engine.

    ``tcfg`` is the engine's ``TelemetryConfig`` (or None — treated as
    the defaults: recording on, every intrusive surface off).
    ``components`` are ``(name, getter)`` pairs for live-HBM
    accounting; pass weakref-resolving getters so a dropped engine
    never pins its arrays through the process-wide monitor.
    """
    handle = FlightRecorderHandle()
    if tcfg is not None and not tcfg.enabled:
        return handle
    if tcfg is not None:
        if "events_capacity" in tcfg.model_fields_set:
            get_event_ring().resize(tcfg.events_capacity)
        if tcfg.events_dump_path:
            install_fault_dump(tcfg.events_dump_path)
        if tcfg.watchdog_deadline_s is not None:
            # the watchdog only sees step/decode completions: size the
            # deadline above the worst expected step AND the first
            # call's kernel builds, or a cold start reads as a stall
            handle.watchdog = Watchdog(
                tcfg.watchdog_deadline_s, registry=registry,
                name=watchdog_name,
                dump_path=(tcfg.events_dump_path + ".stall"
                           if tcfg.events_dump_path else None))
            handle.watchdog.start()
    mon = get_memory_monitor()
    for name, getter in components:
        mon.register_component(name, getter)
    handle._components = list(components)
    if tcfg is not None and tcfg.memory_interval_s is not None:
        handle._sampler_token = mon.start_sampling(
            tcfg.memory_interval_s, registry=registry)
    return handle
