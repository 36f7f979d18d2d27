"""Telemetry: the metrics registry, the ``telemetry`` config section and
the training flight recorder (host-pure copies of ``deepspeed_tpu/
telemetry/{registry,config,events,watchdog,flight,goodput}.py``; the
memory monitor and the numerics observatory on torch tensors). The
inference engine records ``inference_generate_seconds`` and
``inference_generate_calls_total`` into the process registry; the
training engine arms the flight recorder, numerics and goodput from its
``telemetry`` section. Tracing, the HTTP exporter and the serving
telemetry are ROADMAP.md A7b."""
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig  # noqa: F401
from deepspeed_tpu_torch.telemetry.events import (  # noqa: F401
    EventRing, dump_ring, get_event_ring, install_fault_dump, record_event,
    set_event_ring, uninstall_fault_dump)
from deepspeed_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorderHandle, arm_flight_recorder)
from deepspeed_tpu_torch.telemetry.goodput import GoodputMeter  # noqa: F401
from deepspeed_tpu_torch.telemetry.memory import (  # noqa: F401
    MemoryMonitor, get_memory_monitor, set_memory_monitor)
from deepspeed_tpu_torch.telemetry.numerics import (  # noqa: F401
    BlockSpec, NumericsWatch, block_nonfinite_counts, block_spec,
    block_sq_norms, numerics_snapshot, register_numerics_watch,
    unregister_numerics_watch)
from deepspeed_tpu_torch.telemetry.registry import (  # noqa: F401
    MetricRegistry, get_registry, set_registry)
from deepspeed_tpu_torch.telemetry.watchdog import Watchdog  # noqa: F401

__all__ = [
    "MetricRegistry", "get_registry", "set_registry", "TelemetryConfig",
    # flight recorder (event ring / memory / watchdog)
    "EventRing", "get_event_ring", "set_event_ring", "record_event",
    "install_fault_dump", "uninstall_fault_dump", "dump_ring",
    "MemoryMonitor", "get_memory_monitor", "set_memory_monitor",
    "Watchdog", "FlightRecorderHandle", "arm_flight_recorder",
    # training numerics observatory + goodput accounting
    "BlockSpec", "NumericsWatch", "block_spec", "block_sq_norms",
    "block_nonfinite_counts", "numerics_snapshot",
    "register_numerics_watch", "unregister_numerics_watch",
    "GoodputMeter",
]
