"""Telemetry: the metrics registry, the ``telemetry`` config section, the
training flight recorder and the serving observability plane (host-pure
copies of ``deepspeed_tpu/telemetry/``; the memory monitor and the
numerics observatory on torch tensors, the compile watch over the port's
step programs, the profiler capture through ``torch.profiler``).

* ``registry`` — process-wide counters/gauges/histograms
* ``spans`` — host spans that record into histograms AND the
  ``torch.profiler`` timeline (``record_function``)
* ``exporter`` — Prometheus-text / JSON scrape endpoint (stdlib
  ``http.server``, config-gated, off by default)
* ``capture`` — on-demand ``torch.profiler`` capture scoped in steps
* ``tracing``, ``step_profile``, ``accounting``, ``capacity``, ``slo``,
  ``alerts``, ``canary``, ``incident``, ``faultinject`` — what the
  serving loop arms (``inference/server.py``)

Nothing here imports a device library at import time.
"""
from deepspeed_tpu_torch.telemetry.accounting import (  # noqa: F401
    RequestLedger, TenantMeter, merge_cost_legs, new_cost_record,
    register_cost_histograms)
from deepspeed_tpu_torch.telemetry.alerts import AlertEngine  # noqa: F401
from deepspeed_tpu_torch.telemetry.canary import (  # noqa: F401
    CANARY_TENANT, CanaryProber)
from deepspeed_tpu_torch.telemetry.capacity import (  # noqa: F401
    CapacityModel, rollup_capacity)
from deepspeed_tpu_torch.telemetry.capture import ProfilerCapture  # noqa: F401
from deepspeed_tpu_torch.telemetry.compile_watch import (  # noqa: F401
    WatchedFunction, all_watched, compile_report, watched)
from deepspeed_tpu_torch.telemetry.config import (  # noqa: F401
    AccountingConfig, CanaryConfig, FaultInjectionConfig, IncidentConfig,
    SLOConfig, SLOObjectiveConfig, TelemetryConfig)
from deepspeed_tpu_torch.telemetry.events import (  # noqa: F401
    EventRing, dump_ring, get_event_ring, install_fault_dump, record_event,
    set_event_ring, uninstall_fault_dump)
from deepspeed_tpu_torch.telemetry.exporter import (  # noqa: F401
    TelemetryHTTPServer, start_http_server)
from deepspeed_tpu_torch.telemetry.faultinject import (  # noqa: F401
    CkptWriteFault, DataStall, FaultInjector, PrefillFault, ReplicaKilled,
    StepCrash, TrainingPreempted)
from deepspeed_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorderHandle, arm_flight_recorder)
from deepspeed_tpu_torch.telemetry.goodput import GoodputMeter  # noqa: F401
from deepspeed_tpu_torch.telemetry.incident import (  # noqa: F401
    IncidentRecorder, config_fingerprint, last_incident_path)
from deepspeed_tpu_torch.telemetry.memory import (  # noqa: F401
    KVPoolAccountant, MemoryMonitor, get_memory_monitor, set_memory_monitor)
from deepspeed_tpu_torch.telemetry.numerics import (  # noqa: F401
    BlockSpec, NumericsWatch, block_nonfinite_counts, block_spec,
    block_sq_norms, numerics_snapshot, register_numerics_watch,
    unregister_numerics_watch)
from deepspeed_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram, MetricRegistry,
    exponential_buckets, get_registry, sanitize_metric_name, set_registry)
from deepspeed_tpu_torch.telemetry.slo import SLOMonitor  # noqa: F401
from deepspeed_tpu_torch.telemetry.spans import span, timed  # noqa: F401
from deepspeed_tpu_torch.telemetry.step_profile import (  # noqa: F401
    NULL_STEP_HANDLE, StepProfiler)
from deepspeed_tpu_torch.telemetry.tracing import (  # noqa: F401
    Trace, Tracer, TraceSpan, current_span, get_tracer, set_tracer)
from deepspeed_tpu_torch.telemetry.watchdog import Watchdog  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "DEFAULT_TIME_BUCKETS", "exponential_buckets", "get_registry",
    "set_registry", "sanitize_metric_name", "span", "timed",
    "TelemetryHTTPServer", "start_http_server", "ProfilerCapture",
    "TelemetryConfig", "SLOConfig",
    # flight recorder (event ring / compile watch / memory / watchdog)
    "EventRing", "get_event_ring", "set_event_ring", "record_event",
    "install_fault_dump", "uninstall_fault_dump", "dump_ring",
    "WatchedFunction", "watched", "compile_report", "all_watched",
    "MemoryMonitor", "get_memory_monitor", "set_memory_monitor",
    "Watchdog", "FlightRecorderHandle", "arm_flight_recorder",
    # training numerics observatory + goodput accounting
    "BlockSpec", "NumericsWatch", "block_spec", "block_sq_norms",
    "block_nonfinite_counts", "numerics_snapshot",
    "register_numerics_watch", "unregister_numerics_watch",
    "GoodputMeter",
    # request-scoped tracing + SLO gates
    "Trace", "Tracer", "TraceSpan", "current_span", "get_tracer",
    "set_tracer", "SLOMonitor",
    # fault injection (chaos hooks for the serving lifecycle layer)
    "FaultInjector", "FaultInjectionConfig", "PrefillFault",
    "ReplicaKilled", "StepCrash", "TrainingPreempted", "DataStall",
    "CkptWriteFault",
    # serving step observatory + KV-pool accounting
    "StepProfiler", "NULL_STEP_HANDLE", "KVPoolAccountant",
    # request-level cost accounting + tenant metering + capacity model
    "RequestLedger", "TenantMeter", "merge_cost_legs",
    "new_cost_record", "register_cost_histograms",
    "CapacityModel", "rollup_capacity", "AccountingConfig",
    # SLO alerting + canary probes + incident bundles (the closed loop)
    "AlertEngine", "CanaryProber", "CANARY_TENANT", "IncidentRecorder",
    "config_fingerprint", "last_incident_path",
    "SLOObjectiveConfig", "CanaryConfig", "IncidentConfig",
]
