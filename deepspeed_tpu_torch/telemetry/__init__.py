"""Telemetry: the metrics registry and the ``telemetry`` config section
(host-pure copies of ``deepspeed_tpu/telemetry/{registry,config}.py``).
The engine records ``inference_generate_seconds`` and
``inference_generate_calls_total`` into the process registry."""
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig  # noqa: F401
from deepspeed_tpu_torch.telemetry.registry import (  # noqa: F401
    MetricRegistry, get_registry, set_registry)
