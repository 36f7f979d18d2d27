"""Host spans that land in ALL views of the system.

Host-pure copy of ``deepspeed_tpu/telemetry/spans.py`` (same keys, families,
help strings and ring events), over the port's registry and event ring.

``profiling/trace.py`` ``annotate`` puts a named range into the xplane /
Perfetto timeline (the deep per-capture view); the registry histograms
are the always-on aggregate view; and when a request trace is active
(telemetry/tracing.py ``current_span``), the same block becomes a child
span of that request's tree. ``span`` is the one spelling that feeds all
three, so instrumenting a code path once buys the profiler range, the
p50/p90/p99, AND the per-request attribution without a second
decoration pass.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.telemetry.registry import (MetricRegistry, get_registry,
                                              sanitize_metric_name)
from deepspeed_tpu_torch.telemetry.tracing import TraceSpan, current_span

SPAN_HISTOGRAM = "span_duration_seconds"


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricRegistry] = None,
         labels: Optional[Dict[str, str]] = None,
         parent: Optional[TraceSpan] = None):
    """``with span("prefill"): ...`` — profiler annotation + histogram
    (+ a child of the active request trace, when one exists).

    The profiler annotation is best-effort: span timing must survive
    environments where the profiler is unavailable, because the
    histograms are the production signal and the trace is the debugging
    one. An exception inside the block is recorded on the trace span as
    an ``error`` attribute, the span still closes (no leaked profiler
    annotation or half-open tree), and the exception propagates.

    ``parent`` overrides the context-propagated anchor — pass an
    explicit :class:`TraceSpan` to nest under a span other than the
    innermost active one. Yields the trace child span (None when no
    trace is active) so the caller can ``.set()`` attributes on it.
    """
    reg = registry or get_registry()
    hist = reg.histogram(
        SPAN_HISTOGRAM,
        help="host span wall time, by span name (see telemetry.spans)",
        labels={"span": name, **(labels or {})})
    ctx = contextlib.nullcontext()
    try:
        import torch
        ctx = torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — profiler optional, histogram is not
        pass
    anchor = parent if parent is not None else current_span()
    tspan = None
    if anchor is not None:
        tspan = anchor.trace.begin(name, parent=anchor)
    t0 = time.perf_counter()
    try:
        with ctx:
            if tspan is None:
                yield tspan
            else:
                # advance the context anchor: a span() nested inside
                # this block must parent under THIS span, not attach as
                # its sibling
                with tspan.trace.activate(tspan):
                    yield tspan
    except BaseException as e:  # noqa: BLE001 — recorded, then re-raised
        if tspan is not None:
            tspan.set("error", type(e).__name__)
        raise
    finally:
        hist.observe(time.perf_counter() - t0)
        if tspan is not None:
            anchor.trace.end_span(tspan)


def timed(fn: Optional[Callable] = None, *, name: Optional[str] = None,
          registry: Optional[MetricRegistry] = None):
    """``@timed`` / ``@timed(name="phase")`` — function-scoped ``span``
    (the ``instrument`` decorator's metrics-aware sibling)."""
    def deco(f):
        span_name = sanitize_metric_name(
            name or getattr(f, "__qualname__", f.__name__))

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with span(span_name, registry=registry):
                return f(*args, **kwargs)
        return wrapper

    return deco(fn) if fn is not None else deco
