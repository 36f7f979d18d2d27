"""Scrape surface: stdlib ``http.server`` endpoint over the registry.

Host-pure copy of ``deepspeed_tpu/telemetry/exporter.py`` (same keys, families,
help strings and ring events), over the port's registry and event ring.

Off by default and config-gated (``telemetry.http_port``) — a serving
process must opt into opening a port. stdlib-only on purpose: the
container bakes no prometheus_client, and the exposition format is
simple enough that a renderer (registry.prometheus_text) plus a
ThreadingHTTPServer IS the integration.

The route table (:data:`ROUTES`) is the single source of truth for the
endpoint's surface: the ``/`` help page and the 404 body are both
rendered from it, so adding a route updates every listing at once.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deepspeed_tpu_torch.telemetry.registry import MetricRegistry, get_registry
from deepspeed_tpu_torch.utils.logging import logger

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# per-connection socket timeout: a scrape client that connects and then
# stalls (or never reads the response) times out instead of pinning one
# of the ThreadingHTTPServer's handler threads forever
DEFAULT_HANDLER_TIMEOUT_S = 10.0

# path -> one-line description; keep in sync with docs/observability.md
# "Scrape endpoint" (the help/404 renderers below read this table)
ROUTES = {
    "/metrics": "Prometheus text exposition (content-type 0.0.4)",
    "/metrics.json": "JSON snapshot of the same instruments "
                     "(p50/p90/p99 included)",
    "/debug/events": "flight-recorder event ring (telemetry/events.py)",
    "/debug/memory": "live-array accounting by component "
                     "(telemetry/memory.py; snapshots on request)",
    "/debug/compile": "compile_report() text (telemetry/compile_watch.py)",
    "/debug/numerics": "training numerics watches — per-block norms, "
                       "non-finite provenance, loss-spike state "
                       "(telemetry/numerics.py)",
    "/debug/traces": "recent finished request traces as JSON "
                     "(telemetry/tracing.py; see also dump_timeline)",
    "/debug/goodput": "serving step-profile phase/goodput totals + "
                      "KV-pool accounting (telemetry/step_profile.py)",
    "/debug/replicas": "replica-pool health/routing/failover state "
                       "(inference/frontend.py ServingFrontend)",
    "/debug/fleet": "fleet observability rollup — per-replica health/"
                    "role/goodput/dispatch-gap, scrape staleness, "
                    "handoff gauges, trace-stitching state "
                    "(docs/observability.md 'Fleet observability')",
    "/debug/resilience": "training-supervisor restart/recovery state + "
                         "checkpoint-integrity report "
                         "(runtime/resilience.py TrainingSupervisor)",
    "/debug/capacity": "live capacity model — windowed throughput, "
                       "slot/block occupancy, goodput-derived "
                       "sustainable rate, admissible request rate at "
                       "the current mix; pool rollup beside per-replica "
                       "rows on a frontend (telemetry/capacity.py)",
    "/debug/incidents": "retained incident bundles + alert/canary "
                        "state — SLO rules, probe health, episode "
                        "accounting (telemetry/incident.py)",
}


# JAX's /debug/resilience answer when no training supervisor is armed;
# the supervisor (runtime/resilience.py) is ROADMAP.md A7b-ii
NO_SUPERVISOR = {"enabled": False,
                 "hint": "no TrainingSupervisor armed (wrap the train "
                         "loop with runtime/resilience.py — docs/"
                         "training.md 'Fault-tolerant training & "
                         "verified checkpoints')"}


def _help_text() -> str:
    lines = ["deepspeed_tpu telemetry endpoint (docs/observability.md)",
             ""]
    lines += [f"  {path:<18} {desc}" for path, desc in ROUTES.items()]
    return "\n".join(lines) + "\n"


class TelemetryHTTPServer:
    """Daemon-threaded scrape endpoint; ``close()`` (or context-manager
    exit) releases the port."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricRegistry] = None,
                 event_ring=None, memory=None, tracer=None,
                 goodput=None, replicas=None, resilience=None,
                 fleet=None, metrics_view=None, capacity=None,
                 incidents=None,
                 handler_timeout_s: float = DEFAULT_HANDLER_TIMEOUT_S):
        if handler_timeout_s is not None and handler_timeout_s <= 0:
            raise ValueError(
                f"handler_timeout_s must be > 0 seconds (or None to "
                f"allow handlers to block forever), got "
                f"{handler_timeout_s}")
        reg = registry or get_registry()

        class _Handler(BaseHTTPRequestHandler):
            # socket read/write timeout (http.server applies it in
            # setup()); a timed-out read sets close_connection and the
            # handler thread exits instead of waiting on a dead client
            timeout = handler_timeout_s

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/":
                    body = _help_text().encode()
                    ctype = "text/plain; charset=utf-8"
                elif path == "/metrics":
                    # ``metrics_view`` is the owner's zero-arg federated
                    # registry builder (a ServingFrontend merging every
                    # replica's snapshot under replica="r<i>" labels);
                    # without one, the endpoint's own registry is the
                    # whole story — one scrape, either way
                    view = (metrics_view() if metrics_view is not None
                            else reg)
                    body = view.prometheus_text().encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path in ("/metrics.json", "/snapshot"):
                    view = (metrics_view() if metrics_view is not None
                            else reg)
                    body = json.dumps(view.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/debug/events":
                    # resolve the ring per request so set_event_ring
                    # (tests) and config resizes are always visible
                    from deepspeed_tpu_torch.telemetry.events import \
                        get_event_ring
                    # None check, not `or`: an empty ring is falsy
                    ring = (event_ring if event_ring is not None
                            else get_event_ring())
                    body = ring.to_json().encode()
                    ctype = "application/json"
                elif path == "/debug/memory":
                    from deepspeed_tpu_torch.telemetry.memory import \
                        get_memory_monitor
                    mon = memory or get_memory_monitor()
                    body = json.dumps(mon.snapshot(registry=reg),
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/compile":
                    from deepspeed_tpu_torch.telemetry.compile_watch import \
                        compile_report
                    body = compile_report().encode()
                    ctype = "text/plain; charset=utf-8"
                elif path == "/debug/numerics":
                    from deepspeed_tpu_torch.telemetry.numerics import \
                        numerics_snapshot
                    body = json.dumps(numerics_snapshot(),
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/traces":
                    from deepspeed_tpu_torch.telemetry.tracing import get_tracer
                    t = tracer if tracer is not None else get_tracer()
                    body = t.to_json().encode()
                    ctype = "application/json"
                elif path == "/debug/goodput":
                    # ``goodput`` is the owner's zero-arg snapshot
                    # callable (the serving loop's step profiler +
                    # pool accountant); an endpoint armed without one
                    # still answers with a valid, self-describing body
                    payload = (goodput() if goodput is not None else
                               {"enabled": False,
                                "hint": "owner armed no step profiler "
                                        "(telemetry.step_profile)"})
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/resilience":
                    # ``resilience`` is the owner's zero-arg snapshot
                    # callable; without one, fall through to the
                    # process-wide supervisor registry (the supervisor
                    # is usually built AFTER the engine opened this
                    # endpoint, so the registry is the common path)
                    if resilience is not None:
                        payload = resilience()
                    else:
                        payload = NO_SUPERVISOR
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/replicas":
                    # ``replicas`` is the owner's zero-arg snapshot
                    # callable (a ServingFrontend's pool view); a bare
                    # server's endpoint still answers self-describingly
                    payload = (replicas() if replicas is not None else
                               {"enabled": False,
                                "hint": "owner is not a ServingFrontend "
                                        "(set replication.replicas > 1 "
                                        "— docs/serving.md 'Replicated "
                                        "serving & failover')"})
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/fleet":
                    # ``fleet`` is the owner's zero-arg rollup callable
                    # (a ServingFrontend's one-JSON fleet view); a bare
                    # server's endpoint answers self-describingly
                    payload = (fleet() if fleet is not None else
                               {"enabled": False,
                                "hint": "owner is not a ServingFrontend "
                                        "(set replication.replicas > 1 "
                                        "— docs/observability.md "
                                        "'Fleet observability')"})
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/capacity":
                    # ``capacity`` is the owner's zero-arg snapshot
                    # callable (a server's CapacityModel row, or a
                    # ServingFrontend's per-replica rows + pool
                    # rollup); an endpoint armed without one still
                    # answers self-describingly
                    payload = (capacity() if capacity is not None else
                               {"enabled": False,
                                "hint": "owner armed no capacity model "
                                        "(telemetry.accounting — "
                                        "docs/observability.md 'Cost "
                                        "accounting & capacity')"})
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/incidents":
                    # ``incidents`` is the owner's zero-arg snapshot
                    # callable (IncidentRecorder + alert engine + canary
                    # prober rows); an endpoint armed without one still
                    # answers self-describingly
                    payload = (incidents() if incidents is not None else
                               {"enabled": False,
                                "hint": "owner armed no incident "
                                        "recorder (telemetry.slo / "
                                        "telemetry.incident — docs/"
                                        "observability.md 'SLOs, "
                                        "alerting & incidents')"})
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(
                        404, "unknown path (try " +
                        ", ".join(ROUTES) + ")")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes must not spam stderr
                pass

        self.registry = reg
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-scrape",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        """Bound port (useful with port=0 ephemeral binding in tests)."""
        return self._httpd.server_address[1]

    def close(self) -> bool:
        """Shut the listener down; returns True when the serve thread
        actually joined. A False return (logged as a warning) means the
        thread is wedged — the port is closed but the thread leaks,
        which the operator should know instead of discovering a zombie
        at the next bind."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            logger.warning(
                "telemetry scrape thread failed to join within 5s — "
                "the port is released but the serve thread is wedged "
                "(stacks via faulthandler / the watchdog dump)")
            return False
        return True

    def __enter__(self) -> "TelemetryHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_server(port: int, host: str = "127.0.0.1",
                      registry: Optional[MetricRegistry] = None,
                      event_ring=None, memory=None, tracer=None,
                      goodput=None, replicas=None, resilience=None,
                      fleet=None, metrics_view=None, capacity=None,
                      incidents=None,
                      handler_timeout_s: float = DEFAULT_HANDLER_TIMEOUT_S
                      ) -> TelemetryHTTPServer:
    """Convenience spelling mirroring prometheus_client's entry point."""
    return TelemetryHTTPServer(port=port, host=host, registry=registry,
                               event_ring=event_ring, memory=memory,
                               tracer=tracer, goodput=goodput,
                               replicas=replicas, resilience=resilience,
                               fleet=fleet, metrics_view=metrics_view,
                               capacity=capacity, incidents=incidents,
                               handler_timeout_s=handler_timeout_s)
