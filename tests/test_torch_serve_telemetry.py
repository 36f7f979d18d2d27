"""The port's serving observability modules against the JAX package's.

Each host module of ``deepspeed_tpu_torch/telemetry/`` is a copy of the
JAX module of the same name (the compile watch and the profiler capture
over torch). Every case below runs ONE script — the scripts of the JAX
package's own tests (``tests/test_step_profile.py``, ``test_accounting.py``,
``test_alerting.py``, ``test_request_tracing.py``, ``test_telemetry.py``,
``test_lifecycle.py``) on a fake clock — once against each package, and
requires the results to be equal: snapshots, Prometheus text, ring events
(without their wall-clock ``ts``), fire / resolve times and decisions.
Tolerance: none; every value is compared exactly (the fake clocks make
every duration exact). The exporter's routes are fetched over HTTP from a
server bound to port 0 on 127.0.0.1.
"""
import importlib
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest


def _pkg(root):
    """The telemetry modules (and the allocator) of one package."""
    names = ("accounting", "alerts", "canary", "capacity", "compile_watch",
             "config", "events", "exporter", "faultinject", "incident",
             "memory", "registry", "slo", "spans", "step_profile",
             "tracing", "watchdog")
    ns = types.SimpleNamespace(
        **{n: importlib.import_module(f"{root}.telemetry.{n}")
           for n in names})
    ns.root = root
    ns.kv = importlib.import_module(f"{root}.inference.kv_cache")
    return ns


JAX = _pkg("deepspeed_tpu")
PORT = _pkg("deepspeed_tpu_torch")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _events(ring):
    """Ring events without their wall-clock stamp."""
    return [{"kind": e["kind"], "data": e["data"]} for e in ring.snapshot()]


def _with_ring(m, fn):
    """Run ``fn(ring)`` with a private process event ring."""
    ring = m.events.EventRing(512)
    prev = m.events.set_event_ring(ring)
    try:
        return fn(ring)
    finally:
        m.events.set_event_ring(prev)


def _normal(x, tmp=None):
    """JSON round trip: tuples become lists, as on the wire; the script's
    scratch directory reads ``<tmp>``."""
    text = json.dumps(x, sort_keys=True, default=str)
    if tmp is not None:
        text = text.replace(str(tmp), "<tmp>")
    return json.loads(text)


# ------------------------------------------------------------ the scripts

def script_tracing(m, tmp):
    clock = FakeClock(100.0)
    reg = m.registry.MetricRegistry()
    tr = m.tracing.Tracer(sample_rate=0.5, ring_capacity=4, seed=3,
                          slow_threshold_s=2.0, registry=reg, clock=clock)
    for i in range(9):
        t = tr.start_trace("request", trace_id=i, prompt_tokens=i + 1)
        q = t.begin("queue_wait")
        clock.advance(0.25 * i)
        t.end_span(q)
        pf = t.begin("prefill", tokens=8)
        ck = t.begin("prefill_chunk", parent=pf, start_token=0)
        clock.advance(0.5)
        t.end_span(ck)
        t.end_span(pf)
        t.add_span("device", clock() - 0.4, clock() - 0.1)
        clock.advance(0.1)
        tr.finish(t, status="failed" if i == 4 else "ok")
    tr.record_rejected("request", "queue_full", request_id=77)
    path = tmp / "timeline.json"
    n = tr.dump_timeline(str(path), event_ring=m.events.EventRing(4))
    return {"traces": [t.to_dict() for t in tr.traces()],
            "json": json.loads(tr.to_json()),
            "started": tr.started, "kept": tr.kept,
            "timeline": json.loads(path.read_text()), "n": n,
            "metrics": reg.prometheus_text()}


def script_spans(m, tmp):
    clock = FakeClock(5.0)
    reg = m.registry.MetricRegistry()
    tr = m.tracing.Tracer(sample_rate=1.0, registry=reg, clock=clock)
    t = tr.start_trace("generate")
    with t.activate(t.root):
        with m.spans.span("outer", registry=reg) as a:
            a.set("k", 1)
            clock.advance(1.0)
            with m.spans.span("inner", registry=reg):
                clock.advance(0.5)
        try:
            with m.spans.span("boom", registry=reg):
                raise KeyError("x")
        except KeyError:
            pass

    @m.spans.timed(name="decorated", registry=reg)
    def f(x):
        return x + 1

    f(1)
    tr.finish(t)
    counts = {s["labels"]["span"]: s["count"]
              for s in reg.snapshot()["span_duration_seconds"]["series"]}
    return {"trace": t.to_dict(), "counts": counts}


def script_step_profile(m, tmp):
    def run(ring):
        clock = FakeClock(10.0)
        reg = m.registry.MetricRegistry()
        seen = []
        prof = m.step_profile.StepProfiler(registry=reg, clock=clock,
                                           events_every=2, source="serve")
        prof.on_step_device = seen.append
        for i in range(6):
            sp = prof.begin()
            clock.advance(0.001)
            sp.mark("admission")
            if i == 2:
                t0 = clock()
                clock.advance(0.004)
                sp.device_interval(t0, clock())
            sp.mark("prefill_chunk")
            clock.advance(0.0005)
            if i >= 3:
                sp.pipelined(since=clock() if i == 3 else None)
            sp.mark("propose", now=clock(), dispatch=True)
            clock.advance(0.0002)
            sp.mark("dispatch")
            clock.advance(0.003)
            sp.mark("sync_wait", now=clock(), fetch=i < 3)
            clock.advance(0.0007)
            sp.mark("commit")
            clock.advance(0.0001)
            sp.mark("publish")
            sp.finish(live=i != 5)
            clock.advance(0.002)
        return {"snap": prof.snapshot(), "gap": prof.recent_gap_s(),
                "device": seen, "metrics": reg.prometheus_text(),
                "events": _events(ring)}
    return _with_ring(m, run)


def script_kv_pool(m, tmp):
    def run(ring):
        clock = FakeClock()
        reg = m.registry.MetricRegistry()
        acct = m.memory.KVPoolAccountant(registry=reg, clock=clock)
        alloc = m.kv.BlockAllocator(9, enable_prefix_caching=True,
                                    accountant=acct)
        a = alloc.allocate(3)
        clock.advance(1.0)
        alloc.register_prefix(a[0], b"h0")
        alloc.register_prefix(a[1], b"h1")
        alloc.release(a)
        clock.advance(2.0)
        hit = alloc.match_prefix([b"h0", b"h1", b"h2"])
        clock.advance(0.5)
        alloc.rollback_match(hit)         # a failed admission
        b = alloc.allocate(5)
        clock.advance(0.25)
        c = alloc.allocate(3)              # evicts the parked prefix
        alloc.set_reserved(2)
        assert alloc.allocate(4) is None   # famine, one event
        assert alloc.allocate(4) is None
        alloc.release(b)
        alloc.set_reserved(0)
        d = alloc.allocate(1)
        acct.observe_swap("out", 0.002, 1)
        acct.observe_swap("in", 0.001, 0)
        acct.observe_request_peak(3)
        acct.observe_request_peak(0)
        acct.update_fragmentation(alloc.free_ids)
        for _ in range(70):
            acct.maybe_update_fragmentation(lambda: alloc.free_ids)
        alloc.release(c + d)
        return {"snap": acct.snapshot(), "state": alloc.famine_state(),
                "metrics": reg.prometheus_text(), "events": _events(ring)}
    return _with_ring(m, run)


def script_accounting(m, tmp):
    def run(ring):
        clock = FakeClock(1.0)
        reg = m.registry.MetricRegistry()
        led = m.accounting.RequestLedger(registry=reg, clock=clock,
                                         max_tenants=2, source="serve")
        canary = m.canary.CANARY_TENANT
        for rid, tenant in enumerate(["a", "b", "c", None, canary]):
            led.open(rid, tokens_in=10 + rid, tenant=tenant)
        led.tenants.count_rejection("a")
        led.tenants.count_rejection(None)
        for rid in range(5):
            clock.advance(0.5)
            led.note_queued(rid, 0.5 * rid)
            led.open_residency(rid, 2 + rid, now=clock())
            led.add_weight(rid, 128)
        led.note_swap_in_bytes(1, 4096)
        led.note_spec(2, 3, 2)
        led.settle_step(0.25)
        for step in range(4):
            clock.advance(0.1)
            for rid in range(5):
                led.add_weight(rid, 1)
            if step == 1:
                led.close_residency(3)
            if step == 2:
                led.finish(0, tokens_out=3, reason="eos")
            led.settle_step(0.05)
        led.finish(1, tokens_out=4, reason="length")
        led.abandon(2)
        led.finish(4, tokens_out=2, reason="length")
        led.flush_pending()
        costs = {rid: led.cost(rid) for rid in range(5)}
        popped = led.pop_cost(1)
        return {"costs": costs, "popped": popped, "after": led.cost(1),
                "snap": led.snapshot(), "tenants": led.tenant_snapshot(),
                "metrics": reg.prometheus_text(), "events": _events(ring)}
    return _with_ring(m, run)


def script_capacity(m, tmp):
    clock = FakeClock()
    reg = m.registry.MetricRegistry()
    lv = {"v": (1, 4, 20, 32)}
    gp = {"v": None}
    cap = m.capacity.CapacityModel(
        registry=reg, clock=clock, window_s=10.0, eval_interval_s=2.0,
        levels=lambda: lv["v"], goodput=lambda: gp["v"])
    toks = reg.counter("serve_tokens_total", help="t")
    reqs = reg.counter("serve_requests_finished_total", help="r")
    rows = [cap.maybe_evaluate()]
    for i in range(12):
        clock.advance(1.0)
        toks.inc(40 + i)
        if i % 3 == 0:
            reqs.inc()
        if i == 5:
            gp["v"] = 0.75
            lv["v"] = (3, 4, 6, 32)
        if i == 8:
            reg.counter("serve_canary_tokens_total", help="c").inc(10)
        rows.append(cap.maybe_evaluate())
    roll = m.capacity.rollup_capacity([cap.snapshot(), cap.snapshot()])
    return {"rows": rows, "snap": cap.snapshot(), "rollup": roll,
            "metrics": reg.prometheus_text()}


def script_slo(m, tmp):
    def run(ring):
        clock = FakeClock()
        reg = m.registry.MetricRegistry()
        cfg = m.config.SLOConfig(enabled=True, queue_wait_p90_s=0.5,
                                 ttft_p90_s=1.0, error_rate=0.2,
                                 window_s=10.0, eval_interval_s=1.0)
        slo = m.slo.SLOMonitor(cfg, registry=reg, clock=clock)
        qw = reg.histogram("serve_queue_wait_seconds", help="q")
        tt = reg.histogram("serve_ttft_seconds", help="t")
        sub = reg.counter("serve_requests_submitted_total", help="s")
        out = [slo.maybe_evaluate()]
        for i in range(25):
            clock.advance(0.5)
            sub.inc()
            qw.observe(0.1 if i < 8 or i > 18 else 2.0)
            tt.observe(0.3 + 0.1 * (i % 5))
            if 10 <= i <= 12:
                reg.counter("serve_admission_rejections_total", help="r",
                            labels={"reason": "pool"}).inc()
            out.append(slo.maybe_evaluate())
        return {"results": out, "last": slo.last_results,
                "snap": slo.snapshot(),
                "compliance": slo.compliance_ratio,
                "metrics": reg.prometheus_text(), "events": _events(ring)}
    return _with_ring(m, run)


def _slo_cfg(m, **objective):
    obj = dict(signal="availability", threshold=0.99, fast_window_s=1.0,
               slow_window_s=5.0, pending_for_s=0.0, resolve_for_s=0.0)
    obj.update(objective)
    return m.config.SLOConfig(enabled=True, eval_interval_s=0.0,
                              objectives={"rule": obj})


def script_alerts(m, tmp):
    def run(ring):
        clock = FakeClock()
        reg = m.registry.MetricRegistry()
        val = {"v": 1.0}
        fired, resolved = [], []
        eng = m.alerts.AlertEngine(
            _slo_cfg(m, pending_for_s=2.0, resolve_for_s=2.0),
            registry=reg, clock=clock,
            sources={"availability": lambda: val["v"]},
            on_fire=lambda r, i: fired.append((clock(), r, i)),
            on_resolve=lambda r, i: resolved.append((clock(), r, i)))
        states = []
        script = [(1.0, 0.5), (1.5, 0.5), (1.0, 0.5), (1.0, None),
                  (1.0, 1.0), (1.5, 1.0), (1.0, 1.0), (3.0, 0.2),
                  (0.5, 1.0), (10.0, 1.0)]
        states.append(eng.evaluate())
        for dt, v in script:
            clock.advance(dt)
            val["v"] = v
            states.append(eng.evaluate())
        # the burn-rate pair: a sharp burst breaches fast, slow confirms
        hist = reg.histogram("serve_ttft_seconds", help="t")
        burn = m.alerts.AlertEngine(
            m.config.SLOConfig(enabled=True, eval_interval_s=0.5,
                               objectives={"ttft": dict(
                                   signal="ttft_p90_s", threshold=0.5,
                                   fast_window_s=1.0, slow_window_s=6.0)}),
            registry=reg, clock=clock)
        burns = []
        for i in range(16):
            clock.advance(0.5)
            hist.observe(2.0 if 4 <= i <= 11 else 0.1)
            burns.append(burn.maybe_evaluate())
        return {"states": states, "fired": fired, "resolved": resolved,
                "snap": eng.snapshot(), "burn": burns,
                "burn_snap": burn.snapshot(),
                "metrics": reg.prometheus_text(), "events": _events(ring)}
    return _with_ring(m, run)


class _FakeOwner:
    """The canary's four owner callables over a scripted server."""

    def __init__(self):
        self.results, self.reasons = {}, {}
        self.prompts, self.tenants, self.cancelled = {}, [], []
        self.next_id = 0
        self.submit_error = None

    def submit(self, prompt, max_new_tokens=32, tenant=None, **_):
        if self.submit_error is not None:
            raise self.submit_error
        rid = self.next_id
        self.next_id += 1
        self.prompts[rid] = list(prompt)
        self.tenants.append(tenant)
        return rid

    def finish(self, rid, generated, reason="length"):
        self.results[rid] = self.prompts[rid] + list(generated)
        self.reasons[rid] = reason

    def result(self, rid):
        return self.results.get(rid)

    def finish_reason(self, rid):
        return self.reasons.get(rid)

    def cancel(self, rid):
        self.cancelled.append(rid)
        return True


def script_canary(m, tmp):
    def run(ring):
        clock, owner = FakeClock(), _FakeOwner()
        reg = m.registry.MetricRegistry()
        probe = m.canary.CanaryProber(
            m.config.CanaryConfig(enabled=True, interval_s=5.0,
                                  timeout_s=3.0, prompt_tokens=6),
            submit=owner.submit, result=owner.result,
            finish_reason=owner.finish_reason, cancel=owner.cancel,
            registry=reg, clock=clock, vocab_size=50)
        out = [probe.tick()]
        clock.advance(0.25)
        owner.finish(0, [7, 8])
        out.append(probe.tick())
        for gen in ([7, 8], [7, 99], None):
            clock.advance(5.0)
            out.append(probe.tick())
            if gen is not None:
                owner.finish(owner.next_id - 1, gen)
            else:
                clock.advance(3.5)
            out.append(probe.tick())
        clock.advance(5.0)
        owner.submit_error = RuntimeError("shed")
        out.append(probe.tick())
        return {"ticks": out, "snap": probe.snapshot(),
                "prompt": probe.prompt, "tenants": owner.tenants,
                "cancelled": owner.cancelled,
                "metrics": reg.prometheus_text(), "events": _events(ring)}
    return _with_ring(m, run)


def script_incident(m, tmp):
    def run(ring):
        clock = FakeClock()
        reg = m.registry.MetricRegistry()
        state = {"phase": "broken"}
        d = tmp / "incidents"
        rec = m.incident.IncidentRecorder(
            m.config.IncidentConfig(enabled=True, dir=str(d),
                                    max_incidents=2),
            collect=lambda: dict(state), registry=reg, clock=clock,
            fingerprint="cafecafecafecafe", name="t")
        b = rec.capture("alert", rule="a", info={"observed_fast": 0.1})
        calls = [b, rec.capture("alert", rule="b"), rec.capture("watchdog"),
                 rec.resolve("a")]
        state["phase"] = "recovered"
        clock.advance(9.0)
        closed = rec.resolve("b")
        on_disk = json.loads(open(closed["path"]).read())
        calls.append(rec.capture("alert", rule="a"))
        rec.resolve("a")
        calls.append(rec.capture("alert", rule="a"))
        dumped = rec.dump(str(tmp / "manual.json"))
        # the watchdog's stall dump is one more trigger of the episode
        wd = m.watchdog.Watchdog(deadline_s=2.0, clock=clock, registry=reg)
        wd.set_on_dump(lambda dump: rec.capture(
            "watchdog", info={"idle_seconds": dump["idle_seconds"]}))
        clock.advance(3.0)
        stalled = wd.check()
        strip = ("path",)
        return _normal({
            "calls": [None if c is None else
                      {k: v for k, v in c.items() if k not in strip}
                      for c in calls],
            "closed": {k: v for k, v in closed.items() if k not in strip},
            "on_disk": {k: v for k, v in on_disk.items() if k not in strip},
            "dumped": {k: v for k, v in dumped.items() if k not in strip},
            "stalled": stalled, "snap": rec.snapshot(),
            "fingerprint": m.incident.config_fingerprint(
                m.config.TelemetryConfig(trace_sample_rate=0.5)),
            "metrics": reg.prometheus_text(), "events": _events(ring)})
    return _with_ring(m, run)


def script_faultinject(m, tmp):
    def run(ring):
        reg = m.registry.MetricRegistry()
        fi = m.faultinject.FaultInjector.from_config(
            m.config.FaultInjectionConfig(
                enabled=True, seed=7, step_latency_s=0.25,
                prefill_failure_rate=0.3, famine_blocks=3,
                wedge_nth_request=4), registry=reg)
        off = m.faultinject.FaultInjector.from_config(
            m.config.FaultInjectionConfig(), registry=reg)
        fails, wedged = [], []
        for rid in range(20):
            fi.on_submit(rid)
            wedged.append(fi.is_wedged(rid))
            try:
                fi.check_prefill(rid, seeded=rid % 5 != 0)
                fails.append(None)
            except m.faultinject.PrefillFault as e:
                fails.append(str(e))
        fi.fail_prefill_for(99)
        try:
            fi.check_prefill(99, seeded=False)
        except m.faultinject.PrefillFault as e:
            fails.append(str(e))
        alloc = m.kv.BlockAllocator(9)
        fi.apply_famine(alloc)
        fi.apply_famine(alloc)
        lat = [fi.step_latency() for _ in range(3)]
        excs = sorted(n for n in dir(m.faultinject)
                      if isinstance(getattr(m.faultinject, n), type)
                      and issubclass(getattr(m.faultinject, n), Exception))
        return {"off": off, "fails": fails, "wedged": wedged, "lat": lat,
                "reserved": alloc.reserved_blocks, "snap": fi.snapshot(),
                "exceptions": excs, "metrics": reg.prometheus_text(),
                "events": _events(ring)}
    return _with_ring(m, run)


def _watch_fn(m):
    """One program under each package's compile watch, with a static."""
    reg = m.registry.MetricRegistry()
    if m.root == "deepspeed_tpu":
        import jax.numpy as jnp

        def fun(ids, params, k):
            return ids.sum() + params["w"].sum() * k
        w = m.compile_watch.watched_jit(fun, "serve_prefill", registry=reg,
                                        static_argnames=("k",))
        arr = lambda shape, dt: jnp.zeros(shape, dt)  # noqa: E731
        dt32, dt16 = jnp.int32, jnp.bfloat16
    else:
        import torch

        def fun(ids, params, k):
            return ids.sum() + params["w"].sum() * k
        w = m.compile_watch.watched(fun, "serve_prefill", registry=reg,
                                    static_argnames=("k",))
        arr = lambda shape, dt: torch.zeros(shape, dtype=dt)  # noqa: E731
        dt32, dt16 = torch.int32, torch.bfloat16
    return w, reg, arr, dt32, dt16


def script_compile_watch(m, tmp):
    def run(ring):
        w, reg, arr, dt32, dt16 = _watch_fn(m)
        calls = [((1, 128), (4,), 2), ((1, 128), (4,), 2),
                 ((1, 256), (4,), 2), ((1, 256), (4,), 3),
                 ((1, 256), (8,), 3), ((1, 128), (4,), 2)]
        for ids, wshape, k in calls:
            w(arr(ids, dt32), {"w": arr(wshape, dt16)}, k=k)
        report = w.report().splitlines()
        kept = [ln for ln in report if not ln.lstrip().startswith("compile ")]
        cost = [ln.split(", calls ")[-1] for ln in report
                if ln.lstrip().startswith("compile ")]
        counts = {k: v for k, v in reg.snapshot().items()
                  if k in ("jit_retraces_total", "jit_compiles_total")}
        evs = [{"kind": e["kind"],
                "data": {k: v for k, v in e["data"].items()
                         if k not in ("seconds", "flops", "hbm_bytes",
                                      "degraded")}}
               for e in _events(ring)]
        return {"retraces": w.retraces, "report": kept, "calls": cost,
                "n": w._cache_size(), "counts": counts, "events": evs}
    return _with_ring(m, run)


def script_exporter(m, tmp):
    """Every route of ROUTES over HTTP, with fixed owner callables and
    no training engine's numerics watch (a process global that engines
    built by other tests in this process may have left registered)."""
    numerics = importlib.import_module(f"{m.root}.telemetry.numerics")

    def run(ring):
        with numerics._watch_lock:
            kept = dict(numerics._watches)
            numerics._watches.clear()
        try:
            return serve(ring)
        finally:
            with numerics._watch_lock:
                numerics._watches.update(kept)

    def serve(ring):
        clock = FakeClock(50.0)
        reg = m.registry.MetricRegistry()
        reg.counter("serve_tokens_total", help="t").inc(5)
        reg.histogram("serve_ttft_seconds", help="t").observe(0.2)
        ring.record("preempt", request_id=3)
        tr = m.tracing.Tracer(sample_rate=1.0, registry=reg, clock=clock)
        t = tr.start_trace("request", trace_id=1)
        clock.advance(0.5)
        tr.finish(t)
        srv = m.exporter.start_http_server(
            0, registry=reg, tracer=tr, event_ring=ring,
            goodput=lambda: {"step_profile": {"steps": 3}},
            capacity=lambda: {"enabled": True, "tokens_per_s": 9.5},
            incidents=lambda: {"enabled": False, "hint": "x"})
        out = {}
        try:
            # /debug/memory last: its snapshot writes each package's own
            # memory gauges into the registry the metric routes render
            paths = [p for p in m.exporter.ROUTES if p != "/debug/memory"]
            for path in paths + ["/", "/snapshot", "/nope",
                                 "/debug/memory"]:
                url = f"http://127.0.0.1:{srv.port}{path}"
                try:
                    with urllib.request.urlopen(url, timeout=10) as r:
                        body, code = r.read().decode(), r.status
                        ctype = r.headers["Content-Type"]
                except urllib.error.HTTPError as e:
                    body, code, ctype = e.read().decode(), e.code, None
                if path == "/debug/events":
                    body = [{"kind": e["kind"], "data": e["data"]}
                            for e in json.loads(body)["events"]]
                elif path in ("/debug/memory", "/debug/compile"):
                    # the process's live arrays / watched programs: each
                    # package's own (the key sets of memory are compared)
                    body = (sorted(json.loads(body))
                            if path == "/debug/memory" else None)
                elif ctype == "application/json":
                    body = json.loads(body)
                out[path] = (code, ctype, body)
        finally:
            joined = srv.close()
        return {"routes": out, "joined": joined}
    return _with_ring(m, run)


SCRIPTS = {
    "tracing": script_tracing, "spans": script_spans,
    "step_profile": script_step_profile, "kv_pool_accountant":
    script_kv_pool, "request_ledger": script_accounting,
    "capacity": script_capacity, "slo": script_slo,
    "alerts": script_alerts, "canary": script_canary,
    "incident": script_incident, "fault_injection": script_faultinject,
    "compile_watch": script_compile_watch, "exporter": script_exporter,
}


@pytest.mark.parametrize("module", sorted(SCRIPTS))
def test_host_module_matches_jax(module, tmp_path):
    """The same fake-clock script through both packages' module gives
    equal results (every value exact)."""
    script = SCRIPTS[module]
    runs = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        tmp = tmp_path / name
        tmp.mkdir()
        runs[name] = _normal(script(m, tmp), tmp)
    assert runs["port"] == runs["jax"]


def test_routes_and_messages_are_jax_s():
    """The exporter's route table and help page, the config defaults
    and the telemetry package's exported names are JAX's (the port names
    ``watched`` for JAX's ``watched_jit``; ``executable_cost`` has no
    counterpart)."""
    assert PORT.exporter.ROUTES == JAX.exporter.ROUTES
    assert PORT.exporter._help_text() == JAX.exporter._help_text()
    assert (PORT.config.TelemetryConfig().model_dump()
            == JAX.config.TelemetryConfig().model_dump())
    import deepspeed_tpu.telemetry as jt
    import deepspeed_tpu_torch.telemetry as pt
    missing = set(jt.__all__) - set(pt.__all__)
    assert missing == {"watched_jit", "executable_cost"}
    assert {"watched", "uninstall_fault_dump"} <= set(pt.__all__)


def test_kv_pool_fragmentation_on_a_crafted_hole_pattern():
    """The rate-limited fragmentation gauge on a hole pattern: free ids
    {1,2,3,5,6,9} hold a longest run of 3 in 6 (JAX's test)."""
    for m in (PORT, JAX):
        acct = m.memory.KVPoolAccountant(
            registry=m.registry.MetricRegistry(), clock=FakeClock())
        assert acct.update_fragmentation([9, 1, 2, 3, 5, 6]) == 0.5
        assert acct.last_longest_run == 3
        assert acct.update_fragmentation([]) == 1.0


def test_memory_monitor_reports_host_components():
    """``/debug/memory``'s host component (the KV host tier's bytes) as
    JAX's: its own bucket and gauge, owner-safe unregistration."""
    import torch
    mon = PORT.memory.MemoryMonitor()
    reg = PORT.registry.MetricRegistry()
    mon.register_component("params", lambda: {"w": torch.zeros(4)})
    get = lambda: 4096  # noqa: E731
    mon.register_host_component("kv_host_tier", get)
    snap = mon.snapshot(reg)
    assert snap["host_components"] == {"kv_host_tier": {"bytes": 4096}}
    assert snap["host_bytes_total"] == 4096
    assert snap["components"]["params"]["bytes"] == 16
    assert 'memory_host_component_bytes{component="kv_host_tier"} 4096' \
        in reg.prometheus_text()
    mon.unregister_component("kv_host_tier", lambda: 0)   # not the owner
    assert "kv_host_tier" in mon.snapshot(reg)["host_components"]
    mon.unregister_component("kv_host_tier", get)
    assert mon.snapshot(reg)["host_components"] == {}


def test_profiler_capture_state_machine():
    """Arm → the first step_begin starts, the Nth step_end stops; one
    capture at a time; a failing start never reaches the loop (JAX's
    ``ProfilerCapture`` with injected start/stop)."""
    from deepspeed_tpu_torch.telemetry.capture import ProfilerCapture
    log = []
    cap = ProfilerCapture(start_fn=lambda d: log.append(("start", d)),
                          stop_fn=lambda: log.append(("stop",)))
    cap.step_begin()
    cap.arm(2, "/tmp/x")
    with pytest.raises(RuntimeError, match="already armed"):
        cap.arm(1, "/tmp/y")
    for _ in range(3):
        cap.step_begin()
        cap.step_end()
    assert log == [("start", "/tmp/x"), ("stop",)] and not cap.active

    def boom(_):
        raise OSError("no profiler")
    bad = ProfilerCapture(start_fn=boom, stop_fn=lambda: None)
    bad.arm(1, "/tmp/z")
    bad.step_begin()
    bad.step_end()
    assert not bad.active


def test_profiler_capture_default_writes_a_chrome_trace(tmp_path):
    """The default start/stop: a ``torch.profiler`` session written as a
    Chrome trace into the logdir."""
    import torch
    from deepspeed_tpu_torch.telemetry.capture import ProfilerCapture
    cap = ProfilerCapture()
    cap.arm(1, str(tmp_path))
    cap.step_begin()
    with torch.profiler.record_function("serve_decode_probe"):
        torch.ones(8) @ torch.ones(8)
    cap.step_end()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert "serve_decode_probe" in files[0].read_text()


def test_compile_watch_keys_tensors_by_shape_and_dtype_only():
    """The port's abstract key: a tensor's values never make a new
    signature; python scalars are keyed by type (weakly, as JAX traces
    them); a static by value; a dataclass by its fields."""
    import dataclasses

    import torch
    from deepspeed_tpu_torch.telemetry.compile_watch import watched

    @dataclasses.dataclass
    class Cache:
        k: torch.Tensor
        lengths: torch.Tensor

    w = watched(lambda x, n, cache: x.sum() + n, "t",
                registry=PORT.registry.MetricRegistry())
    c = Cache(torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32))
    w(torch.ones(3), 1, c)
    w(torch.full((3,), 7.0), 5, c)
    assert w._cache_size() == 1
    w(torch.ones(3), 1.5, c)
    w(torch.ones(3), 1, Cache(torch.zeros(2, 8), c.lengths))
    assert w._cache_size() == 3
    assert w.retraces[0]["changed"] == ["n: py:int -> py:float"]
    assert w.retraces[1]["changed"] == [
        "cache.k: f32[2,4] -> f32[2,8]", "n: py:float -> py:int"]
    rec = w.record_compile((torch.ones(3), 1, c), {}, 0.25)
    assert rec.calls == 3 and w._cache_size() == 3


def test_monitor_master_csv_rows_equal_jax_s(tmp_path):
    """``MonitorMaster``'s CSV rows and the registry sink's gauges equal
    JAX's for the same events; TensorBoard and WandB follow JAX when
    their packages are absent (disabled, a warning)."""
    from deepspeed_tpu.monitor import monitor as jm

    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.monitor import monitor as pm

    events = [("Train/Samples/train_loss", 2.5, 16),
              ("Train/Samples/lr", 1e-3, 16),
              ("Train/Samples/grad_norm", 0.75, 32)]
    out = {}
    for name, mod in (("port", pm), ("jax", jm)):
        d = tmp_path / name
        cfg = DeepSpeedConfig({"train_batch_size": 8, "csv_monitor": {
            "enabled": True, "output_path": str(d), "job_name": "run"}})
        mm = mod.MonitorMaster(cfg)
        mm.write_events(events)
        mm.close()
        rows = {p.name: p.read_text() for p in sorted((d / "run").iterdir())}
        reg = (PORT if name == "port" else JAX).registry.MetricRegistry()
        mod.RegistryMonitor(reg).write_events(events)
        out[name] = (mm.enabled, [m.enabled for m in mm.monitors], rows,
                     reg.prometheus_text())
    assert out["port"] == out["jax"]
    assert out["port"][2]["Train_Samples_lr.csv"] == "16,0.001\n"


def test_a_nan_sample_renders_as_nan():
    """A NaN gauge (a training step's NaN loss through the monitor sink)
    renders as Prometheus's ``NaN``, so ``/metrics`` still answers; the
    JAX package's renderer raises on it (ROADMAP.md D5)."""
    for m in (PORT, JAX):
        reg = m.registry.MetricRegistry()
        reg.gauge("train_loss", help="h").set(float("nan"))
        reg.gauge("ok", help="h").set(2.0)
        if m is JAX:
            with pytest.raises(ValueError, match="NaN"):
                reg.prometheus_text()
        else:
            text = reg.prometheus_text()
            assert "train_loss NaN" in text and "ok 2" in text
