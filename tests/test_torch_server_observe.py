"""The owners of the observability plane against the JAX package's, on
the CPU: the ``ContinuousBatchingServer`` with every piece armed, the
one-shot ``generate`` and the training engine.

A tiny GPT-2 (the serving tests' sizes: 2 layers, ``n_embd`` 32, 4 heads,
vocabulary 128, float32, block size 32) is served by both packages from
the same weights on the same requests. Each server has its own private
registry and a TICKING clock (every read advances it by 1 ms), so two
servers that read the clock at the same points in the same order see the
same times, and every duration, cost and snapshot derived from it is
compared EXACTLY (tolerance: none). What is equal to JAX's: the tokens,
each request's cost record, the capacity snapshot, each kept trace
(span names, order and attributes; a tracer reads the wall clock), the
step profiler's and the
pool accountant's snapshots, the registry's family set (less the two
families of JAX's executable cost, which has no counterpart), the
incident bundle's keys, load-shedding decisions and a seeded fault
schedule's finish reasons. ``generate``'s and the training engine's
traces are compared by span names and attributes (their tracers read the
wall clock); the training engine's ``/metrics`` by its ``train_*``
families. HTTP servers bind port 0 on 127.0.0.1.
"""
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.telemetry import MetricRegistry as JaxRegistry
from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                           DeepSpeedInferenceConfig,
                                           InferenceEngine)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.module_inject.from_jax import gpt2_params_from_flax
from deepspeed_tpu_torch.telemetry import MetricRegistry
from deepspeed_tpu_torch.telemetry.exporter import ROUTES

PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13],
           [20, 21], [30]]
# JAX's executable cost (flops, HBM bytes) has no counterpart in the port
NO_COUNTERPART = {"jit_executable_flops", "jit_executable_hbm_bytes"}


class TickClock:
    """A server clock that advances 1 ms at every read."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


class StepClock:
    """A server clock that moves only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def models():
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=128, n_positions=256, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return (jcfg, jp), (tcfg, params_from_numpy(jax.device_get(jp), "cpu",
                                                torch.float32))


def _servers(models, clocks, fault=None, **knobs):
    """One server of each package over the same weights and config."""
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32,
                num_slots=2)
    conf.update(knobs)
    (jcfg, jp), (tcfg, tp) = models
    jsrv = JaxServer(JaxEngine((jcfg, jp), JaxConfig(**conf)),
                     registry=JaxRegistry(), clock=clocks[0],
                     fault_injector=fault[0] if fault else None)
    tsrv = ContinuousBatchingServer(
        InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                        device="cpu"),
        registry=MetricRegistry(), clock=clocks[1],
        fault_injector=fault[1] if fault else None)
    return jsrv, tsrv


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def _span_tree(span):
    return (span["name"], sorted(span["attributes"].items()),
            [_span_tree(c) for c in span["children"]])


ARMED = dict(
    enable_load_shedding=True,
    telemetry={
        "trace_sample_rate": 1.0, "http_port": 0,
        "slo": {"enabled": True, "queue_wait_p90_s": 30.0,
                "eval_interval_s": 0.0, "window_s": 5.0,
                "objectives": {"tight": {
                    "signal": "decode_p90_s", "threshold": 0.0005,
                    "fast_window_s": 0.05, "slow_window_s": 0.2}}},
        "canary": {"enabled": True, "interval_s": 0.05, "timeout_s": 30.0},
        "incident": {"enabled": True, "max_incidents": 4},
    })


def _serve_armed(srv):
    ids = [srv.submit(p, max_new_tokens=6, tenant=f"t{i % 2}")
           for i, p in enumerate(PROMPTS)]
    srv.drain()
    # idle steps: the canary scores its last probe, and probes again
    for _ in range(4):
        srv.step()
    srv.drain()
    return ids


def test_armed_server_matches_jax(models):
    """Every piece armed (tracing, SLO with shedding and a tight
    objective, canary, incident, HTTP): the same tokens, costs,
    capacity, traces, profiler and accountant snapshots, registry
    families, alert and incident history as JAX's server."""
    jsrv, tsrv = _servers(models, (TickClock(), TickClock()), **ARMED)
    try:
        out = {}
        for name, srv in (("jax", jsrv), ("port", tsrv)):
            ids = _serve_armed(srv)
            st = srv.stats
            # the tracer's own clock is the wall clock: names, order and
            # attributes are compared
            traces = [_span_tree(t.to_dict()["root"])
                      for t in srv.tracer.traces()]
            inc = srv.incidents_snapshot()
            out[name] = _json({
                "tokens": [srv.result(i) for i in ids],
                "reasons": [srv.finish_reason(i) for i in ids],
                "costs": [srv.request_cost(i) for i in ids],
                "capacity": srv.capacity_snapshot(),
                "traces": traces,
                "step_profile": st["step_profile"],
                "kv_pool": st["kv_pool"],
                "accounting": st["accounting"],
                "alerts": inc["alerts"], "canary": inc["canary"],
                "incident_keys": [sorted(b) for b in
                                  inc["incidents"]["incidents"]],
                "incident_rules": [b.get("rule") for b in
                                   inc["incidents"]["incidents"]],
                "families": sorted(set(srv.telemetry.snapshot())
                                   - NO_COUNTERPART),
                "slo": st["slo_compliance"],
                "stats_keys": sorted(st),
            })
        port, jax_ = out["port"], out["jax"]
        assert port["tokens"] == jax_["tokens"]
        for key in jax_:
            assert port[key] == jax_[key], key
        # the tight objective fired and left an incident; the canary ran
        assert port["alerts"]["fired_total"] >= 1
        assert port["incident_keys"]
        assert port["canary"]["results"]["success"] >= 1
        # every request's trace covers its phases
        names = {t[0] for t in port["traces"]} | {
            c[0] for t in port["traces"] for c in t[2]}
        assert {"request", "queue_wait", "admission", "prefill",
                "decode", "finish"} <= names
        # every route answers, as JAX's; /debug/* JSON parses
        for path in ROUTES:
            url = f"http://127.0.0.1:{tsrv.http_server.port}{path}"
            with urllib.request.urlopen(url, timeout=10) as r:
                assert r.status == 200
                body = r.read().decode()
                if r.headers["Content-Type"] == "application/json":
                    json.loads(body)
        port_http = tsrv.http_server
    finally:
        jsrv.close()
        tsrv.close()
    assert tsrv.http_server is None
    assert not port_http._thread.is_alive()   # joined: the port is free


def test_default_config_builds_jax_s_instruments(models):
    """JAX's default: the step profiler, the KV-pool accountant, the
    request ledger and the capacity model are built (no tracing, SLO,
    canary, incident or HTTP); ``step_profile: false`` builds none of
    them and registers none of their families, as JAX's server."""
    for knobs in ({}, {"telemetry": {"step_profile": False}},
                  {"telemetry": {"accounting": {"enabled": False}}}):
        jsrv, tsrv = _servers(models, (TickClock(), TickClock()), **knobs)
        got = {}
        for name, srv in (("jax", jsrv), ("port", tsrv)):
            ids = [srv.submit(p, max_new_tokens=4) for p in PROMPTS[:3]]
            srv.drain()
            built = [x is not None for x in (
                srv._profiler, srv._pool_acct, srv._ledger, srv._capacity,
                srv.tracer, srv.slo, srv.alerts, srv.canary, srv.incidents,
                srv.http_server, srv._fi)]
            got[name] = _json((built, [srv.result(i) for i in ids],
                               [srv.request_cost(i) for i in ids],
                               sorted(set(srv.telemetry.snapshot())
                                      - NO_COUNTERPART)))
            srv.close()
        assert got["port"] == got["jax"], knobs


def test_shedding_decisions_match_jax(models):
    """SLO-driven load shedding on a one-slot server whose queue wait
    breaches a tight objective: the same requests shed, the same finish
    reasons and tokens; JAX's error when shedding lacks its objective."""
    knobs = dict(num_slots=1, enable_load_shedding=True, telemetry={
        "slo": {"enabled": True, "queue_wait_p90_s": 0.5,
                "eval_interval_s": 0.0, "window_s": 5.0}})
    clocks = (StepClock(), StepClock())
    jsrv, tsrv = _servers(models, clocks, **knobs)
    got = {}
    for (name, srv), clock in zip((("jax", jsrv), ("port", tsrv)), clocks):
        ids = [srv.submit(p, max_new_tokens=3, priority=i % 2)
               for i, p in enumerate(PROMPTS)]
        for _ in range(40):
            clock.t += 0.4
            srv.step()
            if srv.scheduler.idle:
                break
        srv.drain()
        got[name] = ([srv.finish_reason(i) for i in ids],
                     [srv.result(i) for i in ids], srv.stats["shed"])
        srv.close()
    assert got["port"] == got["jax"]
    assert got["port"][2] > 0
    bad = dict(dtype="float32", enable_load_shedding=True)
    with pytest.raises(ValueError, match="queue_wait_p90_s"):
        ContinuousBatchingServer(InferenceEngine(
            models[1], DeepSpeedInferenceConfig(**bad), device="cpu"))


def test_fault_schedule_matches_jax(models):
    """A seeded fault schedule (prefill failures, a wedged request, a
    famine, a slow step) through both servers: the same finish reasons,
    partial outputs and injector snapshot; a bounded drain reaps the
    wedge; the famine's reservation goes back at close()."""
    fi = {"enabled": True, "seed": 3, "prefill_failure_rate": 0.3,
          "wedge_nth_request": 4, "famine_blocks": 2,
          "step_latency_s": 0.01}
    clocks = (StepClock(), StepClock())
    jsrv, tsrv = _servers(models, clocks,
                          telemetry={"fault_injection": fi})
    got = {}
    for (name, srv), clock in zip((("jax", jsrv), ("port", tsrv)), clocks):
        ids = [srv.submit(p, max_new_tokens=5) for p in PROMPTS]
        for _ in range(30):
            srv.step()
            clock.t += 0.01
        srv.drain(timeout_s=0.0)
        got[name] = _json(([srv.finish_reason(i) for i in ids],
                           [srv.result(i) for i in ids],
                           srv.stats["fault_injection"],
                           srv.stats["failed"], srv.stats["cancelled"]))
        assert srv.scheduler.allocator.reserved_blocks == 2
        srv.close()
        if srv is tsrv:
            assert srv.scheduler.allocator.reserved_blocks == 0
    assert got["port"] == got["jax"]
    assert "failed" in got["port"][0] and "cancelled" in got["port"][0]


def test_generate_traces_match_jax(models):
    """``generate`` with ``trace_sample_rate`` 1: a ``generate`` root with
    ``prefill_dispatch``, ``decode_dispatch`` and ``fetch`` children and
    JAX's attributes; the same tokens; the compile watch names the
    prefill program as JAX's."""
    conf = dict(dtype="float32", max_out_tokens=256,
                telemetry={"trace_sample_rate": 1.0})
    (jcfg, jp), (tcfg, tp) = models
    jeng = JaxEngine((jcfg, jp), JaxConfig(**conf))
    teng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                           device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    assert teng.generate(prompts, max_new_tokens=5) == \
        jeng.generate(prompts, max_new_tokens=5)
    trees = [[_span_tree(t.to_dict()["root"]) for t in e.tracer.traces()]
             for e in (teng, jeng)]
    assert trees[0] == trees[1]
    assert [c[0] for c in trees[0][0][2]] == [
        "prefill_dispatch", "decode_dispatch", "fetch"]
    assert teng._prefill_w.name == "infer_prefill"
    assert teng._prefill_w._cache_size() == 1


TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture
def private_registries():
    """Each package's process registry swapped for an empty one: the
    training engines record there, and other tests' families must not
    reach their ``/metrics``."""
    import deepspeed_tpu.telemetry as jtel
    import deepspeed_tpu_torch.telemetry as ptel
    prev = (jtel.set_registry(JaxRegistry()),
            ptel.set_registry(MetricRegistry()))
    try:
        yield
    finally:
        jtel.set_registry(prev[0])
        ptel.set_registry(prev[1])


def test_training_engine_traces_and_metrics_match_jax(private_registries):
    """The training engine with tracing, goodput and the HTTP endpoint:
    one ``train_step`` trace per step with JAX's children and
    attributes, and ``/metrics`` over HTTP with JAX's ``train_*``
    families; a taken port is a warning, never a failed init."""
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                      dtype=jnp.float32))
    flax_params = jax.device_get(jmodel.init(jax.random.PRNGKey(1),
                                             batch_size=2, seq_len=64))
    ds = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 1, "steps_per_print": 1,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "telemetry": {"trace_sample_rate": 1.0, "http_port": 0,
                        "goodput": True}}
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=flax_params, config=dict(ds),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
            **TINY, dtype=torch.float32)),
        model_parameters=gpt2_params_from_flax(flax_params),
        config=dict(ds), device="cpu")
    rng = np.random.default_rng(0)
    try:
        for _ in range(2):
            b = {"input_ids": rng.integers(0, 96, (2, 64)).astype(np.int32)}
            jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
            teng.train_batch(b)

        def view(eng):
            trees = []
            for t in eng.tracer.traces():
                d = t.to_dict()["root"]
                trees.append((d["name"], sorted(d["attributes"].items()),
                              [c["name"] for c in d["children"]]))
            url = f"http://127.0.0.1:{eng._telemetry_http.port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                text = r.read().decode()
            fams = sorted({ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE train_")})
            return trees, fams
        tv, jv = view(teng), view(jeng)
        assert tv[0] == jv[0]
        assert len(tv[0]) == 2 and all(
            t[0] == "train_step" and "host" in t[2] for t in tv[0])
        assert {"train_loss", "train_lr", "train_samples"} <= set(tv[1])
        assert tv[1] == jv[1]
        assert teng._micro_grads_w._cache_size() == 1
        # a port that is already taken: a warning, and training goes on
        busy = dict(ds, telemetry={"http_port": teng._telemetry_http.port})
        other, _, _, _ = deepspeed_tpu_torch.initialize(
            model=port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
                **TINY, dtype=torch.float32)),
            model_parameters=gpt2_params_from_flax(flax_params),
            config=busy, device="cpu")
        assert other._telemetry_http is None
        other.destroy()
    finally:
        teng.destroy()
        jeng.destroy()
    assert teng._telemetry_http is None


def _reaches(roots, target, limit=200000):
    """Whether ``target`` is strongly reachable from ``roots``
    (``gc.get_referents``, breadth first; modules and classes are not
    followed)."""
    import gc
    import types
    seen, todo = set(), list(roots)
    while todo and len(seen) < limit:
        obj = todo.pop()
        if obj is target:
            return True
        if id(obj) in seen or isinstance(obj, (types.ModuleType, type)):
            continue
        seen.add(id(obj))
        todo.extend(gc.get_referents(obj))
    return False


@pytest.mark.parametrize("owner", ["server", "armed server", "generate",
                                   "train"])
def test_the_plane_holds_its_owner_weakly(models, owner):
    """What an owner hands the plane (the compile watch's programs, the
    capacity model's, alerts', the canary's, incidents' and the
    endpoint's callables) holds the owner weakly: no reference cycle
    keeps an engine's weights or a server's pool on the device after the
    owner's last reference goes (a cycle waits for the collector)."""
    (_, _), (tcfg, tp) = models
    if owner == "train":
        model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
            **TINY, dtype=torch.float32))
        obj, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=model.init(
                torch.Generator().manual_seed(0)),
            config={"train_micro_batch_size_per_gpu": 2,
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
            device="cpu")
        obj.train_batch({"input_ids": np.zeros((2, 64), np.int32)})
        plane = [obj._micro_grads_w, obj._registry_sink, obj.monitor]
    else:
        conf = dict(dtype="float32", max_out_tokens=256, block_size=32,
                    num_slots=2)
        if owner != "server":
            conf.update(ARMED)
        eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                              device="cpu")
        if owner == "generate":
            obj = eng
            obj.generate([[1, 2, 3]], max_new_tokens=3)
            plane = [obj._prefill_w, obj._decode_w, obj.tracer]
        else:
            obj = ContinuousBatchingServer(eng, registry=MetricRegistry(),
                                           clock=TickClock())
            obj.submit([1, 2, 3], max_new_tokens=3)
            obj.drain()
            plane = [obj._watch, obj._profiler, obj._pool_acct,
                     obj._ledger, obj._capacity, obj.tracer, obj.slo,
                     obj.alerts, obj.canary, obj.incidents, obj.http_server,
                     obj.profiler_capture]
    try:
        assert not _reaches([p for p in plane if p is not None], obj)
    finally:
        if isinstance(obj, ContinuousBatchingServer):
            obj.close()
        elif owner == "train":   # unregisters its /debug/numerics watch
            obj.destroy()
