"""The serving observability plane on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: the step graphs and the kernels
have no CPU mode. The file imports no JAX (nor the tests' conftest, which
does), so it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_observe.py -q

A small bf16 GPT-2 (2 layers, 4 heads of 64) is served with the plane
armed — request tracing, an SLO with load shedding and a tight objective,
burn-rate alerts, the canary, incident bundles, the HTTP endpoint — and
must serve the tokens of the same requests through an unarmed eager
server (the plane reads host state only: it changes no program). The
decode graph is captured once with the step profiler and once without;
steady-state steps with the profiler, the ledger and tracing on read
nothing back to the host; a seeded fault schedule ends each request as
the same schedule does on the CPU.
"""
import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import ContinuousBatchingServer
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, init_params)
from deepspeed_tpu_torch.telemetry import MetricRegistry
from deepspeed_tpu_torch.telemetry.exporter import ROUTES

ARMED = {
    "trace_sample_rate": 1.0, "http_port": 0,
    "slo": {"enabled": True, "queue_wait_p90_s": 600.0,
            "eval_interval_s": 0.0,
            "objectives": {"tight": {"signal": "decode_p90_s",
                                     "threshold": 1e-6,
                                     "fast_window_s": 0.5,
                                     "slow_window_s": 1.0}}},
    "canary": {"enabled": True, "interval_s": 0.05},
    "incident": {"enabled": True},
}
FAULTS = {"enabled": True, "seed": 3, "prefill_failure_rate": 0.3,
          "wedge_nth_request": 4, "famine_blocks": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step graphs and the kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _model(device):
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=512,
                                     n_embd=256, n_layer=2, n_head=4)
    return cfg, init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)


def _server(model, device, graphs=True, clock=None, dtype="bfloat16",
            **knobs):
    conf = dict(dtype=dtype, block_size=32, max_out_tokens=256,
                num_slots=4)
    conf.update(knobs)
    eng = deepspeed_tpu_torch.init_inference(model, device=device, **conf)
    srv = ContinuousBatchingServer(eng, registry=MetricRegistry(),
                                   clock=clock)
    srv._cuda_graphs = graphs and device.type == "cuda"
    return srv


def _prompts(n=6):
    rng = np.random.default_rng(7)
    return [rng.integers(1, 512, k).tolist() for k in rng.integers(4, 90, n)]


def _serve(srv, prompts, new=12, steps_between=3):
    ids = [srv.submit(p, max_new_tokens=new) for p in prompts[:3]]
    for _ in range(steps_between):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=new) for p in prompts[3:]]
    out = srv.drain()
    return [out[r] for r in ids]


@pytest.mark.cuda
def test_armed_plane_serves_the_eager_runs_tokens(cuda_device):
    """Every piece armed, graphs on: the tokens of an unarmed eager server;
    the endpoint answers every route; the tight objective fired and left
    an incident; the canary scored only successes; close() joins the
    endpoint's thread and frees its port."""
    model = _model(cuda_device)
    armed = _server(model, cuda_device, enable_load_shedding=True,
                    telemetry=ARMED)
    got = _serve(armed, _prompts())
    for _ in range(4):   # the canary scores its last probe
        armed.step()
    armed.drain()
    port = armed.http_server.port
    for path in ROUTES:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            assert r.status == 200
            if r.headers["Content-Type"] == "application/json":
                json.loads(r.read().decode())
    st = armed.stats
    assert st["alerts"]["fired_total"] == 1
    assert st["incidents"]["captured_total"] == 1
    canary = st["canary"]
    assert canary["results"]["success"] == canary["probes"] >= 1
    assert st["decode_traces"] == 1
    thread = armed.http_server._thread
    armed.close()
    assert not thread.is_alive()
    with socket.socket() as s:   # no listener holds the port again
        # (SO_REUSEADDR, as http.server binds: the scrapes' closed
        # connections may still be in TIME_WAIT)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
    plain = _server(model, cuda_device, graphs=False)
    ref = _serve(plain, _prompts())
    plain.close()
    assert got == ref


@pytest.mark.cuda
def test_decode_graph_is_the_same_with_and_without_the_profiler(
        cuda_device):
    """The step profiler and the ledger add no program: one decode graph
    is captured either way, replayed with the same launches, and the two
    servers serve the same tokens."""
    model = _model(cuda_device)
    runs = []
    for tel in ({}, {"step_profile": False,
                     "accounting": {"enabled": False}}):
        srv = _server(model, cuda_device, telemetry=tel)
        out = _serve(srv, _prompts())
        g = srv._graphs["decode"]
        runs.append((out, srv.stats["decode_traces"],
                     g.snapshot()["launches_per_replay"],
                     srv._profiler is not None))
        srv.close()
    assert runs[0][:3] == runs[1][:3]
    assert runs[0][1] == 1 and runs[0][3] and not runs[1][3]


@pytest.mark.cuda
def test_steady_state_steps_with_the_plane_add_no_host_sync(cuda_device):
    """Steady-state (pipelined) decode steps with the profiler, the
    ledger, the capacity model, tracing and the SLO monitor on, under
    ``set_sync_debug_mode("error")``: the plane reads device time only
    where the loop already waits."""
    model = _model(cuda_device)
    srv = _server(model, cuda_device, telemetry={
        "trace_sample_rate": 1.0,
        "slo": {"enabled": True, "queue_wait_p90_s": 600.0,
                "eval_interval_s": 0.0}})
    ids = [srv.submit(p, max_new_tokens=24) for p in ([1, 2, 3],
                                                      list(range(100)))]
    for _ in range(4):   # admission and prefill read tokens back by design
        srv.step()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(6):
            srv.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = srv.drain()
    prof = srv.stats["step_profile"]
    srv.close()
    assert all(len(out[r]) == n + 24 for r, n in zip(ids, (3, 100)))
    assert prof["commit_lag"]["pipelined_steps"] > 0
    assert abs(sum(prof["phases_s"].values()) - prof["wall_s"]) <= \
        1e-6 * prof["wall_s"]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.cuda
def test_fault_schedule_ends_requests_as_on_the_cpu(cuda_device):
    """A seeded fault schedule (prefill failures, a wedged request, a
    famine) on the card ends every request with the finish reason the
    same schedule gives the port on the CPU (float32 there); close() hands
    the famine's reserved blocks back."""
    reasons = {}
    for dev in (cuda_device, torch.device("cpu")):
        # no EOS: the reasons do not depend on the weights' values
        clock = _Clock()
        srv = _server(_model(dev), dev, clock=clock,
                      dtype="float32" if dev.type == "cpu" else "bfloat16",
                      telemetry={"fault_injection": FAULTS})
        ids = [srv.submit(q, max_new_tokens=8) for q in _prompts()]
        for _ in range(30):
            srv.step()
            clock.t += 0.01
        srv.drain(timeout_s=0.0)
        reasons[dev.type] = [srv.finish_reason(r) for r in ids]
        assert srv.scheduler.allocator.reserved_blocks == 2
        srv.close()
        assert srv.scheduler.allocator.reserved_blocks == 0
    assert reasons["cuda"] == reasons["cpu"]
    assert "failed" in reasons["cuda"] and "cancelled" in reasons["cuda"]
