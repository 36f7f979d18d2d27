"""The decode and verify steps as CUDA graphs, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: a CUDA graph has no CPU mode. The
file imports no JAX (nor the tests' conftest, which does), so it runs on
the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

A small bf16 model (2 layers, 4 heads of 64) is served twice over the same
requests, once with the step graphs (the default on CUDA) and once eagerly
(the private ``_cuda_graphs`` switch), and the two must serve the same
tokens exactly: both run the same kernels on the same inputs in the same
order, a replay only launches them without Python in between. The server
cases: an fp pool, an int8 pool, the lag-2 loop, prompt-lookup speculation
K=4 (the verify graph) and host-tier swap-ins between steps (a pool too
small for three rotating 96-token prefixes). ``generate``: greedy and
sampled tokens the same with and without its graph, a replay that reads
nothing back to the host, one capture for repeated calls of one shape, and
the same logits bit for bit from one state, replayed and eager.
Launch counts stay counts of kernel executions: a capture takes back what
it counted and each replay adds the captured launches. A capture that
fails raises: nothing falls back to the eager path; a capture runs with the
Python garbage collector held off.
"""
import gc

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import ContinuousBatchingServer
from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, decode_step, init_params)
from deepspeed_tpu_torch.ops import launch_counters

L = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _engine(n_embd=256, **knobs):
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=512,
                                     n_embd=n_embd, n_layer=L, n_head=4)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    conf = dict(dtype="bfloat16", block_size=32, max_out_tokens=256,
                num_slots=4)
    conf.update(knobs)
    return deepspeed_tpu_torch.init_inference((cfg, params), **conf)


def _prompts(seed, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(k)).tolist()
            for k in rng.integers(3, 120, n)]


def _repetitive(seed, n=6):
    rng = np.random.default_rng(seed)
    phrase = rng.integers(1, 512, 12).tolist()
    return [rng.integers(1, 512, int(k)).tolist() + phrase * int(r)
            for k, r in zip(rng.integers(1, 20, n), rng.integers(2, 5, n))]


PREFIXES = [[1 + (s * 7 + i) % 500 for i in range(96)] for s in range(3)]


def _staggered(srv, prompts, new):
    """Half the requests, three steps, then the rest mid-flight."""
    half = len(prompts) // 2
    ids = [srv.submit(p, max_new_tokens=new) for p in prompts[:half]]
    for _ in range(3):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=new) for p in prompts[half:]]
    srv.drain()
    return ids


def _famine(srv, prompts, new):
    """Three rotating 96-token prefixes, one request at a time, through a
    pool too small to park all three: demotions and swap-ins between
    steps."""
    ids = []
    for p in prompts:
        ids.append(srv.submit(p, max_new_tokens=new))
        srv.drain()
    return ids


CASES = {
    # name: (engine knobs, prompts, scenario, step kind)
    "fp": ({}, _prompts(1), _staggered, "decode"),
    "int8": ({"kv_cache_dtype": "int8"}, _prompts(2), _staggered, "decode"),
    "lag 2": ({"max_commit_lag": 2}, _prompts(3), _staggered, "decode"),
    "speculation K=4": ({"speculation_tokens": 4}, _repetitive(4),
                        _staggered, "verify"),
    "swap-in": ({"enable_prefix_caching": True, "kv_host_offload": True,
                 "max_out_tokens": 128, "num_slots": 2},
                [PREFIXES[i % 3] + [7 + i, 9] for i in range(6)], _famine,
                "decode"),
}


def _serve(eng, graphs, prompts, scenario, new=12):
    srv = ContinuousBatchingServer(eng)
    srv._cuda_graphs = graphs
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    ids = scenario(srv, prompts, new)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    out = [srv.result(i) for i in ids]
    st = srv.stats
    snaps = {k: g.snapshot() for k, g in srv._graphs.items()}
    srv.close()
    return out, st, snaps, counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_server_serves_the_eager_tokens(cuda_device, case):
    knobs, prompts, scenario, kind = CASES[case]
    eng = _engine(**knobs)
    g_out, g_st, snaps, counts = _serve(eng, True, prompts, scenario)
    e_out, e_st, e_snaps, _ = _serve(eng, False, prompts, scenario)
    assert g_out == e_out
    assert e_snaps == {} and g_st["decode_steps"] == e_st["decode_steps"]
    snap = snaps[kind]
    assert snap["captures"] == 1 and snap["replays"] > 0
    # the trace counters read the graphs captured (-1 eagerly)
    traces = (g_st["decode_traces"] if kind == "decode"
              else g_st["speculation"]["verify_traces"])
    assert traces == 1 and g_st["retraces"] == 0
    assert e_st["decode_traces"] == e_st["retraces"] == -1
    int8 = "_int8" if knobs.get("kv_cache_dtype") == "int8" else ""
    kernel = f"paged_{kind}_attention{int8}"
    assert snap["launches_per_replay"] == {kernel: L}
    # launches count executions: the warm-up's and each replay's
    steps = ((g_st["decode_steps"] if kind == "decode"
              else g_st["speculation"]["verify_steps"])
             + g_st["async_loop"]["garbage_steps"])
    assert counts[kernel] == L * steps == L * (1 + snap["replays"])
    if case == "swap-in":
        assert g_st["kv_tier"]["swap_ins"] > 0
        assert g_st["kv_tier"] == e_st["kv_tier"]


@pytest.mark.cuda
def test_graphed_generate_matches_eager_and_reads_nothing_back(cuda_device):
    eng = _engine()
    prompts = _prompts(5, n=3)
    out = eng.generate(prompts, max_new_tokens=20)
    (key, cache, graph) = eng._kept
    assert graph.captures == 1 and graph.replays == 18
    assert eng.generate(prompts, max_new_tokens=20) == out
    assert eng._kept[1] is cache and graph.captures == 1
    assert graph.replays == 18 + 19
    sampled = eng.generate(prompts, max_new_tokens=20, temperature=0.8,
                           top_k=40, seed=3)
    eng._cuda_graphs = False
    assert eng.generate(prompts, max_new_tokens=20) == out
    assert eng.generate(prompts, max_new_tokens=20, temperature=0.8,
                        top_k=40, seed=3) == sampled
    assert graph.replays == 18 + 2 * 19
    eng._cuda_graphs = True
    n = launch_counters()["decode_attention"].launches
    step = eng._decode_fn(cache)
    tok = torch.zeros(key[0], dtype=torch.long, device=cuda_device)
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                tok = step(tok).argmax(-1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert launch_counters()["decode_attention"].launches == n + 3 * L
    # the same step from the same state, replayed and eager: the same bits
    # (cuBLAS chose the same kernels on the capture stream)
    lengths = cache.lengths.clone()
    with torch.inference_mode():
        replayed = step(tok)
        cache.lengths.copy_(lengths)
        eager = decode_step(eng.params, eng.model_config, tok, cache)[0]
    assert torch.equal(replayed, eager)


@pytest.mark.cuda
def test_padded_head_dim_raises_at_capture(cuda_device):
    """Head dim 36 (bf16 rows of 72 bytes) takes the padded route, which
    copies the whole pool each call: its capture raises, and the server
    does not fall back to the eager step."""
    eng = _engine(n_embd=144)
    srv = ContinuousBatchingServer(eng)
    srv.submit([1, 2, 3], max_new_tokens=8)
    with pytest.raises(RuntimeError, match="padded head-dim route"):
        for _ in range(8):
            srv.step()
    assert srv._graphs["decode"].replays == 0


@pytest.mark.cuda
def test_a_capture_that_syncs_raises(cuda_device):
    """A step that reads a device value on the host warms up eagerly and
    then fails its capture: the call raises; no eager result comes back."""
    x = torch.zeros(4, device=cuda_device)

    def step(t):
        t.add_(1)
        return t * float(t.sum().item())

    g = GraphedStep("syncs", step, (x,), lambda: ())
    assert g().sum().item() == 16.0
    with pytest.raises(RuntimeError):
        g()
    assert g.graph is None and g.replays == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_the_collector_is_held_off_during_a_capture(cuda_device):
    """Destroying a graph while another is captured invalidates that
    capture, and a cyclic collection during a capture may destroy an
    earlier runner's unreachable graph: the runner collects first and
    captures with the collector off, then turns it back on."""
    seen = []

    def step(t):
        seen.append(gc.isenabled())
        return t + 1

    g = GraphedStep("gc", step, (torch.zeros(4, device=cuda_device),),
                    lambda: ())
    g()
    assert g().sum().item() == 4.0 and g.captures == 1
    assert seen == [True, False] and gc.isenabled()
