"""State that keeps its address: what the decode step's CUDA graph needs,
checked on the CPU.

A CUDA graph bakes in device addresses, so the port's KV cache and pool
writers update ``lengths``, ``block_tables``, k/v and the int8 scale tiles
in place (``inference/cuda_graph.py``). Here, on the CPU where nothing is
captured:

* the server's pool tensors keep their ``data_ptr`` through every kind of
  step the server takes: admission, chunked prefill with prefix caching,
  decode under the lag-1 and lag-2 loops, speculative verify and its
  commit, retirement and host-tier swap-ins (small float32 model, 2
  layers);
* ``generate`` keeps one dense cache per (batch, cache length) and serves
  the same tokens from a kept cache that an earlier call left dirty;
* the in-place ``advance``, ``paged_advance`` and ``write_prompt`` still
  equal the JAX package's functions on the same numpy inputs;
* the trace counters read -1 and no graph is made on the CPU; the list of
  counted kernel wrappers is the one every wrapper is on.

The server's tokens against the JAX server's stay with
``tests/test_torch_server_parity.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import kv_cache as jax_kv
from deepspeed_tpu_torch.inference import ContinuousBatchingServer
from deepspeed_tpu_torch.inference import kv_cache as port_kv
from deepspeed_tpu_torch.inference.server import _pool_tensors, _upload
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, init_params)
from deepspeed_tpu_torch.ops import (block_sparse_attention,
                                     decode_attention, flash_attention,
                                     launch_counters, layer_norm)


def _engine(**knobs):
    cfg = InferenceTransformerConfig(vocab_size=128, n_positions=256,
                                     n_embd=32, n_layer=2, n_head=4,
                                     dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    conf = dict(dtype="float32", device="cpu", block_size=32,
                max_out_tokens=128, num_slots=2)
    conf.update(knobs)
    return deepspeed_tpu_torch.init_inference((cfg, params), **conf)


PREFIXES = [[1 + (s * 7 + i) % 120 for i in range(96)] for s in range(3)]
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5], list(range(40, 80)),
           [9, 8, 7, 9, 8]]


def _staggered(srv):
    for p in PROMPTS[:2]:
        srv.submit(p, max_new_tokens=10)
    yield
    for _ in range(3):
        srv.step()
        yield
    for p in PROMPTS[2:]:
        srv.submit(p, max_new_tokens=10)
    while not srv.scheduler.idle:
        srv.step()
        yield


def _famine(srv):
    for i in range(6):
        srv.submit(PREFIXES[i % 3] + [7 + i, 9], max_new_tokens=4)
        while not srv.scheduler.idle:
            srv.step()
            yield


CASES = {
    "chunked prefix lag 1": ({"enable_prefix_caching": True,
                              "prefill_chunk_tokens": 32}, _staggered),
    "lag 2": ({"max_commit_lag": 2}, _staggered),
    "speculation K=4": ({"speculation_tokens": 4}, _staggered),
    "int8 offload swap-in": ({"kv_cache_dtype": "int8",
                              "enable_prefix_caching": True,
                              "kv_host_offload": True}, _famine),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_keeps_its_addresses_through_the_server_loop(case):
    knobs, scenario = CASES[case]
    srv = ContinuousBatchingServer(_engine(**knobs))
    cache = srv._cache
    ptrs = [t.data_ptr() for t in _pool_tensors(cache) if t is not None]
    steps = 0
    for _ in scenario(srv):
        steps += 1
        assert srv._cache is cache
        assert [t.data_ptr() for t in _pool_tensors(cache)
                if t is not None] == ptrs
    srv.drain()
    st = srv.stats
    assert steps > 5 and st["decode_steps"] > 0
    if "swap-in" in case:
        assert st["kv_tier"]["swap_ins"] > 0
    if "chunked" in case:
        assert st["prefill_chunks"] > 0
    if "speculation" in case:
        assert st["speculation"]["verify_steps"] > 0
    if "lag 2" in case:
        assert st["async_loop"]["pipelined_steps"] > 0
    # nothing is captured on the CPU: no graph, and JAX's "unknown"
    assert srv._graphs == {} and not srv._cuda_graphs
    assert st["decode_traces"] == st["retraces"] == -1
    assert st["speculation"]["verify_traces"] == (
        -1 if "speculation" in case else 0)
    srv.close()


def test_generate_keeps_one_dense_cache_and_its_tokens():
    eng = _engine()
    prompts = [[1, 2, 3], list(range(10, 50))]
    first = eng.generate(prompts, max_new_tokens=12)
    key, cache, graph = eng._kept
    assert graph is None and not eng._cuda_graphs
    ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.lengths)]
    # the kept cache now holds the first call's keys past every length
    assert eng.generate(prompts, max_new_tokens=12) == first
    assert eng._kept[1] is cache
    assert [t.data_ptr() for t in (cache.k, cache.v, cache.lengths)] == ptrs
    other = eng.generate([[4, 5]], max_new_tokens=4)
    assert eng._kept[0] != key and eng._kept[1] is not cache
    assert eng.generate([[4, 5]], max_new_tokens=4) == other
    assert eng.generate(prompts, max_new_tokens=12) == first


def test_in_place_writers_match_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 8, 2, 4), np.float32)
    v = rng.standard_normal((2, 8, 2, 4), np.float32)
    lens = np.array([8, 3], np.int32)
    jc = jax_kv.init_cache(2, 2, 16, 2, 4, jnp.float32)
    tc = port_kv.init_cache(2, 2, 16, 2, 4, torch.float32)
    ptr = tc.lengths.data_ptr()
    jc = jax_kv.write_prompt(jc, 0, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens))
    assert port_kv.write_prompt(tc, 0, torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.from_numpy(lens)) is tc
    jc = jax_kv.advance(jc, 3)
    assert port_kv.advance(tc, 3) is tc
    for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tc.lengths, jc.lengths)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tc.lengths.data_ptr() == ptr and tc.lengths.dtype == torch.int32

    jp = jax_kv.init_paged_cache(1, 3, 5, 4, 2, 2, 4, jnp.float32)
    tp = port_kv.init_paged_cache(1, 3, 5, 4, 2, 2, 4, torch.float32)
    start = np.array([5, 0, 2], np.int32)
    jp = jp.replace(lengths=jnp.asarray(start))
    tp.lengths.copy_(torch.from_numpy(start))
    ptr = tp.lengths.data_ptr()
    for active in ([True, True, True], [True, False, True]):
        act = np.array(active)
        jp = jax_kv.paged_advance(jp, jnp.asarray(act))
        assert port_kv.paged_advance(tp, torch.from_numpy(act)) is tp
    assert tp.lengths.data_ptr() == ptr
    np.testing.assert_array_equal(tp.lengths.numpy(),
                                  np.asarray(jp.lengths))


def test_upload_writes_into_its_buffer():
    buf = torch.zeros(4, dtype=torch.long)
    out = _upload(np.arange(4, dtype=np.int64), torch.device("cpu"), buf)
    assert out is buf and buf.tolist() == [0, 1, 2, 3]


def test_launch_counters_list_every_counted_wrapper():
    counted = {name for mod in (flash_attention, decode_attention,
                                block_sparse_attention, layer_norm)
               for name, fn in inspect.getmembers(mod, inspect.isfunction)
               if hasattr(fn, "launches")}
    counters = launch_counters()
    assert set(counters) == counted
    assert all(isinstance(f.launches, int) for f in counters.values())
