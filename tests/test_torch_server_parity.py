"""The port's ContinuousBatchingServer against the JAX server on the CPU,
token for token.

Each case builds the same model in both packages (float32, the sizes of
tests/test_continuous_batching.py:21-31: 2 layers, ``n_embd`` 32, block
size 32), drives both servers through the same submits, steps, cancels and
clock moves, and requires the same outputs and finish reasons. The port's
server must also equal the port's own one-shot ``generate`` (a prefix of
it for a request a lifecycle action cut short) — the oracle the JAX tests
hold the JAX server to.

The KV-tiering cases (int8 pools, the host tier) are held to the JAX
server token for token and to its ``kv_tier`` demotion and swap-in counts;
the int8 ones are not compared with ``generate`` (its dense cache is full
precision), and none with an fp run: chunked prefill over an int8 pool
reads quantized prefix keys where monolithic prefill attends exact ones,
so the two may part on a near-tie. The offload cases replay
tests/test_kv_tiering.py:491's famine recipe (three 96-token prefixes
through a 2-slot pool of 4 blocks a slot).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                           DeepSpeedInferenceConfig,
                                           InferenceEngine)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy

# tests/test_continuous_batching.py:34-35
PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13],
           [20, 21], [30], [40, 41, 42, 43, 44], [50, 51]]
SHARED = [1 + (i * 7) % 120 for i in range(70)]
VARIANTS = {
    "gpt2": dict(),
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False),
    "alibi": dict(positional="alibi"),
    "windowed": dict(local_windows=(None, 4)),
}


class FakeClock:
    """Injectable server clock that moves only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _engines(variant, knobs, seed=0):
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=128, n_positions=256, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32, **VARIANTS[variant])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.float32)
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32)
    conf.update(knobs)
    return (JaxEngine((jcfg, jp), JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


def _plain(srv, clock):
    ids = [srv.submit(p, max_new_tokens=6) for p in PROMPTS]
    srv.drain()
    return ids, PROMPTS, 6


def _staggered(srv, clock):
    """Submit half, step, submit the rest mid-flight."""
    ids = [srv.submit(p, max_new_tokens=8) for p in PROMPTS[:4]]
    for _ in range(3):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=8) for p in PROMPTS[4:]]
    srv.drain()
    return ids, PROMPTS, 8


def _shared_prefix(srv, clock):
    """Prompts sharing a 70-token prefix with distinct tails, the first
    one prefilled before the rest arrive (their full blocks hit)."""
    prompts = [SHARED + [100 + i] * (i + 1) for i in range(5)] + PROMPTS[:3]
    ids = [srv.submit(prompts[0], max_new_tokens=6)]
    for _ in range(4):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=6) for p in prompts[1:]]
    srv.drain()
    assert srv.stats["prefix_cache_hits"] > 0
    return ids, prompts, 6


def _repetitive(srv, clock):
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5], [9, 8, 7, 9, 8],
               [4, 4, 4, 4], [10, 11, 12, 10, 11]]
    ids = [srv.submit(p, max_new_tokens=10) for p in prompts]
    srv.drain()
    return ids, prompts, 10


def _preemption(srv, clock):
    """A low-priority request preempted mid-decode by a high-priority
    arrival resumes and finishes (recompute preemption)."""
    a = srv.submit([1, 2, 3], max_new_tokens=10, priority=0)
    for _ in range(4):
        srv.step()
    b = srv.submit([4, 5, 6], max_new_tokens=4, priority=5)
    srv.drain()
    assert srv.stats["preempted"] == 1
    return [a, b], [[1, 2, 3], [4, 5, 6]], None


def _cancel_and_deadline(srv, clock):
    """A queued request expires, a decoding one is cancelled mid-flight
    and another expires mid-decode; the rest finish normally."""
    a = srv.submit([1, 2, 3], max_new_tokens=40)
    b = srv.submit([4, 5, 6], max_new_tokens=30, deadline_s=5.0)
    c = srv.submit([7, 8], max_new_tokens=20)
    d = srv.submit([9, 9, 9], max_new_tokens=4, deadline_s=1.0)
    for _ in range(5):
        srv.step()
    clock.t += 2.0                         # d (queued) expires
    srv.step()
    assert srv.cancel(c) is True           # c is decoding
    for _ in range(3):
        srv.step()
    clock.t += 10.0                        # b expires mid-decode
    srv.drain()
    st = srv.stats
    assert (st["cancelled"], st["deadline_expired"]) == (1, 2)
    return [a, b, c, d], [[1, 2, 3], [4, 5, 6], [7, 8], [9, 9, 9]], None


CASES = {
    # name: (variant, server knobs, num_slots, scenario)
    "default": ("gpt2", {}, 4, _plain),
    "sync-loop": ("gpt2", {"async_loop": False}, 4, _staggered),
    "lag-3": ("gpt2", {"max_commit_lag": 3}, 4, _staggered),
    "chunked+prefix": ("gpt2", {"enable_prefix_caching": True,
                                "prefill_chunk_tokens": 32}, 2,
                       _shared_prefix),
    "chain+prefix": ("gpt2", {"enable_prefix_caching": True,
                              "prefill_chunk_tokens": 32,
                              "prefill_chain": True}, 2, _shared_prefix),
    "speculation-k4": ("gpt2", {"speculation_tokens": 4}, 4, _repetitive),
    "eos": ("gpt2", {}, 4, None),
    "preemption": ("gpt2", {}, 1, _preemption),
    "cancel+deadline": ("gpt2", {}, 2, _cancel_and_deadline),
    "gqa-rotary lag-3": ("gqa-rotary", {"max_commit_lag": 3}, 4, _staggered),
    "alibi chunked+prefix": ("alibi", {"enable_prefix_caching": True,
                                       "prefill_chunk_tokens": 32}, 2,
                             _shared_prefix),
    "windowed speculation": ("windowed", {"speculation_tokens": 3}, 4,
                             _repetitive),
}


def _famine(srv, clock):
    """tests/test_kv_tiering.py:491: three rotating 96-token prefixes, one
    request at a time, through a pool too small to park all three."""
    ids, prompts = [], []
    for i in range(6):
        prompts.append(FAMINE_PREFIXES[i % 3] + [7 + i, 9])
        ids.append(srv.submit(prompts[-1], max_new_tokens=4))
        srv.drain()
    return ids, prompts, 4


FAMINE_PREFIXES = [[1 + (s * 7 + i) % 120 for i in range(96)]
                   for s in range(3)]
OFFLOAD = {"enable_prefix_caching": True, "kv_host_offload": True,
           "max_out_tokens": 128}
TIER_CASES = {
    # name: (server knobs, num_slots, scenario)
    "int8": ({"kv_cache_dtype": "int8"}, 4, _plain),
    "int8 chunked+prefix": ({"kv_cache_dtype": "int8",
                             "enable_prefix_caching": True,
                             "prefill_chunk_tokens": 32}, 2, _shared_prefix),
    "int8 speculation-k4": ({"kv_cache_dtype": "int8",
                             "speculation_tokens": 4}, 4, _repetitive),
    "fp offload famine": (OFFLOAD, 2, _famine),
    "int8 offload famine": ({**OFFLOAD, "kv_cache_dtype": "int8"}, 2,
                            _famine),
}


def _serve(server_cls, eng, scenario):
    clock = FakeClock()
    srv = server_cls(eng, clock=clock)
    ids, prompts, new = scenario(srv, clock)
    out = ([srv.result(i) for i in ids], [srv.finish_reason(i) for i in ids])
    st = srv.stats
    srv.close()
    return out, st, prompts, new


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tiered_server_matches_jax_server(case):
    knobs, slots, scenario = TIER_CASES[case]
    je, te = _engines("gpt2", {**knobs, "num_slots": slots})
    j_out, j_st, _, _ = _serve(JaxServer, je, scenario)
    t_out, t_st, prompts, new = _serve(ContinuousBatchingServer, te, scenario)
    assert t_out == j_out
    tier = ("kv_dtype", "host_offload", "demotions", "swap_ins",
            "host_blocks", "host_dropped")
    assert ({k: t_st["kv_tier"][k] for k in tier}
            == {k: j_st["kv_tier"][k] for k in tier})
    assert t_st["prefix_cache_evictions"] == j_st["prefix_cache_evictions"]
    int8 = knobs.get("kv_cache_dtype") == "int8"
    assert t_st["kv_tier"]["kv_dtype"] == ("int8" if int8 else "fp")
    if "famine" in case:
        # demotion before eviction or preemption, and swap-ins on the hits
        assert t_st["kv_tier"]["demotions"] > 0
        assert t_st["kv_tier"]["swap_ins"] > 0
        assert t_st["kv_tier"]["host_bytes"] > 0
        assert t_st["prefix_cache_evictions"] == t_st["preempted"] == 0
    if not int8:
        for out, p in zip(t_out[0], prompts):
            assert out == te.generate([p], max_new_tokens=new)[0]
    if case == "int8 offload famine":
        # tiering is invisible to content: the same int8 server with a pool
        # big enough that nothing demotes serves the same tokens
        _, ge = _engines("gpt2", {**knobs, "num_slots": 4,
                                  "max_out_tokens": 256,
                                  "kv_host_offload": False})
        g_out, g_st, _, _ = _serve(ContinuousBatchingServer, ge, scenario)
        assert g_st["kv_tier"]["demotions"] == 0
        assert g_out == t_out


def test_int8_pool_is_smaller_and_counts_its_scales():
    """``kv_tier.pool_bytes`` counts the int8 payload and both scale tiles:
    int8 + f32 scales against the f32 test pool, same geometry."""
    nbytes = {}
    for dt in ("fp", "int8"):
        _, te = _engines("gpt2", {"kv_cache_dtype": dt, "num_slots": 2})
        srv = ContinuousBatchingServer(te)
        c = srv._cache
        nbytes[dt] = srv.stats["kv_tier"]["pool_bytes"]
        if dt == "int8":
            assert c.k.dtype == torch.int8 and c.quantized
            assert nbytes[dt] == (c.k.numel() * 2 + c.k_scale.numel() * 8)
        srv.close()
    D = 32 // 4
    assert nbytes["int8"] * (4 * D) == nbytes["fp"] * (D + 4)


def _eos_case(je, srv, clock):
    """Requests that stop on an EOS token (one on the very first token)."""
    ref = je.generate([[1, 2, 3, 4]], max_new_tokens=8)[0]
    eos, first = ref[5], ref[4]
    ids = [srv.submit([1, 2, 3, 4], max_new_tokens=8, eos_token_id=eos),
           srv.submit([1, 2, 3, 4], max_new_tokens=8, eos_token_id=first),
           srv.submit([7, 8], max_new_tokens=8, eos_token_id=eos)]
    srv.drain()
    return ids, [[1, 2, 3, 4], [1, 2, 3, 4], [7, 8]], None


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_matches_jax_server_and_generate(case):
    variant, knobs, slots, scenario = CASES[case]
    je, te = _engines(variant, {**knobs, "num_slots": slots})
    results = []
    for server_cls, eng in ((JaxServer, je), (ContinuousBatchingServer, te)):
        clock = FakeClock()
        srv = server_cls(eng, clock=clock)
        if scenario is None:
            ids, prompts, new = _eos_case(je, srv, clock)
        else:
            ids, prompts, new = scenario(srv, clock)
        results.append(([srv.result(i) for i in ids],
                        [srv.finish_reason(i) for i in ids]))
        srv.close()
    (j_out, j_why), (t_out, t_why) = results
    assert t_out == j_out
    assert t_why == j_why
    # the port's server against the port's own one-shot generate
    for out, p, why in zip(t_out, prompts, t_why):
        budget = new if new is not None else len(out) - len(p)
        ref = te.generate([p], max_new_tokens=max(budget, 1))[0]
        assert out == ref[:len(out)], (case, p)
        if why == "length" and new is not None:
            assert len(out) == len(p) + new
