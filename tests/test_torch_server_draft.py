"""Draft-model speculation in the port's server against the JAX server on
the CPU, token for token.

Target and draft are built in both packages with the same weights, drawn
with numpy from a seed each (the sizes of tests/test_deep_pipeline.py:62-82:
a 2-layer target of width 32 and a 1-layer draft of width 16 over one
vocabulary of 128, float32, blocks of 32). Each case drives both servers,
each with its draft engine, through the same submits and steps, and
requires the same outputs, the same speculation counters, and the port's
own greedy ``generate``'s tokens (a prefix of them for a request a
lifecycle action cut short).
The cases follow tests/test_server_speculation.py:81-215 and
tests/test_deep_pipeline.py:350-450: plain (the async loop and the
synchronous one), prefix caching with chunked prefill, preemption in the
middle of speculation, and a cancel.
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
from test_torch_speculative import numpy_params

PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13],
           [20, 21], [30]]
TARGET = dict(vocab_size=128, n_positions=256, n_embd=32, n_layer=2,
              n_head=4)
DRAFT = dict(vocab_size=128, n_positions=256, n_embd=16, n_layer=1,
             n_head=2)


def _pair(shape, seed, knobs):
    """(JAX engine, port engine) of ``shape``, weights from ``seed``."""
    jcfg = jt.InferenceTransformerConfig(dtype=jnp.float32, **shape)
    jp = numpy_params(jcfg, seed)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.float32)
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32,
                num_slots=4)
    conf.update(knobs)
    return (JaxEngine((jcfg, jp), JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


def _servers(**knobs):
    """(JAX server, port server), each with its draft engine."""
    jt_eng, pt_eng = _pair(TARGET, 0, dict(speculation_tokens=4, **knobs))
    jd, pd = _pair(DRAFT, 7, {})
    return (JaxServer(jt_eng, draft_engine=jd),
            ContinuousBatchingServer(pt_eng, draft_engine=pd))


def _serve(srv, prompts, budget, **kw):
    ids = [srv.submit(p, max_new_tokens=budget, **kw) for p in prompts]
    out = srv.drain()
    return [out[i] for i in ids]


def _spec(srv):
    sp = dict(srv.stats["speculation"])
    for k in ("verify_traces", "draft_prefill_traces",
              "draft_decode_traces"):
        sp.pop(k)
    return sp


@pytest.mark.parametrize("async_loop", [True, False])
def test_draft_server_matches_jax_and_generate(async_loop):
    jsrv, psrv = _servers(async_loop=async_loop)
    want = _serve(jsrv, PROMPTS, 12)
    got = _serve(psrv, PROMPTS, 12)
    assert got == want
    assert got == psrv.engine.generate(PROMPTS, max_new_tokens=12)
    sp = psrv.stats["speculation"]
    assert _spec(psrv) == _spec(jsrv)
    assert sp["draft"] == "model" and sp["accepted"] > 0
    # nothing is captured on the CPU: every trace counter reads -1
    assert (sp["verify_traces"], sp["draft_prefill_traces"],
            sp["draft_decode_traces"]) == (-1, -1, -1)
    assert sp["proposed"] == 3 * psrv._spec_slot_steps
    # every drained draft row is zeroed, every block back on the list
    assert int(psrv._draft_cache.lengths.sum()) == 0
    assert psrv._draft_cache.block_tables is psrv._cache.block_tables
    psrv.close()


def test_draft_server_prefix_cache_and_chunked_prefill():
    """The draft prefills its whole prompt after the target's final chunk,
    shared prefix blocks included, and the served tokens stay JAX's."""
    prefix = [1 + (i % 90) for i in range(64)]
    prompts = [prefix + [3, 7, 11] * 4, prefix + [5, 9] * 6,
               prefix + [2, 4]]
    knobs = dict(num_slots=2, enable_prefix_caching=True,
                 prefill_chunk_tokens=32, max_out_tokens=128)
    jsrv, psrv = _servers(**knobs)
    want = _serve(jsrv, prompts, 10)
    got = _serve(psrv, prompts, 10)
    assert got == want
    assert got == psrv.engine.generate(prompts, max_new_tokens=10)
    st = psrv.stats
    assert st["prefix_cache_hits"] > 0 and st["prefill_chunks"] > 3
    assert _spec(psrv) == _spec(jsrv)
    psrv.close()


def test_draft_server_preemption_mid_speculation_and_cancel():
    """A slot preempted in the middle of speculation re-admits with a full
    draft prefill and serves JAX's tokens; a cancel returns the committed
    prefix; every draft length ends at 0."""
    outs = []
    for srv in _servers(num_slots=1):
        a = srv.submit([1, 2, 3], max_new_tokens=20, priority=0)
        for _ in range(3):
            srv.step()
        b = srv.submit([4, 5, 6], max_new_tokens=4, priority=5)
        out = srv.drain()
        assert srv.stats["preempted"] == 1
        c = srv.submit([9, 8, 7], max_new_tokens=30)
        for _ in range(3):
            srv.step()
        assert srv.cancel(c)
        outs.append((out[a], out[b], srv.result(c), _spec(srv)))
    assert outs[1] == outs[0]
    psrv = srv
    ref = psrv.engine.generate([[1, 2, 3], [4, 5, 6], [9, 8, 7]],
                               max_new_tokens=20)
    got_a, got_b, got_c, _ = outs[1]
    assert got_a == ref[0]
    assert got_b == ref[1][:3 + 4]
    assert len(got_c) > 3 and got_c == ref[2][:len(got_c)]
    assert int(psrv._draft_cache.lengths.sum()) == 0
    psrv.close()


def test_draft_server_validation():
    _, pt_eng = _pair(TARGET, 0, {})
    _, pd = _pair(DRAFT, 7, {})
    with pytest.raises(ValueError, match="speculation_tokens"):
        ContinuousBatchingServer(pt_eng, draft_engine=pd)
    _, bad = _pair(dict(DRAFT, vocab_size=64), 7, {})
    _, spec_eng = _pair(TARGET, 0, dict(speculation_tokens=3))
    with pytest.raises(ValueError, match="vocab sizes differ"):
        ContinuousBatchingServer(spec_eng, draft_engine=bad)
    # the config field wires the same draft
    _, cfg_eng = _pair(TARGET, 0, dict(speculation_tokens=3,
                                       speculation_draft=pd))
    srv = ContinuousBatchingServer(cfg_eng)
    assert srv.draft is pd
    assert _serve(srv, PROMPTS[:2], 6) == \
        cfg_eng.generate(PROMPTS[:2], max_new_tokens=6)
    srv.close()
