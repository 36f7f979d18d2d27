"""The port's inference engine and paged server over int8 weights against
the JAX package on the CPU (2 layers, ``n_embd`` 32, 4 heads of 8,
float32 activations unless stated).

* ``generate`` with ``quant.enabled`` (row-group int8 storage), and with
  ``quant.activation.enabled`` too (w8a8: per-output-channel storage,
  every projection an int8 x int8 product): the same greedy tokens as the
  JAX engine, the placed int8 leaves bit for bit, and the logits of a full
  forward within 1e-4 absolute (weight-only: the dequantized weights are
  bit-identical and the f32 products sum in another order; observed
  2e-6) or 2e-2 (w8a8: a last-bit difference in an activation can move
  its int8 code by one step, 1/127 of its row's amax; observed 1e-6).
* ``dtype="int8"``: bf16 activations over int8 weights, the logits within
  0.125 of JAX's: 8 bf16 steps at the logits' magnitude (2-4, where a
  step is 2**-6), for activations rounded to bf16 at different places in
  the two frameworks through two layers (observed: 0.047).
* w8a8 without int8 storage raises JAX's ``ValueError``.
* The default server, prefix caching with chunked prefill and prompt-
  lookup speculation (K=4) over int8 weights, weight-only and w8a8: the
  JAX server's tokens, request for request.
* Serving checkpoints with ``scale`` and ``oscale`` leaves, written by
  each package and read by the other: the writer's tokens, and the int8
  leaves as stored.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.engine import \
    load_serving_checkpoint as jax_load_serving
from deepspeed_tpu.inference.engine import \
    save_serving_checkpoint as jax_save_serving
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                           DeepSpeedInferenceConfig,
                                           InferenceEngine)
from deepspeed_tpu_torch.inference.engine import (load_serving_checkpoint,
                                                  save_serving_checkpoint)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy

PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13],
           [20, 21], [30], [40, 41, 42, 43, 44], [50, 51]]
SHARED = [1 + (i * 7) % 120 for i in range(70)]
NEW = 8
MODES = {"weight_only": {"quant": {"enabled": True}},
         "w8a8": {"quant": {"enabled": True,
                            "activation": {"enabled": True}}}}
LOGIT_TOL = {"weight_only": 1e-4, "w8a8": 2e-2}
BF16_LOGIT_TOL = 0.125


def _model(seed=0):
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=128, n_positions=256, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return (jcfg, jp), (tcfg, params_from_numpy(jax.device_get(jp), "cpu",
                                                torch.float32))


def _engines(knobs):
    jm, tm = _model()
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32)
    conf.update(knobs)
    return (JaxEngine(jm, JaxConfig(**conf)),
            InferenceEngine(tm, DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


def _same_params(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _same_params(t[k], j[k])
    elif isinstance(j, list):
        for a, b in zip(t, j):
            _same_params(a, b)
    else:
        b = np.asarray(jax.device_get(j))
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def _logits(je, te, ids):
    j = jt.causal_forward(je.params, je.model_config, jnp.asarray(ids))
    t = tt.causal_forward(te.params, te.model_config,
                          torch.as_tensor(ids, dtype=torch.long))
    return t.float().numpy(), np.asarray(j.astype(jnp.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_jax(mode):
    je, te = _engines(MODES[mode])
    assert te.model_config.int8_compute == je.model_config.int8_compute \
        == (mode == "w8a8")
    _same_params(te.params, je.params)
    wo = te.params["layers"][0]["attn"]["wo"]
    assert wo["q"].dtype == torch.int8
    assert wo["oscale" if mode == "w8a8" else "scale"].dtype == torch.float32
    assert te.generate(PROMPTS, max_new_tokens=NEW) == \
        je.generate(PROMPTS, max_new_tokens=NEW)
    ids = np.asarray([SHARED[:32], list(range(1, 33))], np.int32)
    t, j = _logits(je, te, ids)
    np.testing.assert_allclose(t, j, atol=LOGIT_TOL[mode])


def test_int8_dtype_runs_bf16_over_int8_weights():
    je, te = _engines({"dtype": "int8"})
    assert te.model_config.dtype == torch.bfloat16
    assert te.params["wte"].dtype == torch.bfloat16
    _same_params(te.params, je.params)
    t, j = _logits(je, te, np.asarray([SHARED[:32]], np.int32))
    np.testing.assert_allclose(t, j, atol=BF16_LOGIT_TOL)
    out = te.generate(PROMPTS[:2], max_new_tokens=NEW)
    assert [len(r) for r in out] == [len(p) + NEW for p in PROMPTS[:2]]


def test_w8a8_without_int8_storage_raises():
    knobs = {"quant": {"activation": {"enabled": True}}}
    with pytest.raises(ValueError, match="requires int8 weight storage"):
        _engines(knobs)
    jm, tm = _model()
    with pytest.raises(ValueError, match="requires int8 weight storage"):
        JaxEngine(jm, JaxConfig(dtype="float32", **knobs))
    with pytest.raises(ValueError, match="requires int8 weight storage"):
        InferenceEngine(tm, DeepSpeedInferenceConfig(dtype="float32",
                                                     **knobs), device="cpu")


def _plain(srv):
    ids = [srv.submit(p, max_new_tokens=6) for p in PROMPTS[:4]]
    for _ in range(3):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=6) for p in PROMPTS[4:]]
    srv.drain()
    return ids


def _shared_prefix(srv):
    prompts = [SHARED + [100 + i] * (i + 1) for i in range(4)] + PROMPTS[:2]
    ids = [srv.submit(prompts[0], max_new_tokens=6)]
    for _ in range(4):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=6) for p in prompts[1:]]
    srv.drain()
    assert srv.stats["prefix_cache_hits"] > 0
    return ids


def _repetitive(srv):
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5], [9, 8, 7, 9, 8],
               [4, 4, 4, 4]]
    ids = [srv.submit(p, max_new_tokens=10) for p in prompts]
    srv.drain()
    assert srv.stats["speculation"]["verify_steps"] > 0
    return ids


SERVERS = {
    "default": ({"num_slots": 4}, _plain),
    "prefix+chunked": ({"num_slots": 2, "enable_prefix_caching": True,
                        "prefill_chunk_tokens": 32}, _shared_prefix),
    "lookup K=4": ({"num_slots": 2, "speculation_tokens": 4}, _repetitive),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("server", sorted(SERVERS))
def test_server_matches_jax_server(server, mode):
    knobs, scenario = SERVERS[server]
    je, te = _engines({**MODES[mode], **knobs})
    out = []
    for cls, eng in ((JaxServer, je), (ContinuousBatchingServer, te)):
        srv = cls(eng)
        ids = scenario(srv)
        out.append([srv.result(i) for i in ids])
        srv.close()
    assert out[1] == out[0]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serving_checkpoints_cross_load(mode, tmp_path):
    je, te = _engines(MODES[mode])
    want = te.generate(PROMPTS, max_new_tokens=NEW)
    assert je.generate(PROMPTS, max_new_tokens=NEW) == want
    key = "oscale" if mode == "w8a8" else "scale"
    conf = dict(dtype="float32", max_out_tokens=256)
    # the JAX package writes, the port reads: int8 nodes as stored, no
    # requantization (a plain config), the writer's tokens
    jax_save_serving(je, str(tmp_path / "jax"))
    back = load_serving_checkpoint(str(tmp_path / "jax"),
                                   DeepSpeedInferenceConfig(**conf),
                                   device="cpu")
    assert back.model_config.int8_compute == (mode == "w8a8")
    node = back.params["layers"][1]["mlp"]["wi"]
    assert set(node) == {"q", key} and node["q"].dtype == torch.int8 \
        and node[key].dtype == torch.float32
    _same_params(back.params, je.params)
    assert back.generate(PROMPTS, max_new_tokens=NEW) == want
    # the port writes, the JAX package reads
    save_serving_checkpoint(te, str(tmp_path / "port"))
    jback = jax_load_serving(str(tmp_path / "port"), JaxConfig(**conf))
    _same_params(te.params, jback.params)
    assert jback.generate(PROMPTS, max_new_tokens=NEW) == want
