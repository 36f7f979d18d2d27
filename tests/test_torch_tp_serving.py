"""Tensor- and sequence-parallel serving of the port against the JAX
package on the CPU.

The port runs one process per rank over gloo (the rank programs are in
the JAX-free ``tests/test_torch_tp_workers.py``; one spawn group of 2
ranks for every tp=2 and sp=2 case, one of 4 for tp 2 x sp 2). The JAX
engine and server run at the same ``tp_size`` / ``sp_size`` on the host
devices ``tests/conftest.py`` forces, with XLA's CPU optimisations off for
this module. Both start from the same numpy tree (2 layers, ``n_embd``
32, 4 heads, float32). Every rank must give JAX's tokens exactly, and the
full forward's logits to 1e-4 relative (the row-parallel products are
summed over the ranks in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dist_workers as W
import test_torch_tp_workers as TW
from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.model_implementations import transformer as jt


@pytest.fixture(scope="module", autouse=True)
def xla_fast_compiles():
    """JAX's side compiled with XLA's CPU backend optimisations off: the
    same HLO, compiled in about half the time; its executables are
    dropped afterwards."""
    prev = jax.config._read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _jax_engine(variant, params, conf, n_layer=2):
    cfg = jt.InferenceTransformerConfig(**{**TW.SERVE, "n_layer": n_layer},
                                        **TW.VARIANTS[variant],
                                        dtype=jnp.float32)
    return JaxEngine((cfg, jax.tree.map(jnp.asarray, params)),
                     JaxConfig(**conf))


FP = dict(dtype="float32", max_out_tokens=256, block_size=32)
TP2 = dict(FP, tensor_parallel={"tp_size": 2})
INT8 = {"enabled": True}
W8A8 = {"enabled": True, "activation": {"enabled": True}}
# name: (variant, config, mode, extra)
GENERATE = {
    "gpt2": ("gpt2", TP2, {}),
    "gqa": ("gqa", TP2, {}),
    "parallel": ("parallel", TP2, {}),
    "gqa-int8": ("gqa", dict(TP2, quant=INT8), {}),
    "gqa-w8a8": ("gqa", dict(TP2, quant=W8A8), {}),
    "sp2": ("gpt2", dict(FP, max_out_tokens=128, sp_size=2),
            {"prompts": TW.LONG}),
}
SERVER = {
    "fp": ("gqa", dict(TP2, num_slots=4), "plain", None),
    "int8-pool": ("gqa", dict(TP2, num_slots=4, kv_cache_dtype="int8"),
                  "plain", None),
    "prefix-chunked": ("gpt2", dict(TP2, num_slots=2,
                                    enable_prefix_caching=True,
                                    prefill_chunk_tokens=32), "prefix",
                       None),
    "speculation-k4": ("gpt2", dict(TP2, num_slots=4, speculation_tokens=4),
                       "repetitive", None),
    "draft": ("gqa", dict(TP2, num_slots=4, speculation_tokens=3),
              "plain", "gqa"),
}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every 2-rank serving case, in one spawn group."""
    params = {v: TW.serve_params(v) for v in ("gpt2", "gqa", "parallel")}
    draft = TW.serve_params("gqa", seed=5, n_layer=1)
    cases = {f"gen-{k}": dict(variant=v, params=params[v], conf=c,
                              mode="generate", **x)
             for k, (v, c, x) in GENERATE.items()}
    cases.update({f"srv-{k}": dict(variant=v, params=params[v], conf=c,
                                   mode=m, draft=None if d is None
                                   else (d, draft))
                  for k, (v, c, m, d) in SERVER.items()})
    tmp = tmp_path_factory.mktemp("tp_serve")
    ranks = W.run_ranks(TW.serve_runs, 2, tmp, cases)
    refused = W.run_ranks(TW.refusals, 2, tmp, params["gpt2"])
    return {"ranks": ranks, "params": params, "draft": draft,
            "refused": refused}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_matches_jax(two, case):
    variant, conf, extra = GENERATE[case]
    prompts = extra.get("prompts", TW.PROMPTS)
    je = _jax_engine(variant, two["params"][variant], conf)
    want = je.generate(prompts, max_new_tokens=8)
    logits = np.asarray(je.forward(TW.pad(prompts)), np.float32)
    for rank in two["ranks"]:
        got = rank[f"gen-{case}"]
        assert got["tokens"] == want
        np.testing.assert_allclose(got["logits"], logits, rtol=1e-4,
                                   atol=1e-4 * np.abs(logits).max())
    # each rank holds its half: heads under tp, positions under sp
    got = two["ranks"][0][f"gen-{case}"]
    kv = TW.VARIANTS[variant].get("n_kv_head", TW.SERVE["n_head"])
    if "sp_size" in conf:
        assert got["cache"][2] == 128 // 2 and got["cache"][3] == kv
    else:
        assert got["wq"][1] == TW.SERVE["n_head"] // 2
        assert got["cache"][3] == kv // 2


@pytest.mark.parametrize("case", sorted(SERVER))
def test_server_matches_jax_server(two, case):
    variant, conf, mode, draft = SERVER[case]
    je = _jax_engine(variant, two["params"][variant], conf)
    jd = None if draft is None else _jax_engine(draft, two["draft"], conf,
                                                n_layer=1)
    want = TW._server_drive(JaxServer(je, draft_engine=jd), mode)
    for rank in two["ranks"]:
        got = rank[f"srv-{case}"]
        assert got["outputs"] == want
        kv = TW.VARIANTS[variant].get("n_kv_head", TW.SERVE["n_head"])
        assert got["pool"][3] == kv // 2
        assert got["stats"]["decode_traces"] == -1   # the CPU: eager
    if mode == "prefix":
        assert two["ranks"][0][f"srv-{case}"]["stats"][
            "prefix_cache_hits"] > 0


def test_refusals_carry_jax_messages(two):
    cfg = jt.InferenceTransformerConfig(**TW.SERVE, **TW.VARIANTS["mqa"],
                                        dtype=jnp.float32)
    with pytest.raises(ValueError) as jax_heads:
        JaxEngine(cfg, JaxConfig(dtype="float32",
                                  tensor_parallel={"tp_size": 2}))
    jsp = JaxEngine(jt.InferenceTransformerConfig(**TW.SERVE,
                                                  dtype=jnp.float32),
                    JaxConfig(dtype="float32", sp_size=2,
                              max_out_tokens=256))
    with pytest.raises(NotImplementedError) as jax_server:
        JaxServer(jsp)
    with pytest.raises(NotImplementedError) as jax_chunk:
        jsp.generate_speculative([[1, 2, 3]], draft=None, max_new_tokens=4)
    for rank in two["refused"]:
        assert rank["tp_heads"] == f"ValueError: {jax_heads.value}"
        assert rank["server_seq"] == \
            f"NotImplementedError: {jax_server.value}"
        assert rank["chunk_seq"] == f"NotImplementedError: {jax_chunk.value}"
        assert "same on every rank" in rank["deadline"]


def test_tp2_by_sp2_on_four_ranks_matches_jax(tmp_path):
    params = TW.serve_params("gpt2")
    conf = dict(FP, max_out_tokens=128, sp_size=2,
                tensor_parallel={"tp_size": 2})
    ranks = W.run_ranks(TW.serve_runs, 4, tmp_path, {"g": dict(
        variant="gpt2", params=params, conf=conf, mode="generate",
        prompts=TW.LONG)})
    je = _jax_engine("gpt2", params, conf)
    want = je.generate(TW.LONG, max_new_tokens=8)
    for rank in ranks:
        assert rank["g"]["tokens"] == want
        assert rank["g"]["cache"][2:4] == (64, 2)
