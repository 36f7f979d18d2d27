"""The port's one-shot inference slice (deepspeed_tpu_torch) against the JAX
package on the CPU.

Both packages get the same weights (the JAX tree through
``params_from_numpy``) and the same numpy-made inputs. In float32 the two
compute the same function, so logits agree to 1e-4 absolute (float32
GEMMs and softmaxes summed in different orders over two layers; the
observed gap is ~1e-6). Greedy tokens must be identical except where the
JAX logits' top-2 gap is itself below that tolerance (a near-tie either
side may break differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pydantic import ValidationError

import deepspeed_tpu_torch
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import kv_cache as jax_kv
from deepspeed_tpu.inference.engine import _bucket as jax_bucket
from deepspeed_tpu.inference.engine import _fit_to_budget as jax_fit
from deepspeed_tpu.inference.engine import _pad_batch as jax_pad
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu_torch.inference import kv_cache as port_kv
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import (InferenceEngine, _bucket,
                                                  _fit_to_budget, _pad_batch)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.telemetry import MetricRegistry

TOL = 1e-4
V = 256
VARIANTS = {
    "gpt2": dict(),
    # GQA + rotary, with the rest of the LLaMA layout
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False, intermediate_size=176),
    # the plain (kernel-less) attention paths of both packages
    "alibi": dict(positional="alibi"),
    "windowed": dict(local_windows=(None, 6)),
}


def _pair(variant, seed=0):
    """The same model in both packages: (jax cfg, jax params, port cfg,
    port params)."""
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=V, n_positions=128, n_embd=64, n_layer=2, n_head=4,
        dtype=jnp.float32, **VARIANTS[variant])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), "cpu",
                                             torch.float32)


def _leaf(tree, path):
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


@pytest.mark.parametrize("variant", ["gpt2", "gqa-rotary"])
def test_params_from_numpy_keeps_keys_shapes_values(variant):
    _, jp, _, tp = _pair(variant)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_port = len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, tp)))
    assert n_port == len(leaves)
    for path, leaf in leaves:
        t = _leaf(tp, path)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_params_from_numpy_bfloat16_exact():
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5)).astype(jnp.bfloat16)
    t = params_from_numpy({"w": [x]})["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    """prefill logits and 8 decode_step logits on a right-padded ragged
    batch, same weights, same tokens fed to both."""
    jcfg, jp, tcfg, tp = _pair(variant)
    B, T, S = 3, 32, 64
    rng = np.random.default_rng(1)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = np.array([32, 19, 4], np.int32)
    jc = jax_kv.init_cache(2, B, S, jcfg.kv_heads, jcfg.head_dim,
                           jnp.float32)
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(lens), jc)
    tc = port_kv.init_cache(2, B, S, tcfg.kv_heads, tcfg.head_dim,
                            torch.float32)
    tl, tc = tt.prefill(tp, tcfg, torch.as_tensor(ids, dtype=torch.long),
                        torch.as_tensor(lens), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jt.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = tt.decode_step(tp, tcfg, torch.as_tensor(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def _assert_same_greedy(out_t, out_j, jcfg, jp):
    """Token-identical, or the first difference sits on a JAX near-tie."""
    for row_t, row_j in zip(out_t, out_j):
        if row_t == row_j:
            continue
        i = next(n for n, (a, b) in enumerate(zip(row_t, row_j)) if a != b)
        lg = np.asarray(jt.causal_forward(jp, jcfg,
                                          jnp.asarray([row_j[:i]])))[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < TOL, (row_t, row_j)


@pytest.mark.parametrize("variant", ["gpt2", "gqa-rotary"])
def test_generate_greedy_matches_jax_engine(variant):
    jcfg, jp, tcfg, tp = _pair(variant)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, n).tolist() for n in (3, 40, 17)]
    out_j = JaxEngine((jcfg, jp), JaxConfig(dtype="float32")).generate(
        prompts, max_new_tokens=10)
    eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32"), device="cpu")
    out_t = eng.generate(prompts, max_new_tokens=10)
    assert [len(r) for r in out_t] == [len(r) for r in out_j]
    _assert_same_greedy(out_t, out_j, jcfg, jp)


def test_generate_penalties_min_tokens_and_eos_match_jax():
    """The logit adjustments of _generate_loop: repetition penalty, the
    min_new_tokens EOS floor and EOS stopping (greedy, so exact)."""
    jcfg, jp, tcfg, tp = _pair("gpt2", seed=3)
    prompts = [[1, 2, 3, 4, 5], [9, 8]]
    je = JaxEngine((jcfg, jp), JaxConfig(dtype="float32"))
    eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32"), device="cpu")
    plain = je.generate(prompts, max_new_tokens=12)
    eos = plain[0][6]   # row 0's second generated token
    kw = dict(max_new_tokens=12, repetition_penalty=1.3, min_new_tokens=3,
              eos_token_id=eos)
    _assert_same_greedy(eng.generate(prompts, **kw), je.generate(prompts, **kw),
                        jcfg, jp)
    kw = dict(max_new_tokens=12, eos_token_id=eos)
    out_t, out_j = eng.generate(prompts, **kw), je.generate(prompts, **kw)
    _assert_same_greedy(out_t, out_j, jcfg, jp)
    assert out_t[0][-1] == eos and len(out_t[0]) <= 7


def test_generate_eos_rows_run_past_done_check_unchanged():
    """Rows that finish early keep decoding until the host's every-few-
    steps check; their tokens are masked, so output equals the JAX one."""
    jcfg, jp, tcfg, tp = _pair("gpt2", seed=4)
    prompts = [[5, 6, 7], [1, 2], [3]]
    je = JaxEngine((jcfg, jp), JaxConfig(dtype="float32"))
    eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32"), device="cpu")
    base = je.generate(prompts, max_new_tokens=20)
    eos = base[1][3]
    out_t = eng.generate(prompts, max_new_tokens=20, eos_token_id=eos)
    _assert_same_greedy(out_t, je.generate(prompts, max_new_tokens=20,
                                           eos_token_id=eos), jcfg, jp)


def test_sampling_filters_and_seeds():
    _, _, tcfg, tp = _pair("gpt2")
    eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32"), device="cpu")
    prompt = [[1, 2, 3, 4]]
    greedy = eng.generate(prompt, max_new_tokens=6)
    # a nucleus this small, or top-k 1, keeps only the argmax token
    assert eng.generate(prompt, max_new_tokens=6, temperature=1.0,
                        top_p=1e-6, seed=3) == greedy
    assert eng.generate(prompt, max_new_tokens=6, temperature=0.7,
                        top_k=1, seed=5) == greedy
    a = eng.generate(prompt, max_new_tokens=8, temperature=1.0, seed=1)
    assert a == eng.generate(prompt, max_new_tokens=8, temperature=1.0,
                             seed=1)
    assert a != eng.generate(prompt, max_new_tokens=8, temperature=1.0,
                             seed=2)
    with pytest.raises(ValueError, match="temperature"):
        eng.generate(prompt, top_k=5)
    with pytest.raises(ValueError, match="repetition_penalty"):
        eng.generate(prompt, repetition_penalty=0.0)


def test_forward_with_attention_mask_matches_jax():
    jcfg, jp, tcfg, tp = _pair("gpt2")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, V, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    ref = JaxEngine((jcfg, jp), JaxConfig(dtype="float32")).forward(
        ids, attention_mask=mask)
    eng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32"), device="cpu")
    np.testing.assert_allclose(eng.forward(ids, mask).numpy(),
                               np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(eng.forward(ids).numpy(), np.asarray(
        jt.causal_forward(jp, jcfg, jnp.asarray(ids))), rtol=TOL, atol=TOL)


def test_kv_cache_ops_match_jax():
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, 8, 2, 4), np.float32)
    v = rng.standard_normal((2, 8, 2, 4), np.float32)
    k1 = rng.standard_normal((2, 2, 4), np.float32)
    lens = np.array([8, 3], np.int32)
    jc = jax_kv.init_cache(2, 2, 16, 2, 4, jnp.float32)
    jc = jax_kv.write_prompt(jc, 1, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens))
    jc = jax_kv.advance(jax_kv.append_token(jc, 1, jnp.asarray(k1),
                                            jnp.asarray(k1)))
    tc = port_kv.init_cache(2, 2, 16, 2, 4, torch.float32)
    tc = port_kv.write_prompt(tc, 1, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(lens))
    tc = port_kv.advance(port_kv.append_token(tc, 1, torch.from_numpy(k1),
                                              torch.from_numpy(k1)))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tc.lengths, jc.lengths)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tc.lengths.dtype == torch.int32 and tc.max_seq == 16
    assert port_kv.auto_max_tokens(2, 2, 2, 4, device="cpu") is None


class _FakeAccelerator:
    """Reports fixed memory stats to both packages' ``auto_max_tokens``."""

    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self, device_index=None):
        return self.stats


@pytest.mark.parametrize("stats,fits", [
    ({"bytes_limit": 80 * 2**30, "bytes_in_use": 5 * 2**30}, True),
    ({"bytes_limit": 2**30, "bytes_in_use": 2**29}, True),
    ({"bytes_limit": 2**20, "bytes_in_use": 0}, False),   # < 128 tokens
    ({}, None),                                            # no stats
])
def test_auto_max_tokens_matches_jax_from_the_same_memory_stats(
        monkeypatch, stats, fits):
    from deepspeed_tpu.accelerator import real_accelerator as jax_real
    from deepspeed_tpu_torch.accelerator import real_accelerator as port_real
    monkeypatch.setattr(jax_real, "_ACCELERATOR", _FakeAccelerator(stats))
    monkeypatch.setattr(port_real, "_ACCELERATOR", _FakeAccelerator(stats))
    args = (48, 8, 25, 64)   # GPT-2 XL's cache, batch 8
    if fits is False:
        with pytest.raises(RuntimeError, match="128-token"):
            port_kv.auto_max_tokens(*args, dtype=torch.bfloat16,
                                    device="cuda")
        return
    want = jax_kv.auto_max_tokens(*args, dtype=jnp.bfloat16)
    got = port_kv.auto_max_tokens(*args, dtype=torch.bfloat16, device="cuda")
    assert got == want and (got is None) == (fits is None)


def test_cpu_accelerator_reports_no_memory_stats():
    from deepspeed_tpu_torch.accelerator import get_accelerator
    acc = get_accelerator()
    assert acc.name() == "cpu" and acc.is_available()
    assert acc.memory_stats() == {} and acc.device_count() == 1


def test_shape_buckets_match_jax():
    for n in (1, 100, 128, 129, 700, 1024, 1500):
        assert _bucket(n) == jax_bucket(n)
        for budget in (128, 384, 1024, 4096):
            assert _fit_to_budget(n, budget) == jax_fit(n, budget)
    prompts = [[1, 2, 3], list(range(200))]
    for a, b in zip(_pad_batch(prompts), jax_pad(prompts)):
        np.testing.assert_array_equal(a, b)
    ids = np.arange(30).reshape(2, 15)
    mask = np.ones_like(ids)
    mask[0, 9:] = 0
    for a, b in zip(_pad_batch(ids, mask), jax_pad(ids, mask)):
        np.testing.assert_array_equal(a, b)


def test_inference_config_accepts_the_same_json_and_aliases():
    raw = {"kernel_inject": True, "dtype": "fp16", "tp": {"tp_size": 1},
           "max_tokens": 512, "tm": True, "sp_size": 1,
           "replication": {"replicas": 2}, "telemetry": {"enabled": False},
           "moe": {"ep_size": 1}, "quant": {"enabled": False}}
    assert DeepSpeedInferenceConfig(**raw).model_dump() == \
        JaxConfig(**raw).model_dump()
    assert DeepSpeedInferenceConfig(mp_size=4).tp_size == 4
    assert DeepSpeedInferenceConfig(dtype="half").torch_dtype == torch.float16
    assert DeepSpeedInferenceConfig(dtype="bf16").torch_dtype == \
        torch.bfloat16
    assert deepspeed_tpu_torch.default_inference_config() == \
        JaxConfig().model_dump()
    for bad in ({"max_tokns": 4}, {"max_batch_size": 0}):
        with pytest.raises(ValidationError):
            JaxConfig(**bad)
        with pytest.raises(ValidationError):
            DeepSpeedInferenceConfig(**bad)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tcfg, tp = _pair("gpt2")
    with pytest.raises(RuntimeError, match="is_available"):
        InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
            dtype="float32"), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference((tcfg, tp), dtype="float32")


def test_init_inference_entry_point_and_telemetry():
    jcfg, jp, tcfg, tp = _pair("gpt2")
    eng = deepspeed_tpu_torch.init_inference((tcfg, tp), {"dtype": "fp32"},
                                             max_tokens=256, device="cpu")
    assert eng.device.type == "cpu" and eng.config.max_out_tokens == 256
    eng.telemetry = MetricRegistry()
    out = eng.generate([[4, 5, 6]], max_new_tokens=5)
    assert out == JaxEngine((jcfg, jp), JaxConfig(
        dtype="float32")).generate([[4, 5, 6]], max_new_tokens=5)
    assert eng.telemetry.counter("inference_generate_calls_total").value == 1
    assert eng.telemetry.histogram("inference_generate_seconds").count == 1
    bare = deepspeed_tpu_torch.init_inference(tcfg, dtype="float32",
                                              device="cpu")
    assert len(bare.generate([[1, 2]], max_new_tokens=3)[0]) == 5
    with pytest.raises(ValueError, match="max_out_tokens"):
        eng.generate([[1] * 200], max_new_tokens=100)


@pytest.mark.parametrize("case", ["beams", "assistant", "speculative", "tp",
                                  "int8", "moe", "encoder", "checkpoint",
                                  "hf_model", "server"])
def test_out_of_slice_paths_raise_not_implemented(case):
    _, _, tcfg, tp = _pair("gpt2")
    cfg32 = DeepSpeedInferenceConfig(dtype="float32")
    # beams, speculation, the encoder path, HF checkpoints and tp/sp
    # meshes are ported: on their paths only what the JAX package refuses
    # too remains (a seq-sharded cache under speculation or the server)
    match = {"beams": "not beam search",
             "speculative": "greedy-only",
             "assistant": "decode_chunk with seq-sharded KV",
             "tp": "continuous batching with a seq-sharded KV cache",
             "encoder": "bidirectional decoding",
             "checkpoint": "model-parallel shards",
             "hf_model": "no policy for model_type"}.get(case, "ROADMAP")
    with pytest.raises(NotImplementedError, match=match):
        if case == "beams":
            InferenceEngine((tcfg, tp), cfg32, device="cpu").generate(
                [[1, 2]], num_beams=2, repetition_penalty=1.3)
        elif case == "assistant":
            eng = InferenceEngine(
                (dataclasses.replace(tcfg, seq_shard_kv=True), tp), cfg32,
                device="cpu")
            eng.generate([[1, 2]], assistant_model=eng)
        elif case == "speculative":
            eng = InferenceEngine((tcfg, tp), cfg32, device="cpu")
            eng.generate_speculative([[1, 2]], draft=None, temperature=0.5)
        elif case == "server":
            # the paged server is ported; its disaggregated roles are not
            from deepspeed_tpu_torch import inference
            inference.ContinuousBatchingServer(InferenceEngine(
                (tcfg, tp), DeepSpeedInferenceConfig(dtype="float32"),
                device="cpu"), role="prefill")
        elif case == "tp":
            from deepspeed_tpu_torch import inference
            inference.ContinuousBatchingServer(InferenceEngine(
                (dataclasses.replace(tcfg, seq_shard_kv=True), tp), cfg32,
                device="cpu"))
        elif case == "int8":
            # int8 weights are ported; the batched expert form of the w8a8
            # einsum waits for the MoE slice
            from deepspeed_tpu_torch.ops.int8_gemm import int8_einsum
            int8_einsum("xse,xef->xsf", torch.zeros(2, 3, 8),
                        {"q": torch.zeros(2, 8, 4, dtype=torch.int8),
                         "oscale": torch.ones(2, 1, 4)}, 1, 1, torch.float32)
        elif case == "moe":
            InferenceEngine(dataclasses.replace(tcfg, num_experts=4), cfg32,
                            device="cpu")
        elif case == "encoder":
            # post-LN encoders are bidirectional; a causal LM is not
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
                dtype="float32", triangular_masking=False), device="cpu")
        elif case == "checkpoint":
            deepspeed_tpu_torch.init_inference(
                config={"checkpoint": ["/a/mp_rank_00", "/a/mp_rank_01"]},
                device="cpu")
        elif case == "hf_model":
            class Unknown:
                config = type("Config", (), {"model_type": "made-up"})
            InferenceEngine(Unknown(), cfg32, device="cpu")
