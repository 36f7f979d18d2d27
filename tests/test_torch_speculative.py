"""Speculative decoding in the port against the JAX package on the CPU.

The same model is built in both packages (float32, 2 layers, ``n_embd``
64, vocab 256, the same weights drawn with numpy from a seed) and fed the
same numpy inputs:

* ``write_chunk`` and ``decode_chunk`` against JAX's (logits within 1e-5),
  and ``decode_chunk`` against K sequential ``decode_step`` calls, with
  lengths left where they were; the verify attention over a bf16 cache
  against JAX's within one bf16 step;
* the device-side primitives of ``inference/speculation.py`` against
  JAX's on random inputs, exactly;
* greedy ``generate_speculative`` — a smaller draft, the target as its
  own draft, prompt lookup, an EOS inside an accepted block, a padded
  array with its ``attention_mask``, rotary/GQA — against JAX's
  ``generate_speculative``: the tokens and ``last_speculative_stats``
  must be equal, and the tokens those of greedy ``generate``;
* the ``assistant_model`` alias and the validation errors, with JAX's
  messages;
* sampled speculation: at temperature 1e-6 the greedy tokens, and a chi^2
  test on a vocabulary of 16 that the committed tokens are distributed as
  sampling from the target alone. Sampled tokens are not compared with
  JAX: the two packages draw from different random streams.
* ``profile_model_time`` / ``model_times``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import kv_cache as jax_kv
from deepspeed_tpu.inference import speculation as jax_spec
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu_torch.inference import kv_cache as port_kv
from deepspeed_tpu_torch.inference import speculation as port_spec
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy

V = 256
K = 4
VARIANTS = {
    "gpt2": dict(),
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False, intermediate_size=176),
    "alibi": dict(positional="alibi"),
    "windowed": dict(local_windows=(None, 6)),
}


def numpy_params(jcfg, seed):
    """Random weights in the JAX package's parameter tree for ``jcfg``,
    drawn with numpy from ``seed`` (the tree's shapes from
    ``jax.eval_shape``: JAX's own init compiles for seconds a
    configuration). Matrices ``N(0, 1) / sqrt(fan_in)`` as ``init_params``
    scales them, small random biases, unit norm scales."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            return jnp.ones(shape, leaf.dtype)
        if len(shape) == 1 or name[0] == "b" or name == "lm_head_bias":
            return jnp.asarray(0.02 * rng.standard_normal(shape), leaf.dtype)
        fan_in = {"wte": shape[-1], "wpe": shape[-1]}.get(
            name, shape[0] * shape[1] if len(shape) == 3 and name == "wo"
            else shape[0])
        return jnp.asarray(rng.standard_normal(shape) / np.sqrt(fan_in),
                           leaf.dtype)

    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _pair(variant="gpt2", seed=0, vocab=V, **shape):
    """The same model in both packages: (jax cfg, jax params, port cfg,
    port params). Cached: nothing here writes to the params."""
    base = dict(vocab_size=vocab, n_positions=256, n_embd=64, n_layer=2,
                n_head=4)
    base.update(shape)
    jcfg = jt.InferenceTransformerConfig(dtype=jnp.float32, **base,
                                         **VARIANTS[variant])
    jp = numpy_params(jcfg, seed)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), "cpu",
                                             torch.float32)


@functools.lru_cache(maxsize=None)
def _engines(variant="gpt2", seed=0, **shape):
    """(JAX engine, port engine) over the same weights, shared by the
    tests so that each JAX loop compiles once."""
    jcfg, jp, tcfg, tp = _pair(variant, seed, **shape)
    conf = dict(dtype="float32", max_out_tokens=512)
    return (JaxEngine((jcfg, jp), JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


# ------------------------------------------------------------ the chunk

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_chunk_matches_jax_and_sequential_steps(variant):
    """``decode_chunk`` (and its ``write_chunk``) against JAX's within
    1e-5, and against K ``decode_step`` calls over the same tokens; the
    chunk leaves lengths where they were."""
    jcfg, jp, tcfg, tp = _pair(variant)
    B, T = 2, 9
    rng = np.random.default_rng(0)
    ids = rng.integers(1, V, (B, T))
    lengths = np.array([T, T - 3], np.int32)
    toks = rng.integers(1, V, (B, K))

    jc = jax_kv.init_cache(2, B, 64, jcfg.kv_heads, jcfg.head_dim,
                           jnp.float32)
    _, jc = jax.jit(jt.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths), jc)
    j_lg, jc = jax.jit(jt.decode_chunk, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks, jnp.int32), jc)

    def port_cache():
        c = port_kv.init_cache(2, B, 64, tcfg.kv_heads, tcfg.head_dim,
                               torch.float32)
        tt.prefill(tp, tcfg, torch.as_tensor(ids), torch.as_tensor(lengths),
                   c)
        return c

    with torch.no_grad():
        pc = port_cache()
        p_lg, pc2 = tt.decode_chunk(tp, tcfg, torch.as_tensor(toks), pc)
        assert pc2 is pc
        np.testing.assert_allclose(p_lg.numpy(), np.asarray(j_lg),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(pc.lengths.numpy(), lengths)
        seq = port_cache()
        steps = torch.stack([tt.decode_step(tp, tcfg, torch.as_tensor(
            toks[:, i]), seq)[0] for i in range(K)], 1)
        np.testing.assert_allclose(p_lg.numpy(), steps.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chunk_attention_over_a_bf16_cache_matches_jax(variant):
    """Over a bf16 cache the port's verify attention reads the cache as it
    is (f32 scores, P.V with P as two bf16 terms) where JAX casts V to
    f32: the two bf16 outputs agree within one bf16 step."""
    jcfg, _, tcfg, _ = _pair(variant)
    rng = np.random.default_rng(7)
    B, S, H, KH, D = 3, 48, tcfg.n_head, tcfg.kv_heads, tcfg.head_dim
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, K, H, D), (B, S, KH, D), (B, S, KH, D)))
    lengths = np.array([0, 17, S - K], np.int32)
    window = 6 if variant == "windowed" else None
    want = jt._chunk_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)),
                               jnp.asarray(lengths), jcfg, window=window)
    got = tt._chunk_attention(*(torch.from_numpy(x).bfloat16()
                                for x in (q, k, v)),
                              torch.from_numpy(lengths).long(), tcfg,
                              window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, K, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-4)


def test_write_chunk_in_place_and_clamped_like_jax():
    """``write_chunk`` writes at each row's length without moving a
    buffer; a chunk that would run past the end starts earlier, as JAX's
    ``dynamic_update_slice`` clamps."""
    rng = np.random.default_rng(1)
    L, B, S, KH, D = 2, 3, 16, 2, 4
    k = rng.standard_normal((B, K, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, K, KH, D)).astype(np.float32)
    lengths = np.array([0, 5, 14], np.int32)
    jc = jax_kv.init_cache(L, B, S, KH, D, jnp.float32)
    jc = jc.replace(lengths=jnp.asarray(lengths))
    jc = jax_kv.write_chunk(jc, 1, jnp.asarray(k), jnp.asarray(v))
    pc = port_kv.init_cache(L, B, S, KH, D, torch.float32)
    pc.lengths.copy_(torch.as_tensor(lengths))
    ptrs = (pc.k.data_ptr(), pc.v.data_ptr(), pc.lengths.data_ptr())
    port_kv.write_chunk(pc, 1, torch.as_tensor(k), torch.as_tensor(v))
    assert (pc.k.data_ptr(), pc.v.data_ptr(), pc.lengths.data_ptr()) == ptrs
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(pc.lengths.numpy(), lengths)


# ------------------------------------------------------- the primitives

def test_speculation_primitives_match_jax():
    """``greedy_accept``, ``commit_speculative_block`` and
    ``lookup_proposals`` on random inputs: exactly JAX's outputs."""
    rng = np.random.default_rng(2)
    B, S, Vs = 16, 24, 5
    for trial in range(6):
        t_toks = rng.integers(0, Vs, (B, K))
        props = np.where(rng.random((B, K - 1)) < 0.6, t_toks[:, :K - 1],
                         rng.integers(0, Vs, (B, K - 1)))
        jm, jcorr, jcomm = jax_spec.greedy_accept(
            jnp.asarray(t_toks, jnp.int32), jnp.asarray(props, jnp.int32), K)
        pm, pcorr, pcomm = port_spec.greedy_accept(
            torch.as_tensor(t_toks), torch.as_tensor(props), K)
        for j, p in ((jm, pm), (jcorr, pcorr), (jcomm, pcomm)):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        done = rng.random(B) < 0.2
        n_gen = rng.integers(1, 10, B)
        out = rng.integers(0, Vs, (B, 10 + K))
        eos = int(rng.integers(0, Vs))
        j = jax_spec.commit_speculative_block(
            jcomm, jm, jnp.asarray(done), jnp.asarray(n_gen, jnp.int32),
            jnp.asarray(out, jnp.int32), eos, K, 10)
        p = port_spec.commit_speculative_block(
            pcomm, pm, torch.as_tensor(done), torch.as_tensor(n_gen),
            torch.as_tensor(out), eos, K, 10)
        for a, b in zip(j, p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        hist = rng.integers(0, 3, (B, S))
        hlen = rng.integers(0, S, B)
        hlen[0] = 1
        cur = hist[np.arange(B), np.maximum(hlen - 1, 0)]
        np.testing.assert_array_equal(
            port_spec.lookup_proposals(torch.as_tensor(hist),
                                       torch.as_tensor(hlen),
                                       torch.as_tensor(cur), K).numpy(),
            np.asarray(jax_spec.lookup_proposals(
                jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32),
                jnp.asarray(cur, jnp.int32), K)))


def test_draft_propose_chains_steps():
    """``draft_propose`` feeds each step's token to the next and proposes
    all but the last, as JAX's scan does."""
    calls = []

    def step(t):
        calls.append(t.clone())
        return t * 2 + 1

    props = port_spec.draft_propose(step, torch.tensor([1, 2]), K)
    assert len(calls) == K
    np.testing.assert_array_equal(props.numpy(), [[3, 7, 15], [5, 11, 23]])


# ------------------------------------------------- generate_speculative

PROMPTS = [[5, 9, 3, 17, 2], [11, 4], [7, 7, 7, 8, 7, 7, 7]]


def _both(jeng, peng, *args, **kw):
    """Run generate_speculative on both engines; return (tokens, stats)
    of each."""
    draft_j, draft_p = kw.pop("drafts", (None, None))
    got_j = jeng.generate_speculative(*args, draft=draft_j, **kw)
    got_p = peng.generate_speculative(*args, draft=draft_p, **kw)
    return (got_j, jeng.last_speculative_stats), \
        (got_p, peng.last_speculative_stats)


@pytest.mark.parametrize("draft", ["model", "self", "lookup"])
def test_greedy_speculative_matches_jax(draft):
    """Tokens and ``last_speculative_stats`` equal JAX's, and the tokens
    equal greedy ``generate``'s; the target as its own draft accepts
    every proposal."""
    jeng, peng = _engines()
    if draft == "model":
        jd, pd = _engines(seed=1, n_layer=1, n_embd=32, n_head=2)
    elif draft == "self":
        jd, pd = jeng, peng
    else:
        jd = pd = None
    j, p = _both(jeng, peng, PROMPTS, max_new_tokens=16, draft_tokens=K,
                 drafts=(jd, pd))
    assert p == j
    assert p[0] == peng.generate(PROMPTS, max_new_tokens=16)
    if draft == "self":
        # 1 prefill token + 15 in rounds of K: four rounds
        assert p[1]["rounds"] == 4 and p[1]["tokens_per_round"] == 12.0
        assert peng._kept_draft is not None \
            and peng._kept_draft[1] is not peng._kept[1]


def test_greedy_speculative_eos_inside_accepted_block():
    """An EOS inside an accepted run of proposals stops the row there;
    the tokens after it in the block are not output."""
    jeng, peng = _engines()
    n = len(PROMPTS[0])
    gen = peng.generate(PROMPTS, max_new_tokens=16)[0][n:]
    # the first generated token not seen before it, past the first round
    i = next(i for i in range(2, 16) if gen[i] not in gen[:i])
    j, p = _both(jeng, peng, PROMPTS, max_new_tokens=16, draft_tokens=K,
                 eos_token_id=gen[i], drafts=(jeng, peng))
    assert p == j
    assert p[0][0] == PROMPTS[0] + gen[:i + 1]


def test_greedy_speculative_padded_array_and_rotary_gqa():
    """A right-padded array with its ``attention_mask``, through a
    rotary/GQA target and a smaller draft of the same layout."""
    jeng, peng = _engines("gqa-rotary")
    jd, pd = _engines("gqa-rotary", seed=1, n_layer=1)
    ids = np.array([[5, 9, 3, 17, 0, 0], [11, 4, 8, 8, 8, 2]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.int32)
    j, p = _both(jeng, peng, ids, max_new_tokens=10, draft_tokens=3,
                 attention_mask=mask, drafts=(jd, pd))
    assert p == j
    assert p[0] == peng.generate(ids, max_new_tokens=10,
                                 attention_mask=mask)


def test_assistant_model_alias_and_validation():
    """``generate(assistant_model=...)`` is ``generate_speculative`` with
    that draft; the refusals carry JAX's messages."""
    jeng, peng = _engines()
    _, pd = _engines(seed=1, n_layer=1, n_embd=32, n_head=2)
    want = peng.generate_speculative([[5, 9, 3]], pd, max_new_tokens=8)
    assert peng.generate([[5, 9, 3]], max_new_tokens=8,
                         assistant_model=pd) == want
    cases = [
        (ValueError, "assistant_model", lambda e, d: e.generate(
            [[1, 2]], num_beams=2, assistant_model=d)),
        (ValueError, "draft_tokens must be >= 2",
         lambda e, d: e.generate_speculative([[1, 2]], d, draft_tokens=1)),
        (NotImplementedError, "greedy-only",
         lambda e, d: e.generate_speculative([[1, 2]], temperature=0.5)),
        (ValueError, "vocab sizes differ",
         lambda e, d: e.generate_speculative([[1, 2]], d)),
        (ValueError, "draft margin",
         lambda e, d: e.generate_speculative([[1] * 500], e,
                                             max_new_tokens=16)),
    ]
    jbad, pbad = _engines(vocab=128)
    for err, msg, call in cases:
        draft_j = jbad if "vocab" in msg else jeng
        draft_p = pbad if "vocab" in msg else pd
        with pytest.raises(err, match=msg):
            call(jeng, draft_j)
        with pytest.raises(err, match=msg):
            call(peng, draft_p)


# ------------------------------------------------------------- sampled

def test_sampled_speculative_is_greedy_at_low_temperature():
    jeng, peng = _engines()
    _, pd = _engines(seed=1, n_layer=1, n_embd=32, n_head=2)
    want = peng.generate(PROMPTS, max_new_tokens=12)
    got = peng.generate_speculative(PROMPTS, pd, max_new_tokens=12,
                                    temperature=1e-6, seed=3)
    assert got == want
    st = peng.last_speculative_stats
    assert st["draft"] == "model" and st["tokens"] == 3 * 12


def test_sampled_speculative_keeps_the_target_distribution():
    """Rejection sampling leaves the committed stream distributed as the
    target's own: over 1500 rows of one prompt, the first token decided
    by accept/resample follows the target's marginal (chi^2 with 15
    degrees of freedom below its 0.999 quantile, 37.70), while the
    draft's marginal is rejected by a wide margin."""
    _, _, tcfg, tp = _pair(vocab=16, n_embd=32, n_head=2, n_layer=1)
    _, _, dcfg, dp = _pair(seed=3, vocab=16, n_embd=32, n_head=2,
                           n_layer=1)
    conf = DeepSpeedInferenceConfig(dtype="float32", max_out_tokens=256)
    target = InferenceEngine((tcfg, tp), conf, device="cpu")
    draft = InferenceEngine((dcfg, dp), conf, device="cpu")
    prompt = [5, 9, 3]
    N = 1500
    got = target.generate_speculative([prompt] * N, draft, max_new_tokens=2,
                                      draft_tokens=3, temperature=1.0,
                                      seed=11)
    seen = np.bincount([row[4] for row in got], minlength=16)

    def marginal(eng):
        # P(token 2) = sum over token 1 of P(t1) P(t2 | t1), exactly
        with torch.no_grad():
            p1 = torch.softmax(eng.forward([prompt])[0, -1], -1)
            rows = [prompt + [t] for t in range(16)]
            p2 = torch.softmax(eng.forward(rows)[:, -1], -1)
        return (p1[:, None] * p2).sum(0).numpy()

    def chi2(p):
        exp = N * p
        return float(((seen - exp) ** 2 / np.maximum(exp, 1e-9)).sum())

    assert chi2(marginal(target)) < 37.70
    assert chi2(marginal(draft)) > 100.0


# ------------------------------------------------------------ profiling

def test_profile_model_time_semantics():
    """``model_times`` raises until ``profile_model_time``, then returns
    one latency a ``forward`` call and clears on read, as JAX's."""
    jcfg, jp, tcfg, tp = _pair()
    conf = dict(dtype="float32", max_out_tokens=512)
    jeng = JaxEngine((jcfg, jp), JaxConfig(**conf))
    peng = InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                           device="cpu")
    for eng in (jeng, peng):
        with pytest.raises(AssertionError, match="profile_model_time"):
            eng.model_times()
        eng.profile_model_time()
        eng.forward(np.ones((1, 4), np.int32))
        eng.forward(np.ones((2, 4), np.int32))
        times = eng.model_times()
        assert len(times) == 2 and all(t > 0 for t in times)
        assert eng.model_times() == []
