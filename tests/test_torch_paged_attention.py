"""The port's paged attention and paged KV pool against the JAX package on
the CPU.

* The three paged kernels' plain versions (``ops/decode_attention.py``)
  against the Pallas kernels run in interpret mode, as
  tests/test_continuous_batching.py, test_prefix_caching.py and
  test_server_speculation.py run them: tolerance 2e-5 in float32 (both
  sides compute an exact f32 softmax; only the order of the sums differs).
* The paged pool's writers and gathers (``inference/kv_cache.py``) against
  the JAX writers: exact. Block 0, the null block, is garbage by contract
  (duplicate writes may land there in any order) and is not compared.
* The clamps and drops JAX gathers and scatters do on their own, which the
  port does explicitly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.inference import kv_cache as tkv
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import paged_cache_from_numpy
from deepspeed_tpu_torch.ops import decode_attention as tda

TOL = 2e-5
NB, BS, MB, D = 12, 32, 4, 16
TABLES = np.array([[3, 5, 0, 0], [1, 2, 7, 9], [11, 0, 0, 0]], np.int32)


def _pools(KH, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NB, BS, KH, D), np.float32),
            rng.standard_normal((NB, BS, KH, D), np.float32))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2), (8, 1)])
def test_paged_decode_plain_matches_pallas(H, KH):
    """Block-table indirection, partial tail blocks, out-of-order ids."""
    kp, vp = _pools(KH, H)
    q = np.random.default_rng(1).standard_normal((3, H, D), np.float32)
    lens = np.array([40, 100, 17], np.int32)
    want = jda.paged_decode_attention(*_j(q, kp, vp, TABLES, lens),
                                      interpret=True)
    got = tda.paged_decode_attention(*_t(q, kp, vp, TABLES, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ref = jda.paged_decode_attention_reference(*_j(q, kp, vp, TABLES, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_paged_decode_plain_idle_slot_gives_zeros_like_pallas():
    """An idle slot (length 0) gives zeros in the Pallas kernel and in the
    port (the JAX reference oracle would give mean(v))."""
    kp, vp = _pools(2)
    q = np.random.default_rng(2).standard_normal((3, 8, D), np.float32)
    lens = np.array([0, 100, 17], np.int32)
    want = np.asarray(jda.paged_decode_attention(
        *_j(q, kp, vp, TABLES, lens), interpret=True))
    got = tda.paged_decode_attention(*_t(q, kp, vp, TABLES, lens)).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H,KH,start,C", [(4, 4, 0, 64), (8, 2, 32, 64),
                                          (8, 1, 64, 32), (4, 2, 96, 64)])
def test_paged_chunk_plain_matches_pallas(H, KH, start, C):
    """A chunk at a block-aligned start over a resident prefix; the last
    case runs past the table (start + C > MB * BS)."""
    kp, vp = _pools(KH, start)
    q = np.random.default_rng(3).standard_normal((C, H, D), np.float32)
    row = TABLES[1]
    want = jda.paged_chunk_attention(*_j(q, kp, vp, row), jnp.int32(start),
                                     interpret=True)
    got = tda.paged_chunk_attention(*_t(q, kp, vp, row), start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ref = jda.paged_chunk_attention_reference(*_j(q, kp, vp, row), start)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("H,KH,K", [(4, 4, 4), (8, 2, 3), (8, 1, 2)])
def test_paged_verify_plain_matches_pallas(H, KH, K):
    kp, vp = _pools(KH, K)
    q = np.random.default_rng(4).standard_normal((3, K, H, D), np.float32)
    lens = np.array([40, 100, 0], np.int32)
    want = jda.paged_verify_attention(*_j(q, kp, vp, TABLES, lens),
                                      interpret=True)
    got = tda.paged_verify_attention(*_t(q, kp, vp, TABLES, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ref = jda.paged_verify_attention_reference(*_j(q, kp, vp, TABLES, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_paged_plain_versions_take_an_explicit_scale():
    kp, vp = _pools(2)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 8, D), np.float32)
    lens = np.array([40, 100, 17], np.int32)
    a = tda.paged_decode_attention(*_t(q, kp, vp, TABLES, lens), scale=0.3)
    b = tda.paged_decode_attention(*_t(q * 0.3 / D ** -0.5, kp, vp, TABLES,
                                       lens))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_paged_wrappers_on_cpu_count_no_launch_and_check_arguments():
    kp, vp = _pools(2)
    rng = np.random.default_rng(6)
    q, qv = (rng.standard_normal(s, np.float32) for s in ((3, 8, D),
                                                          (3, 2, 8, D)))
    lens = np.array([4, 5, 6], np.int32)
    fns = (tda.paged_decode_attention, tda.paged_chunk_attention,
           tda.paged_verify_attention)
    before = [f.launches for f in fns]
    tda.paged_decode_attention(*_t(q, kp, vp, TABLES, lens))
    tda.paged_chunk_attention(*_t(q, kp, vp, TABLES[1]), 32)
    tda.paged_verify_attention(*_t(qv, kp, vp, TABLES, lens))
    assert [f.launches for f in fns] == before
    tq, tkp, tvp, ttab, tlen = _t(q, kp, vp, TABLES, lens)
    # scale tiles beside a full-precision pool are refused, as in JAX
    with pytest.raises(ValueError, match="must not pass"):
        tda.paged_decode_attention(tq, tkp, tvp, ttab, tlen, k_scale=tlen,
                                   v_scale=tlen)
    with pytest.raises(ValueError, match="block_tables"):
        tda.paged_decode_attention(tq, tkp, tvp, ttab[:2], tlen)
    with pytest.raises(ValueError, match="not divisible"):
        tda.paged_decode_attention(tq[:, :3], tkp, tvp, ttab, tlen)
    with pytest.raises(ValueError, match="q \\[S, K, H, D\\]"):
        tda.paged_verify_attention(tq, tkp, tvp, ttab, tlen)
    # the CUDA-side checks are host code: a CPU tensor posing as the
    # kernel's input is refused by device
    with pytest.raises(ValueError, match="cuda or cpu"):
        tda._check_operands("paged_decode_attention", (tq, tkp, tvp),
                            (ttab, tlen))


# ------------------------------------------------------------ the pool


def _pool_pair(L=2, S=3, KH=2, seed=0):
    """One random pool in both packages (tables and lengths included)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, NB, BS, KH, D), np.float32)
    v = rng.standard_normal((L, NB, BS, KH, D), np.float32)
    lens = np.array([40, 100, 17], np.int32)[:S]
    jc = jkv.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          block_tables=jnp.asarray(TABLES[:S]),
                          lengths=jnp.asarray(lens))
    tc = paged_cache_from_numpy(jax.device_get(jc), "cpu", torch.float32)
    return jc, tc


def _assert_pool_equal(tc, jc):
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(a.numpy()[:, 1:], np.asarray(b)[:, 1:])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))


def test_paged_cache_from_numpy_and_init_match_jax():
    jc, tc = _pool_pair()
    assert isinstance(tc, tkv.PagedKVCache)
    assert (tc.block_size, tc.num_blocks, tc.num_slots, tc.max_blocks,
            tc.max_context, tc.num_layers) == (
        jc.block_size, jc.num_blocks, jc.num_slots, jc.max_blocks,
        jc.max_context, jc.num_layers)
    assert tc.lengths.dtype == tc.block_tables.dtype == torch.int32
    _assert_pool_equal(tc, jc)
    z = tkv.init_paged_cache(2, 3, NB, BS, MB, 2, D, torch.float32)
    jz = jkv.init_paged_cache(2, 3, NB, BS, MB, 2, D, jnp.float32)
    _assert_pool_equal(z, jz)
    # an int8 pool: int8 zeros and two separate all-ones scale tensors
    q8 = tkv.init_paged_cache(2, 3, NB, BS, MB, 2, D, quantized=True)
    jq8 = jkv.init_paged_cache(2, 3, NB, BS, MB, 2, D, quantized=True)
    assert q8.quantized and jq8.quantized and not z.quantized
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(q8, f), np.asarray(getattr(jq8, f))
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)
    assert q8.k_scale.data_ptr() != q8.v_scale.data_ptr()


def test_paged_writers_match_jax():
    rng = np.random.default_rng(7)
    jc, tc = _pool_pair()
    # prompt (2 blocks into slot 1), chunk (1 block at start 64 of slot
    # 1), append and verify tokens for every slot, then advance
    kp, vp = (rng.standard_normal((64, 2, D), np.float32) for _ in "kv")
    jc = jkv.paged_write_prompt(jc, 1, *_j(kp, vp), jnp.int32(1))
    tc = tkv.paged_write_prompt(tc, 1, *_t(kp, vp), 1)
    kc, vc = (rng.standard_normal((32, 2, D), np.float32) for _ in "kv")
    jc = jkv.paged_write_chunk(jc, 0, *_j(kc, vc), jnp.int32(1),
                               jnp.int32(64))
    tc = tkv.paged_write_chunk(tc, 0, *_t(kc, vc), 1, 64)
    k1, v1 = (rng.standard_normal((3, 2, D), np.float32) for _ in "kv")
    jc = jkv.paged_append_token(jc, 1, *_j(k1, v1))
    tc = tkv.paged_append_token(tc, 1, *_t(k1, v1))
    kt, vt = (rng.standard_normal((3, 4, 2, D), np.float32) for _ in "kv")
    jc = jkv.paged_write_tokens(jc, 0, *_j(kt, vt))
    tc = tkv.paged_write_tokens(tc, 0, *_t(kt, vt))
    active = np.array([True, False, True])
    jc = jkv.paged_advance(jc, jnp.asarray(active))
    tc = tkv.paged_advance(tc, torch.from_numpy(active))
    _assert_pool_equal(tc, jc)


def test_paged_gathers_match_jax():
    jc, tc = _pool_pair(seed=8)
    for a, b in zip(tkv.paged_gather_kv(tc, 1), jkv.paged_gather_kv(jc, 1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tkv.paged_gather_slot_kv(tc, 0, 2),
                    jkv.paged_gather_slot_kv(jc, 0, jnp.int32(2))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["append_past_table", "tokens_past_table",
                                  "chunk_past_table"])
def test_writes_past_the_table_clamp_or_drop_as_jax(case):
    """The garbage rows of the pipelined loop: a slot at the end of its
    span keeps decoding for a step or two. JAX's ``take_along_axis`` gives
    an out-of-range block id and its scatter drops the write; the verify
    and chunk writers redirect to the null block. The port redirects all
    three to the null block: torch indexing would fault instead."""
    rng = np.random.default_rng(9)
    jc, tc = _pool_pair(seed=9)
    span = MB * BS
    lens = np.array([span, span + 3, 17], np.int32)
    jc = jc.replace(lengths=jnp.asarray(lens))
    tc.lengths = torch.from_numpy(lens)
    if case == "append_past_table":
        k, v = (rng.standard_normal((3, 2, D), np.float32) for _ in "kv")
        jc = jkv.paged_append_token(jc, 0, *_j(k, v))
        tc = tkv.paged_append_token(tc, 0, *_t(k, v))
    elif case == "tokens_past_table":
        k, v = (rng.standard_normal((3, 4, 2, D), np.float32) for _ in "kv")
        jc = jkv.paged_write_tokens(jc, 1, *_j(k, v))
        tc = tkv.paged_write_tokens(tc, 1, *_t(k, v))
    else:
        k, v = (rng.standard_normal((64, 2, D), np.float32) for _ in "kv")
        jc = jkv.paged_write_chunk(jc, 1, *_j(k, v), jnp.int32(0),
                                   jnp.int32(span - 32))
        tc = tkv.paged_write_chunk(tc, 1, *_t(k, v), 0, span - 32)
    _assert_pool_equal(tc, jc)


def test_learned_positions_past_the_table_clamp_as_jax():
    """``wpe[positions]`` for a garbage row past n_positions reads the
    last row, as JAX's gather clamps."""
    jcfg = jt.InferenceTransformerConfig(vocab_size=64, n_positions=16,
                                         n_embd=32, n_layer=1, n_head=4,
                                         dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    from deepspeed_tpu_torch.module_inject import params_from_numpy
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.float32)
    tcfg = tt.InferenceTransformerConfig(vocab_size=64, n_positions=16,
                                         n_embd=32, n_layer=1, n_head=4,
                                         dtype=torch.float32)
    ids = np.array([[1, 2, 3]], np.int32)
    pos = np.array([[14, 16, 40]], np.int32)
    want = jt._embed(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    got = tt._embed(tp, tcfg, torch.from_numpy(ids).long(),
                    torch.from_numpy(pos).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefix_block_hashes_match_jax():
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, 500, 150).tolist()
    for bs in (16, 32, 64):
        assert tkv.prefix_block_hashes(prompt, bs) == \
            jkv.prefix_block_hashes(prompt, bs)
