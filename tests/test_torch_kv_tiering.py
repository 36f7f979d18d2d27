"""The port's int8 paged pool and host KV tier against the JAX package on
the CPU.

* ``ops/quant_core.py``: ``quantize_int8`` / ``dequantize_int8`` against the
  JAX copies on seeded inputs. Scales within 1 ulp (both divide amax by 127
  in f32); payloads equal, except ±1 where ``|x / s|`` lies within 1e-5 of a
  half-integer (a one-ulp difference of ``x / s`` can round either way
  there).
* The int8 writers and gathers (``inference/kv_cache.py``) against the JAX
  writers on one pool carried across by ``paged_cache_from_numpy``: exact
  (the same f32 quantization, and dequantization is one f32 multiply).
  Block 0, the null block, is garbage by contract and is not compared.
* The three paged kernels' plain int8 versions against the Pallas kernels
  with ``k_scale``/``v_scale`` in interpret mode, as
  tests/test_kv_tiering.py:205 runs them: 2e-5 in f32 (both sides compute
  an exact f32 softmax over the same dequantized values, only the order of
  the sums differs); in bf16 1e-2, one bf16 step of an output below 2
  (both round an f32 result to bf16, and may land one step apart).
* The block allocator with a host tier and ``HostKVTier``: the cases of
  tests/test_kv_tiering.py:291-442, each driven on both packages'
  allocators with the same operations and compared state for state after
  each operation.
* ``paged_read_block`` / ``paged_swap_in``: exact round trips, fp and int8.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.ops import quant_core as jqc
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.inference import kv_cache as tkv
from deepspeed_tpu_torch.module_inject import paged_cache_from_numpy
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import quant_core as tqc

TOL = 2e-5
BF16_TOL = 1e-2
NB, BS, MB, D = 12, 32, 4, 16
TABLES = np.array([[3, 5, 0, 0], [1, 2, 7, 9], [11, 0, 0, 0]], np.int32)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]   # writable copies


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ------------------------------------------------------------ quant core


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("axis", [-1, 0, None])
def test_quantize_int8_matches_jax(axis, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 8, 16)) * 3.0).astype(np.float32)
    x[0, 0] = 0.0       # an all-zero slice along the last axis
    x[:, 1, 2] = 0.0    # and along axis 0
    tq, ts = tqc.quantize_int8(torch.from_numpy(x), axis)
    jq, js = jqc.quantize_int8(jnp.asarray(x), axis)
    jq, js = np.array(jq), np.array(js)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == js.shape
    np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
    diff = tq.numpy().astype(np.int32) - jq.astype(np.int32)
    ratio = np.abs(x / js)
    near_half = np.abs(ratio - np.floor(ratio) - 0.5) <= 1e-5
    assert np.all((diff == 0) | ((np.abs(diff) == 1) & near_half))
    if axis == -1:
        assert ts[0, 0, 0].item() == 1.0 and not tq[0, 0].any()
    # dequantization: one f32 multiply on both sides, on the same payload
    np.testing.assert_array_equal(
        tqc.dequantize_int8(torch.from_numpy(jq), torch.from_numpy(js))
        .numpy(), np.asarray(jqc.dequantize_int8(jnp.asarray(jq),
                                                 jnp.asarray(js))))
    # the round trip is within scale / 2 elementwise
    deq = tqc.dequantize_int8(tq, ts).numpy()
    assert np.all(np.abs(deq - x) <= np.broadcast_to(
        ts.numpy() / 2, x.shape) + 1e-7)


def test_quantize_int8_rounds_half_to_even_as_jax():
    """Exact halves (amax 127 makes s = 1) round to even on both sides."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]], np.float32)
    tq, _ = tqc.quantize_int8(torch.from_numpy(x), -1)
    jq, _ = jqc.quantize_int8(jnp.asarray(x), -1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy()[0], [127, 0, 2, 2, 0, -2, 126])


# ------------------------------------------------------ int8 pool writers


def _int8_pool_pair(L=2, S=3, KH=2, seed=0):
    """One random int8 pool (payload and scale tiles) in both packages."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (L, NB, BS, KH, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, NB, BS, KH, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (L, NB, KH, BS)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (L, NB, KH, BS)).astype(np.float32)
    lens = np.array([40, 100, 17], np.int32)[:S]
    jc = jkv.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          block_tables=jnp.asarray(TABLES[:S]),
                          lengths=jnp.asarray(lens), k_scale=jnp.asarray(ks),
                          v_scale=jnp.asarray(vs))
    tc = paged_cache_from_numpy(jax.device_get(jc), "cpu", torch.float32)
    return jc, tc


def _assert_int8_pool_equal(tc, jc):
    assert tc.quantized and tc.k.dtype == torch.int8
    for f in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, f).numpy()[:, 1:],
                                      np.asarray(getattr(jc, f))[:, 1:],
                                      err_msg=f)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))


def test_paged_cache_from_numpy_carries_an_int8_pool():
    jc, tc = _int8_pool_pair()
    assert tc.k_scale.dtype == tc.v_scale.dtype == torch.float32
    _assert_int8_pool_equal(tc, jc)


@pytest.mark.parametrize("case", ["prompt", "chunk", "chunk_past_table",
                                  "append", "append_past_table",
                                  "tokens_across_block_edge",
                                  "tokens_past_table"])
def test_int8_writers_match_jax(case):
    """Each writer quantizes per (position, head) row and scatters payload
    and scale tiles at the same indices, bit for bit as JAX."""
    rng = np.random.default_rng(11)
    jc, tc = _int8_pool_pair(seed=11)
    span = MB * BS

    def rnd(*shape):
        return (rng.standard_normal(shape) * 2).astype(np.float32)

    if case == "prompt":
        k, v = rnd(64, 2, D), rnd(64, 2, D)
        jc = jkv.paged_write_prompt(jc, 1, *_j(k, v), jnp.int32(1))
        tc = tkv.paged_write_prompt(tc, 1, *_t(k, v), 1)
    elif case in ("chunk", "chunk_past_table"):
        start = 32 if case == "chunk" else span - 32
        k, v = rnd(64, 2, D), rnd(64, 2, D)
        jc = jkv.paged_write_chunk(jc, 0, *_j(k, v), jnp.int32(1),
                                   jnp.int32(start))
        tc = tkv.paged_write_chunk(tc, 0, *_t(k, v), 1, start)
    elif case in ("append", "append_past_table"):
        if case == "append_past_table":
            # the pipelined loop's garbage row past the table: JAX's
            # scatter drops it, the port redirects it to the null block
            lens = np.array([span, 37, 0], np.int32)
            jc = jc.replace(lengths=jnp.asarray(lens))
            tc.lengths = torch.from_numpy(lens)
        k, v = rnd(3, 2, D), rnd(3, 2, D)
        jc = jkv.paged_append_token(jc, 1, *_j(k, v))
        tc = tkv.paged_append_token(tc, 1, *_t(k, v))
    else:
        lens = (np.array([BS - 3, 2 * BS - 1, 5], np.int32)
                if case == "tokens_across_block_edge"
                else np.array([span - 2, 40, span + 1], np.int32))
        jc = jc.replace(lengths=jnp.asarray(lens))
        tc.lengths = torch.from_numpy(lens)
        k, v = rnd(3, 6, 2, D), rnd(3, 6, 2, D)
        jc = jkv.paged_write_tokens(jc, 0, *_j(k, v))
        tc = tkv.paged_write_tokens(tc, 0, *_t(k, v))
    _assert_int8_pool_equal(tc, jc)


def test_int8_write_tokens_k1_equals_append():
    """A K=1 verify write and an append write the same int8 bytes and
    scales (JAX :88)."""
    rng = np.random.default_rng(3)
    a = tkv.init_paged_cache(2, 2, 6, 16, 2, 2, 8, quantized=True)
    b = tkv.init_paged_cache(2, 2, 6, 16, 2, 2, 8, quantized=True)
    for c in (a, b):
        c.block_tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        c.lengths = torch.tensor([5, 17], dtype=torch.int32)
    for layer in range(2):
        k, v = _t(rng.standard_normal((2, 2, 8)).astype(np.float32),
                  rng.standard_normal((2, 2, 8)).astype(np.float32))
        tkv.paged_append_token(a, layer, k, v)
        tkv.paged_write_tokens(b, layer, k[:, None], v[:, None])
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_scale_scatter_puts_the_advanced_dims_first():
    """``k_scale[layer][blk, :, off] = s`` with ``blk``/``off`` [S, K] and
    ``s`` [S, K, KH]: the two index tensors sit apart, so their dims come
    first in torch as in numpy (the writers rely on it)."""
    rng = np.random.default_rng(4)
    tiles = np.zeros((5, 3, 8), np.float32)           # [NB, KH, BS]
    blk = np.array([[1, 2], [4, 1]])
    off = np.array([[0, 5], [7, 6]])
    s = rng.standard_normal((2, 2, 3)).astype(np.float32)
    t = torch.from_numpy(tiles.copy())
    t[torch.from_numpy(blk), :, torch.from_numpy(off)] = torch.from_numpy(s)
    tiles[blk, :, off] = s
    np.testing.assert_array_equal(t.numpy(), tiles)
    np.testing.assert_array_equal(t[4, :, 7].numpy(), s[1, 0])


def test_int8_gathers_match_jax():
    jc, tc = _int8_pool_pair(seed=8)
    for a, b in zip(tkv.paged_gather_kv(tc, 1), jkv.paged_gather_kv(jc, 1)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tkv.paged_gather_slot_kv(tc, 0, 2),
                    jkv.paged_gather_slot_kv(jc, 0, jnp.int32(2))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------- plain int8 paged kernels


def _quant_pool(seed, KH):
    """A random int8 pool ``[NB, BS, KH, D]`` and its ``[NB, KH, BS]``
    scale tiles, quantized per (position, head) row."""
    x = np.random.default_rng(seed).standard_normal(
        (NB, BS, KH, D)).astype(np.float32)
    q, s = jqc.quantize_int8(jnp.asarray(x), -1)
    return np.asarray(q), np.asarray(s)[..., 0].transpose(0, 2, 1).copy()


def _close(got, want, dtype):
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KH", [(8, 2), (4, 4)])
def test_int8_paged_plain_versions_match_pallas(dtype, H, KH):
    """Decode (with a length-0 slot: zeros on both sides), verify (K=3)
    and chunk (start one block in) over one int8 pool."""
    kq, ks = _quant_pool(1, KH)
    vq, vs = _quant_pool(2, KH)
    rng = np.random.default_rng(5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def q_of(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return (torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt))

    scales_t = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    scales_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tk, tv, ttab = _t(kq, vq, TABLES)
    jk, jv, jtab = _j(kq, vq, TABLES)
    lens = np.array([0, 100, 17], np.int32)
    tq, jq = q_of((3, H, D))
    got = tda.paged_decode_attention(tq, tk, tv, ttab,
                                     torch.from_numpy(lens), **scales_t)
    want = jda.paged_decode_attention(jq, jk, jv, jtab, jnp.asarray(lens),
                                      interpret=True, **scales_j)
    assert got.dtype == tdt
    assert not got[0].float().any()          # the idle slot
    _close(got, want, dtype)
    tq, jq = q_of((3, 3, H, D))
    lens = np.array([40, 100, 17], np.int32)
    got = tda.paged_verify_attention(tq, tk, tv, ttab,
                                     torch.from_numpy(lens), **scales_t)
    want = jda.paged_verify_attention(jq, jk, jv, jtab, jnp.asarray(lens),
                                      interpret=True, **scales_j)
    _close(got, want, dtype)
    tq, jq = q_of((BS, H, D))
    got = tda.paged_chunk_attention(tq, tk, tv, ttab[1], BS, **scales_t)
    want = jda.paged_chunk_attention(jq, jk, jv, jtab[1], jnp.int32(BS),
                                     interpret=True, **scales_j)
    _close(got, want, dtype)
    if dtype == "float32":
        ref = jda.paged_chunk_attention_reference(jq, jk, jv, jtab[1], BS,
                                                  **scales_j)
        _close(got, ref, dtype)


def test_int8_wrappers_on_cpu_count_no_launch():
    kq, ks = _quant_pool(1, 2)
    tk, tks = _t(kq, ks)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((3, 8, D)).astype(np.float32))
    lens = torch.tensor([4, 5, 6], dtype=torch.int32)
    fns = (tda.paged_decode_attention_int8, tda.paged_chunk_attention_int8,
           tda.paged_verify_attention_int8, tda.paged_decode_attention)
    before = [f.launches for f in fns]
    ttab = torch.from_numpy(TABLES)
    a = tda.paged_decode_attention(q, tk, tk, ttab, lens, k_scale=tks,
                                   v_scale=tks)
    b = tda.paged_decode_attention_int8(q, tk, tk, ttab, lens, tks, tks)
    assert torch.equal(a, b)
    tda.paged_chunk_attention(q, tk, tk, ttab[1], 32, k_scale=tks,
                              v_scale=tks)
    tda.paged_verify_attention(q[:, None], tk, tk, ttab, lens, k_scale=tks,
                               v_scale=tks)
    assert [f.launches for f in fns] == before
    # the int8 kernels' CUDA checks are host code: CPU tensors are refused
    with pytest.raises(ValueError, match="cuda or cpu"):
        tda._int8_args("paged_decode_attention_int8", q, tk, tk, tks, tks,
                       (ttab, lens))


@pytest.mark.parametrize("fn", ["decode", "chunk", "verify"])
def test_mismatched_pool_and_scales_are_loud(fn):
    """An int8 pool without scales, an fp pool with them, one scale tensor
    alone or tiles of the wrong shape raise at the kernel boundary, never
    attend over raw int8 (JAX :247)."""
    kq, ks = _quant_pool(1, 2)
    tk, tks = _t(kq, ks)
    fp = tk.float()
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((3, 8, D)).astype(np.float32))
    lens = torch.tensor([4, 5, 6], dtype=torch.int32)
    ttab = torch.from_numpy(TABLES)

    def call(pool, **kw):
        if fn == "decode":
            return tda.paged_decode_attention(q, pool, pool, ttab, lens, **kw)
        if fn == "chunk":
            return tda.paged_chunk_attention(q, pool, pool, ttab[1], 32, **kw)
        return tda.paged_verify_attention(q[:, None], pool, pool, ttab, lens,
                                          **kw)

    with pytest.raises(ValueError, match="require k_scale"):
        call(tk)
    with pytest.raises(ValueError, match="must not pass"):
        call(fp, k_scale=tks, v_scale=tks)
    with pytest.raises(ValueError, match="require k_scale"):
        call(tk, k_scale=tks)
    with pytest.raises(ValueError, match="scale tiles"):
        call(tk, k_scale=tks[:, :, :16], v_scale=tks[:, :, :16])
    with pytest.raises(ValueError, match="require k_scale"):
        jda.paged_decode_attention(*_j(q.numpy(), kq, kq, TABLES,
                                       lens.numpy()), interpret=True)


# ------------------------------------------------------ allocator + tier


def _jax_pkg():
    return SimpleNamespace(
        Alloc=jkv.BlockAllocator, Tier=jkv.HostKVTier,
        hashes=jkv.prefix_block_hashes,
        full=lambda val: np.full((2, 2), float(val)),
        copy=lambda x: x.copy(), arr=np.asarray)


def _torch_pkg():
    return SimpleNamespace(
        Alloc=tkv.BlockAllocator, Tier=tkv.HostKVTier,
        hashes=tkv.prefix_block_hashes,
        full=lambda val: torch.full((2, 2), float(val), dtype=torch.float64),
        copy=lambda x: x.clone(), arr=lambda x: x.numpy())


def _state(alloc, tier, device, pkg):
    """Everything observable about an allocator, its tier and the fake
    device, as plain Python values."""
    a = None if alloc is None else (
        list(alloc._free), sorted(alloc._refcount.items()),
        sorted(alloc._hash_to_block.items()),
        sorted(alloc._block_hash.items()), list(alloc._lru),
        alloc.evictions, alloc.demotions, alloc.swap_ins,
        alloc.free_blocks, alloc.cached_blocks, alloc.live_blocks)
    t = None if tier is None else (
        [(h, pkg.arr(p["k"]).tolist()) for h, p in tier._store.items()],
        tier.swap_outs, tier.swap_ins, tier.dropped, tier.superseded,
        tier.host_bytes, len(tier))
    d = None if device is None else {
        b: pkg.arr(p["k"]).tolist() for b, p in sorted(device.items())}
    return a, t, d


def _wire(alloc, tier, device, pkg):
    """Copy callbacks through a dict standing in for the device pool — the
    protocol the server implements with the real pool."""
    def demote(b, h):
        tier.put(h, {k: pkg.copy(v) for k, v in device[b].items()})

    def swap_in(b, payload):
        device[b] = payload

    alloc.on_demote = demote
    alloc.on_swap_in = swap_in


def _fake_device(n, pkg):
    return {b: {"k": pkg.full(b)} for b in range(n)}


def _demote_hit_swap_in(pkg, rec):
    tier = pkg.Tier()
    alloc = pkg.Alloc(6, enable_prefix_caching=True, host_tier=tier)
    device = _fake_device(6, pkg)
    _wire(alloc, tier, device, pkg)
    hashes = pkg.hashes(list(range(8)), 4)
    blocks = alloc.allocate(2)
    for b, h in zip(blocks, hashes):
        device[b]["k"][:] = b * 10.0 + 1.0
        assert alloc.register_prefix(b, h)
    alloc.release(blocks)
    rec(alloc, tier, device)
    churn = alloc.allocate(5)          # both parked blocks demote
    assert alloc.demotions == 2 and len(tier) == 2
    rec(alloc, tier, device)
    alloc.release(churn)
    hit = alloc.match_prefix(hashes)   # both swap back in
    assert len(hit) == 2 and alloc.swap_ins == 2 and len(tier) == 0
    for b, h in zip(hit, hashes):
        assert alloc._block_hash.get(b) == h
    rec(alloc, tier, device)


def _double_demote(pkg, rec):
    tier = pkg.Tier()
    tier.put(b"h1", {"k": pkg.full(0)})
    with pytest.raises(ValueError, match="double demote"):
        tier.put(b"h1", {"k": pkg.full(1)})
    rec(None, tier, None)


def _capacity_drop(pkg, rec):
    tier = pkg.Tier(max_blocks=2)
    for i in range(3):
        tier.put(bytes([i]), {"k": pkg.full(i)})
        rec(None, tier, None)
    assert len(tier) == 2 and tier.dropped == 1
    assert not tier.has(bytes([0])) and tier.has(bytes([2]))
    with pytest.raises(ValueError, match="max_blocks"):
        pkg.Tier(max_blocks=0)


def _swap_in_survives_its_staging_drop(pkg, rec):
    tier = pkg.Tier(max_blocks=1)
    alloc = pkg.Alloc(3, enable_prefix_caching=True, host_tier=tier)
    device = _fake_device(3, pkg)
    _wire(alloc, tier, device, pkg)
    h1, h2 = pkg.hashes(list(range(8)), 4)
    b1 = alloc.allocate(1)
    device[b1[0]]["k"][:] = 11.0
    alloc.register_prefix(b1[0], h1)
    alloc.release(b1)
    churn = alloc.allocate(2)          # demotes h1 to the host
    assert tier.has(h1)
    alloc.release(churn[1:])
    alloc.register_prefix(churn[0], h2)
    alloc.release(churn[:1])
    alloc.allocate(1)                  # the free list is now empty
    rec(alloc, tier, device)
    hit = alloc.match_prefix([h1])     # its staging pop demotes h2
    assert len(hit) == 1
    assert pkg.arr(device[hit[0]]["k"]).tolist() == [[11.0, 11.0]] * 2
    assert tier.has(h2) and len(tier) == 1
    rec(alloc, tier, device)


def _reregistered_hash_purges_host_copy(pkg, rec):
    tier = pkg.Tier()
    alloc = pkg.Alloc(4, enable_prefix_caching=True, host_tier=tier)
    device = _fake_device(4, pkg)
    _wire(alloc, tier, device, pkg)
    h = pkg.hashes([1, 2, 3, 4], 4)[0]
    tier.put(h, {"k": pkg.full(0)})    # stranded on the host
    b = alloc.allocate(1)
    assert alloc.register_prefix(b[0], h)
    assert not tier.has(h) and tier.superseded == 1
    rec(alloc, tier, device)
    alloc.release(b)
    alloc.allocate(3)                  # the demotion must not raise
    assert alloc.demotions == 1 and tier.has(h)
    rec(alloc, tier, device)


def _tier_requires_prefix_caching(pkg, rec):
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        pkg.Alloc(4, enable_prefix_caching=False, host_tier=pkg.Tier())
    rec(None, None, None)


def _unwired_tier_evicts(pkg, rec):
    tier = pkg.Tier()
    alloc = pkg.Alloc(3, enable_prefix_caching=True, host_tier=tier)
    b = alloc.allocate(1)
    alloc.register_prefix(b[0], pkg.hashes([1, 2, 3, 4], 4)[0])
    alloc.release(b)
    alloc.allocate(2)                  # the LRU pop is a plain eviction
    assert alloc.evictions == 1 and alloc.demotions == 0 and len(tier) == 0
    rec(alloc, tier, None)


def _rolled_back_swap_in_parks(pkg, rec):
    tier = pkg.Tier()
    alloc = pkg.Alloc(4, enable_prefix_caching=True, host_tier=tier)
    device = _fake_device(4, pkg)
    _wire(alloc, tier, device, pkg)
    h = pkg.hashes([1, 2, 3, 4], 4)[0]
    b = alloc.allocate(1)
    alloc.register_prefix(b[0], h)
    alloc.release(b)
    churn = alloc.allocate(3)          # demotes the parked block
    alloc.release(churn)
    hit = alloc.match_prefix([h])
    rec(alloc, tier, device)
    alloc.rollback_match(hit)          # the tail allocation failed
    assert len(tier) == 0
    assert alloc.match_prefix([h]) == hit and alloc.swap_ins == 1
    rec(alloc, tier, device)


TIER_CASES = {
    "demote_hit_swap_in": _demote_hit_swap_in,
    "double_demote": _double_demote,
    "capacity_drop": _capacity_drop,
    "swap_in_survives_its_staging_drop": _swap_in_survives_its_staging_drop,
    "reregistered_hash_purges_host_copy": _reregistered_hash_purges_host_copy,
    "tier_requires_prefix_caching": _tier_requires_prefix_caching,
    "unwired_tier_evicts": _unwired_tier_evicts,
    "rolled_back_swap_in_parks": _rolled_back_swap_in_parks,
}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_allocator_and_tier_match_jax_state_for_state(case):
    states = []
    for pkg in (_jax_pkg(), _torch_pkg()):
        snaps = []
        TIER_CASES[case](pkg, lambda a, t, d, pkg=pkg, snaps=snaps:
                         snaps.append(_state(a, t, d, pkg)))
        states.append(snaps)
    assert states[0] and states[0] == states[1]


# ------------------------------------------------------ block read / swap


@pytest.mark.parametrize("quantized", [False, True])
def test_read_block_and_swap_in_round_trip(quantized):
    """paged_read_block → HostKVTier → paged_swap_in is exact for fp and
    int8 pools (payload and scale tiles), the payload equals the JAX read
    of the same pool, and it is a copy: later writes to the block do not
    reach it."""
    rng = np.random.default_rng(12)
    jc = jkv.init_paged_cache(2, 1, 5, 16, 2, 2, 8, jnp.float32,
                              quantized=quantized)
    jc = jc.replace(block_tables=jnp.asarray([[1, 3]], jnp.int32))
    k = rng.standard_normal((32, 2, 8)).astype(np.float32)
    for layer in range(2):
        jc = jkv.paged_write_prompt(jc, layer, *_j(k * (layer + 1), -k),
                                    jnp.int32(0))
    tc = paged_cache_from_numpy(jax.device_get(jc), "cpu", torch.float32)
    fields = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    payload = tkv.paged_read_block(tc, 3)
    want = jkv.paged_read_block(jc, 3)
    assert sorted(payload) == sorted(want) == sorted(fields)
    for f in fields:
        np.testing.assert_array_equal(payload[f].numpy(), want[f])
    golden = {f: getattr(tc, f)[:, 3].clone() for f in fields}
    tc.k[:, 3] = 0                     # the block recycles
    assert torch.equal(payload["k"], golden["k"])
    tier = tkv.HostKVTier()
    tier.put(b"h", payload)
    assert tier.host_bytes == sum(int(payload[f].nbytes) for f in fields)
    tc = tkv.paged_swap_in(tc, 4, tier.take(b"h"))
    for f in fields:
        assert torch.equal(getattr(tc, f)[:, 4], golden[f]), f
    with pytest.raises(ValueError, match="payload"):
        tkv.paged_swap_in(tc, 4, {"k": golden["k"]})


# ------------------------------------------- model steps over an int8 pool

VARIANTS = {
    "gpt2": dict(),
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False),
    "alibi": dict(positional="alibi"),
    "windowed": dict(local_windows=(None, 4)),
}
MTABLES = np.array([[3, 5, 0, 0], [1, 2, 7, 9], [11, 4, 6, 0]], np.int32)


def _model_pair(variant):
    """The serving tests' model (tests/test_continuous_batching.py:21-31)
    in both packages, from the same weights."""
    import dataclasses

    from deepspeed_tpu.model_implementations import transformer as jt
    from deepspeed_tpu_torch.model_implementations import transformer as tt
    from deepspeed_tpu_torch.module_inject import params_from_numpy
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=128, n_positions=256, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32, **VARIANTS[variant])
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return jt, jcfg, jp, tt, tcfg, params_from_numpy(jax.device_get(jp),
                                                     "cpu", torch.float32)


def _model_int8_pools(jcfg, lengths, seed=1):
    """A random int8 pool over MTABLES in both packages, quantized from
    seeded normals per (position, head) row."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layer, NB, BS, jcfg.kv_heads, jcfg.head_dim)
    tiles = []
    for _ in "kv":
        q, s = jqc.quantize_int8(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32)), -1)
        tiles.append((q, jnp.transpose(s[..., 0], (0, 1, 3, 2))))
    jc = jkv.PagedKVCache(
        k=tiles[0][0], v=tiles[1][0], block_tables=jnp.asarray(MTABLES),
        lengths=jnp.asarray(np.asarray(lengths, np.int32)),
        k_scale=tiles[0][1], v_scale=tiles[1][1])
    return jc, paged_cache_from_numpy(jax.device_get(jc), "cpu",
                                      torch.float32)


def _steps_close(tc, jc, tl, jl):
    """Logits to 1e-4 (f32 sums in other orders over two layers); the
    payloads each side quantized from its own k/v (equal to ~1e-6) within
    one int8 step where a value sits on a rounding boundary, scales to
    1e-5 relative."""
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for f in ("k", "v"):
        d = (getattr(tc, f).numpy()[:, 1:].astype(np.int32)
             - np.asarray(getattr(jc, f))[:, 1:].astype(np.int32))
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3, f
    for f in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, f).numpy()[:, 1:],
                                   np.asarray(getattr(jc, f))[:, 1:],
                                   rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_int8_paged_model_steps_match_jax(variant):
    """Over one int8 pool: paged_prefill into slot 1, two decode steps over
    every slot (slot 2 idle), a K=3 verify, then two chunks of a prompt in
    slot 2. Causal layers take the int8 kernels' plain versions, ALiBi and
    windowed layers the dequantizing gathers."""
    jt, jcfg, jp, tt, tcfg, tp = _model_pair(variant)
    jc, tc = _model_int8_pools(jcfg, [40, 0, 0])
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 128, (1, 64)).astype(np.int32)
    jl, jc = jt.paged_prefill(jp, jcfg, jnp.asarray(ids),
                              jnp.asarray([37], jnp.int32), jc, jnp.int32(1))
    tl, tc = tt.paged_prefill(tp, tcfg, torch.from_numpy(ids).long(), 37, tc,
                              1)
    _steps_close(tc, jc, tl, jl)
    active = np.array([True, True, False])
    for _ in range(2):
        tok = np.resize(np.asarray(jnp.argmax(jl, -1)).astype(np.int32), 3)
        jl, jc = jt.paged_decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                      jnp.asarray(active))
        tl, tc = tt.paged_decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                      tc, torch.from_numpy(active))
        _steps_close(tc, jc, tl, jl)
    toks = rng.integers(0, 128, (3, 3)).astype(np.int32)
    jl, jc = jt.paged_verify_step(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = tt.paged_verify_step(tp, tcfg, torch.from_numpy(toks).long(), tc)
    _steps_close(tc, jc, tl, jl)
    prompt = rng.integers(0, 128, 50).astype(np.int32)
    for start in (0, 32):
        ids = np.zeros((1, 32), np.int32)
        n = min(50 - start, 32)
        ids[0, :n] = prompt[start:start + n]
        jl, jc = jt.paged_prefill_chunk(
            jp, jcfg, jnp.asarray(ids), jnp.int32(start),
            jnp.asarray([50], jnp.int32), jc, jnp.int32(2))
        tl, tc = tt.paged_prefill_chunk(tp, tcfg,
                                        torch.from_numpy(ids).long(), start,
                                        50, tc, 2)
        _steps_close(tc, jc, tl, jl)


# -------------------------------------------------------- server: thrash


def test_swap_thrash_event_fires_once_per_episode():
    """A sustained swap-in storm (every admission cycles blocks through the
    tier) fires ONE kv_swap_thrash ring event (JAX :581), on the port's own
    model."""
    from collections import deque

    from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                               DeepSpeedInferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.model_implementations import transformer as tt
    from deepspeed_tpu_torch.telemetry import MetricRegistry
    from deepspeed_tpu_torch.telemetry.events import (KV_SWAP_THRASH,
                                                      EventRing,
                                                      set_event_ring)
    cfg = tt.InferenceTransformerConfig(vocab_size=256, n_positions=512,
                                        n_embd=64, n_layer=2, n_head=4,
                                        dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    eng = InferenceEngine((cfg, params), DeepSpeedInferenceConfig(
        dtype="float32", max_out_tokens=128, block_size=32, num_slots=2,
        enable_prefix_caching=True, kv_host_offload=True), device="cpu")
    ring = EventRing(256)
    prev = set_event_ring(ring)
    try:
        srv = ContinuousBatchingServer(eng, registry=MetricRegistry())
        srv._SWAP_WINDOW_STEPS = 4     # a window the short trace can fill
        srv._swap_window = deque(maxlen=4)
        prefixes = [[1 + (s * 7 + i) % 250 for i in range(96)]
                    for s in range(3)]
        for i in range(12):
            srv.submit(prefixes[i % 3] + [7 + i], max_new_tokens=4)
            srv.drain()
        events = [e for e in ring.snapshot() if e["kind"] == KV_SWAP_THRASH]
        assert len(events) == 1
        assert events[0]["data"]["swap_ins_per_step"] > 0
        st = srv.stats["kv_tier"]
        assert st["thrash_alarm"] is True and st["swap_ins"] > 0
        srv.close()
    finally:
        set_event_ring(prev)
