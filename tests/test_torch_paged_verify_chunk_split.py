"""The paged verify and chunk kernels' split-then-merge algebra, and the
verify kernel's split plan, on the CPU.

``ops/csrc/paged_attention.cu`` (verify, B7/B7i) cuts the key range of each
(slot, kv head, group of up to 16 query rows) into splits of
``paged_verify_plan``; in a split, warp w of 4 takes keys 16w..16w+15 of
every 64-key stage; the warps' partials merge in warp order, then the
splits' in split order. ``ops/csrc/paged_chunk_attention.cu`` (chunk,
B6/B6i) gives each (64-row q tile, kv head) one block over the tile's
visible keys, the tile's rows stacked as (position, head); warp group g of
2 takes the tile's 64-key stages g, g + 2, ..., and group 1's partial merges
into group 0's. Each warp (group) runs an f32 online softmax over its keys,
each row with its own causal bound. The kernels run only on the card; here:

* the plan: every key position of every slot falls in exactly one split,
  in order, for ragged lengths; below the cap the plan does not change with
  the pool's blocks a slot (MB); the wrapper's scratch covers the units of
  both verify kernels (16-bit queries: 16 rows a unit; f32: 8);
* the algebra: a plain-torch emulation of the kernels' online softmax in
  their units, lanes and merge order (empty splits included; over an int8
  pool, scale_k on the score, scale_v on P, l summing the unscaled P; the
  verify kernel carries q.scale and P at f32 precision through its bf16
  products, the chunk kernel rounds both to q's dtype, as the flash
  kernel) against the JAX package's ``paged_verify_attention`` and
  ``paged_chunk_attention`` (the Pallas kernels in interpret mode, as their
  own tests run them): 1e-5 in float32 (an exact f32 softmax on both sides;
  only the order of the sums differs), and chip_smoke.py's DECODE_TOL
  (verify, 1e-2: one rounding of the output) and FLASH_TOL (chunk, 2e-2:
  that, and the roundings of q.scale and P) in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import decode_attention as tda

DECODE_TOL = 1e-2
FLASH_TOL = 2e-2
NB, BS, MB, D = 40, 16, 16, 16
SPAN = MB * BS


def _ranges(n, splits, chunk):
    return [(i * chunk, min((i + 1) * chunk, n)) for i in range(splits)]


def _live(hi, chunk):
    """Splits a unit runs for a visible bound ``hi`` (split 0 always: it
    writes the zeros of a unit that sees no key)."""
    return -(-hi // chunk) if hi > 0 else 1


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("span", [64, 128, 1000, 1024, 4096, 8192])
@pytest.mark.parametrize("S,KH,rows", [(1, 1, 1), (8, 25, 4), (8, 8, 16),
                                       (8, 8, 32), (64, 8, 4)])
def test_verify_plan_covers_every_position_once_in_order(span, S, KH, rows):
    units, splits, chunk = tda.paged_verify_plan(span, S, KH, rows)
    assert units == S * KH * -(-rows // 16)
    assert 1 <= splits <= 16 and chunk % 64 == 0 and splits * chunk >= span
    ranges = _ranges(span, splits, chunk)
    assert all(lo < hi for lo, hi in ranges)
    rng = np.random.default_rng(span + units)
    K = max(1, rows // 4)
    for n in {0, 1, span - K, *rng.integers(0, span - K + 1, 8)}:
        # the unit's last row sees col <= n + K - 1
        hi = min(n + K, span)
        live = _live(hi, chunk)
        seen = [p for lo, h in ranges[:live] for p in range(lo, min(h, hi))]
        assert seen == list(range(hi))
        assert all(lo >= hi for lo, _ in ranges[live:])


@pytest.mark.parametrize("S,KH,rows", [(8, 25, 4), (8, 8, 16), (4, 8, 64)])
def test_verify_plan_does_not_depend_on_the_pool_geometry(S, KH, rows):
    """Below the cap (16 splits), servers whose pools differ only in blocks
    a slot split at the same key positions."""
    chunks = {tda.paged_verify_plan(mb * 128, S, KH, rows)[2]
              for mb in (2, 4, 8, 16)}
    assert len(chunks) == 1


@pytest.mark.parametrize("S,K,H,KH,D", [(8, 4, 25, 25, 64), (8, 4, 32, 8, 128),
                                       (8, 8, 32, 8, 128), (3, 1, 4, 4, 64),
                                       (2, 5, 8, 2, 128), (4, 2, 12, 4, 64)])
@pytest.mark.parametrize("MB,BS", [(8, 128), (64, 16), (300, 32)])
def test_verify_scratch_covers_both_kernels(S, K, H, KH, D, MB, BS):
    """The verify wrapper's scratch, as it would be on the card: tickets for
    every unit of either kernel (16-bit queries: groups of 16 rows; f32
    queries: the decode kernel's groups of up to 8, padded to a power of
    two), partials for every split of every unit at either geometry
    (16 rows x (D + 4) floats a split; the decode kernel's R rows x D +
    max(2R, 4)), all tickets zero."""
    tda._SCRATCH.clear()
    q = torch.zeros((S, K, H, D), dtype=torch.bfloat16)
    tp, pp, splits, chunk = tda._verify_args(q, 0, KH, MB, BS, D)
    tickets, part, _ = tda._SCRATCH[("verify", 0, S, KH, K * (H // KH),
                                     MB * BS, D)]
    assert (tickets.data_ptr(), part.data_ptr()) == (tp, pp)
    rows = K * (H // KH)
    units, splits2, chunk2 = tda.paged_verify_plan(MB * BS, S, KH, rows)
    assert (splits, chunk) == (splits2, chunk2)
    r8 = 1 << (min(rows, 8) - 1).bit_length()
    units8 = S * KH * -(-rows // r8)
    assert tickets.numel() >= max(units, units8)
    assert not tickets.any()
    assert part.numel() >= units * splits * 16 * (D + 4)
    assert part.numel() >= units8 * splits * (r8 * D + max(2 * r8, 4))
    tda._SCRATCH.clear()


# ------------------------------------------------------------- emulation

def _pools(rng, KH, int8, nb=NB):
    """Pools [nb, BS, KH, D] (and f32 scale tiles [nb, KH, BS] for int8)
    as numpy arrays."""
    if not int8:
        return [rng.standard_normal((nb, BS, KH, D), np.float32)
                for _ in range(2)] + [None, None]
    k, v = (rng.integers(-127, 128, (nb, BS, KH, D)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, (nb, KH, BS)).astype(np.float32)
              for _ in range(2))
    return [k, v, ks, vs]


def _gathered(pool, scale, table):
    """One slot's [MB * BS, KH, D] keys (f32, int8 values as they are)
    and [MB * BS, KH] scales (ones for an fp pool)."""
    t = torch.as_tensor(table).long()
    x = torch.as_tensor(pool)[t].reshape(-1, *pool.shape[2:]).float()
    if scale is None:
        return x, torch.ones(x.shape[:2])
    return x, torch.as_tensor(scale)[t].transpose(1, 2).reshape(-1,
                                                                 pool.shape[2])


def _online(qs, k, v, ks, vs, lims, keys, rnd):
    """One warp's (or warp group's) f32 online softmax for the rows ``qs``
    [N, D] over the key ranges ``keys``, in order, each row seeing keys
    below its bound in ``lims`` [N]: the partial (m, l, acc) with P rounded
    by ``rnd`` for P.V (l sums it unrounded)."""
    n = qs.shape[0]
    m = torch.full((n,), float("-inf"))
    l, acc = torch.zeros(n), torch.zeros(qs.shape)
    for lo, hi in keys:
        s = (qs @ k[lo:hi].T) * ks[lo:hi]
        s = s.masked_fill(torch.arange(lo, hi)[None] >= lims[:, None],
                          float("-inf"))
        mx = torch.maximum(m, s.amax(1))
        base = torch.where(mx == float("-inf"), 0.0, mx)
        alpha, p = torch.exp(m - base), torch.exp(s - base[:, None])
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None] + rnd(p * vs[lo:hi]) @ v[lo:hi]
        m = mx
    return m, l, acc


def _merge(parts):
    """Partials (m, l, acc) merged in order, as the kernels merge warps,
    warp groups and splits."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    ref = torch.where(mx == float("-inf"), 0.0, mx)
    lt, at = 0.0, 0.0
    for m, l_, a in parts:
        f = torch.exp(m - ref)
        lt = lt + l_ * f
        at = at + a * f[:, None]
    return mx, lt, at


def _unit(qs, k, v, ks, vs, lims, splits, rnd):
    """Output rows of one unit: ``splits`` the splits it runs, in order,
    each a list of lanes (warps or warp groups), each lane a list of key
    ranges; lanes merge, then splits."""
    parts = [_merge([_online(qs, k, v, ks, vs, lims, lane, rnd)
                     for lane in lanes]) for lanes in splits]
    _, l_, acc = _merge(parts)
    return acc / l_.clamp_min(1e-30)[:, None]


def _verify_lanes(lo, hi):
    """A verify split [lo, hi): warp w takes keys 16w..16w+15 of each
    64-key stage."""
    return [[(st + 16 * w, min(st + 16 * w + 16, hi))
             for st in range(lo, hi, 64) if st + 16 * w < hi]
            for w in range(4)]


def _chunk_lanes(end):
    """A chunk q tile's keys [0, end): group g takes stages g, g + 2, ..."""
    return [[(st, min(st + 64, end)) for st in range(64 * g, end, 128)]
            for g in range(2)]


def _rounding(dtype):
    if dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(dtype).float()


def _jax_args(q, pools, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    k, v, ks, vs = pools
    if ks is None:
        return (jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                jnp.asarray(v, jdt)), {}
    return ((jnp.asarray(q, jdt), jnp.asarray(k), jnp.asarray(v)),
            dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))


def _round_q(q, dtype):
    """q as the kernels take it: in q's dtype."""
    return torch.as_tensor(q).to(dtype).float()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, DECODE_TOL)])
@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_verify_split_then_merge_matches_pallas(dtype, tol, K, H, KH, pool):
    """Tables of 48 blocks (768 keys: the plan's three splits of 256) and
    lengths 0, 1, BS-1, BS, BS+1, 255, 256 and 768-K in one batch: splits
    empty, partial and full, rows on both sides of a split's edge; K*R of
    1 to 32 rows (two units of 16 rows at K=8 R=4)."""
    rng = np.random.default_rng(10 * K + H + (pool == "int8"))
    mb, nb = 48, 56
    span = mb * BS
    lens = np.array([0, 1, BS - 1, BS, BS + 1, 255, 256, span - K], np.int32)
    S, R = len(lens), H // KH
    tables = np.stack([rng.permutation(np.arange(1, nb))[:mb]
                       for _ in range(S)]).astype(np.int32)
    pools = _pools(rng, KH, pool == "int8", nb)
    q = rng.standard_normal((S, K, H, D), np.float32)
    rows = K * R
    units, splits, chunk = tda.paged_verify_plan(span, S, KH, rows)
    assert (units, splits, chunk) == (S * KH * -(-rows // 16), 3, 256)
    ranges = _ranges(span, splits, chunk)
    qt = _round_q(q, dtype) * D ** -0.5
    one = _rounding(torch.float32)   # P at f32 precision
    got = torch.zeros((S, K, H, D))
    for s in range(S):
        k, ks = _gathered(pools[0], pools[2], tables[s])
        v, vs = _gathered(pools[1], pools[3], tables[s])
        for kh in range(KH):
            for row0 in range(0, rows, 16):
                js = range(row0, min(row0 + 16, rows))
                lims = torch.tensor([min(int(lens[s]) + 1 + j // R, span)
                                     for j in js])
                hi = int(lims[-1])   # the unit's last row sees the most
                o = _unit(
                    torch.stack([qt[s, j // R, kh * R + j % R] for j in js]),
                    k[:, kh], v[:, kh], ks[:, kh], vs[:, kh], lims,
                    [_verify_lanes(lo, min(h, hi))
                     for lo, h in ranges[:_live(hi, chunk)]], one)
                for i, j in enumerate(js):
                    got[s, j // R, kh * R + j % R] = o[i]
    got = got.to(dtype)
    args, sc = _jax_args(q, pools, dtype)
    want = jda.paged_verify_attention(*args[:3], jnp.asarray(tables),
                                      jnp.asarray(lens), interpret=True, **sc)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, FLASH_TOL)])
@pytest.mark.parametrize("start,C", [(0, 17), (32, 64), (100, 40), (0, 64),
                                     (63, 65), (150, 106), (200, 100)])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_chunk_split_then_merge_matches_pallas(dtype, tol, start, C, H, KH,
                                               pool):
    """One slot's chunk, rows stacked (position, head) in 64-row q tiles,
    each tile's keys split between the two warp groups by alternate 64-key
    stages: early tiles run fewer stages, one group may have none, and a
    chunk past the table's 256 keys sees only those."""
    rng = np.random.default_rng(start + C + H + (pool == "int8"))
    R = H // KH
    table = rng.permutation(np.arange(1, NB))[:MB].astype(np.int32)
    pools = _pools(rng, KH, pool == "int8")
    q = rng.standard_normal((C, H, D), np.float32)
    rnd = _rounding(dtype)
    qt = _round_q(q, dtype) * D ** -0.5
    k, ks = _gathered(pools[0], pools[2], table)
    v, vs = _gathered(pools[1], pools[3], table)
    got = torch.zeros((C, H, D))
    for kh in range(KH):
        for q0 in range(0, C * R, 64):
            rs = range(q0, min(q0 + 64, C * R))
            lims = torch.tensor([min(start + r // R + 1, SPAN) for r in rs])
            o = _unit(
                torch.stack([qt[r // R, kh * R + r % R] for r in rs]),
                k[:, kh], v[:, kh], ks[:, kh], vs[:, kh], lims,
                [_chunk_lanes(int(lims[-1]))], rnd)
            for i, r in enumerate(rs):
                got[r // R, kh * R + r % R] = o[i]
    got = got.to(dtype)
    args, sc = _jax_args(q, pools, dtype)
    want = jda.paged_chunk_attention(*args[:3], jnp.asarray(table),
                                     jnp.asarray(start, jnp.int32),
                                     interpret=True, **sc)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
