"""The dense decode kernel's split plan and split-then-merge (B4), and the
block-sparse kernel's tile order and per-tile loop (B8), on the CPU.

``ops/csrc/paged_attention.cu`` runs B4 on B5's units, plan and merge:
the key range of each (batch row, kv head, row group) is cut into ``splits`` ranges of ``chunk`` keys (``dense_split_plan``),
each live range gets an f32 online softmax, and the partials merge in
split order. ``ops/csrc/block_sparse_attention.cu`` runs B8 at blocks of
64 and 128 as a persistent kernel that takes its tiles in the order the
host gives (``tile_order``), each tile walking the visible entries of its
LUT row in order with an online softmax, P rounded to the storage dtype
before P.V and only the diagonal block masked. The kernels run only on the
card; here:

* B4's plan: every position of every unit falls in exactly one split, in
  order, for ragged lengths, lengths 0 and S; below the cap of 16 splits
  the chunk does not change with S;
* a plain-torch emulation of B4's split-then-merge in the kernel's order,
  against the JAX package's ``decode_attention`` (the Pallas kernel in
  interpret mode, as its own tests run it), for R = H / KH in {1, 3, 4, 7,
  8, 12, 16} (units of up to 8 rows: R = 12 and 16 take two), D in {64,
  128} and
  lengths around a split edge: 1e-5 in float32, chip_smoke.py's
  DECODE_TOL in bfloat16;
* B8's tile order covers every (head, query block) exactly once, the
  tiles of each group of 8 heads together, heaviest first;
* a plain-torch emulation of B8's per-tile loop against the JAX package's
  ``block_sparse_attention`` in interpret mode on phase sparse's layouts
  (i) Fixed causal, (ii) BigBird, (v) Fixed per head and (vi) rows that
  see no key, at T <= 1024: 1e-5 in float32, chip_smoke.py's SPARSE_TOL
  atol (2e-2) in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch.ops.sparse_attention as port_sparse
from deepspeed_tpu.ops.pallas import block_sparse_attention as jax_bsa
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import block_sparse_attention as port_bsa
from deepspeed_tpu_torch.ops import decode_attention as tda

DECODE_TOL = 1e-2
SPARSE_ATOL = 2e-2


def _ranges(S, splits, chunk):
    return [(i * chunk, min((i + 1) * chunk, S)) for i in range(splits)]


def _live(n, chunk):
    """Splits the kernel runs for a row of length ``n`` (split 0 always: it
    writes the zeros of a row that sees no key)."""
    return -(-n // chunk) if n > 0 else 1


# ------------------------------------------------------------------- B4


@pytest.mark.parametrize("S", [64, 1000, 1024, 4096, 20000])
@pytest.mark.parametrize("units", [8, 64, 200, 4096])
def test_dense_plan_covers_every_position_once_in_order(S, units):
    splits, chunk = tda.dense_split_plan(S, units, 132)
    assert 1 <= splits <= 16 and chunk >= 1
    ranges = _ranges(S, splits, chunk)
    assert all(lo < hi for lo, hi in ranges)   # no split past the cache
    assert [p for lo, hi in ranges for p in range(lo, hi)] == list(range(S))
    rng = np.random.default_rng(S * 31 + units)
    for n in {0, 1, S - 1, S, *rng.integers(0, S + 1, 16)}:
        live = _live(n, chunk)
        assert 1 <= live <= splits
        seen = [p for lo, hi in ranges[:live] for p in range(lo, min(hi, n))]
        assert seen == list(range(n))
        assert all(lo >= n for lo, _ in ranges[live:])


@pytest.mark.parametrize("units", [8, 200, 4096])
def test_dense_plan_chunk_does_not_depend_on_the_cache_size(units):
    """Caches of one model that differ in length split at the same key
    positions below the cap (16 splits), so they sum in the same order."""
    assert len({tda.dense_split_plan(S, units, 132)[1]
                for S in (64, 300, 1000, 1024, 2048, 4096)}) == 1
    assert tda.dense_split_plan(20000, units, 132)[0] == 16   # past the cap


def _split_merge(q, kc, vc, lens, splits, chunk):
    """The kernel's function in plain torch: per (batch row, head) and live
    split, an f32 softmax partial (m, l, acc) over the split's visible keys
    (q times the scale in f32); the partials merged in split order."""
    B, H, D = q.shape
    S, KH = kc.shape[1], kc.shape[2]
    R = H // KH
    k, v = kc.float(), vc.float()
    out = torch.zeros((B, H, D), dtype=torch.float32)
    for b in range(B):
        n = max(0, min(int(lens[b]), S))
        for h in range(H):
            qh = q[b, h].float() * D ** -0.5
            parts = []
            for lo, hi in _ranges(S, splits, chunk)[:_live(n, chunk)]:
                hi = min(hi, n)
                if lo >= hi:
                    parts.append((float("-inf"), 0.0, torch.zeros(D)))
                    continue
                sc = k[b, lo:hi, h // R] @ qh
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m.item(), p.sum().item(),
                               p @ v[b, lo:hi, h // R]))
            mx = max(m for m, _, _ in parts)
            ref = 0.0 if mx == float("-inf") else mx
            lt, at = 0.0, torch.zeros(D)
            for m, l_, a in parts:
                f = np.exp(np.float32(m - ref))
                lt += l_ * f
                at = at + a * f
            out[b, h] = at / max(lt, 1e-30)
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, DECODE_TOL)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("R", [1, 3, 4, 7, 8, 12, 16])
def test_dense_split_then_merge_matches_pallas(R, D, dtype, tol):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1, S - 1 and S in one batch:
    splits empty, partial and full, at the plan the wrapper takes."""
    KH, S = 2, 512
    H = KH * R
    splits, chunk = tda.dense_split_plan(S, KH * tda.paged_row_groups(R), 132)
    assert splits > 1
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, S - 1, S], np.int32)
    B = len(lens)
    rng = np.random.default_rng(R * 7 + D)
    kc, vc = (rng.standard_normal((B, S, KH, D), np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, H, D), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, kc, vc))
    got = _split_merge(tq, tk, tv, torch.from_numpy(lens), splits, chunk)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jda.decode_attention(*(jnp.asarray(x, jdt) for x in (q, kc, vc)),
                                jnp.asarray(lens), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # and the wrapper's plain version on the CPU, the same function
    plain = tda.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------- B8

T_SMALL = 1024


def _layout(name, H, block):
    """phase sparse's layouts, cut to T_SMALL tokens and H heads."""
    if name == "(i) fixed":
        cfg = port_sparse.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            num_global_blocks=1, attention="unidirectional")
        return cfg.make_layout(T_SMALL), True
    if name == "(ii) bigbird":
        return port_sparse.BigBirdSparsityConfig(
            num_heads=H, block=block).make_layout(T_SMALL), False
    if name == "(v) fixed per head":
        return port_sparse.FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=4,
            different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(T_SMALL), False
    nb = T_SMALL // block   # (vi): row block 0 sees only the future block 1
    dead = np.zeros((H, nb, nb), np.int64)
    dead[:, 0, 1] = 1
    for i in range(1, nb):
        dead[:, i, i] = 1
    return dead, True


LAYOUT_NAMES = ["(i) fixed", "(ii) bigbird", "(v) fixed per head",
                "(vi) dead rows"]


@pytest.mark.parametrize("H", [4, 16, 25])
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_tile_order_covers_each_tile_once_heaviest_first(name, H):
    lay, causal = _layout(name, H, 64)
    lut, counts = port_bsa.build_lut(lay)
    nb = lut.shape[1]
    order = port_bsa.tile_order(lut, counts, causal)
    assert order.dtype == np.int32 and sorted(order.tolist()) == \
        list(range(H * nb))
    vis = port_bsa.visible_entries(lut, counts, causal)
    G = port_bsa.HEAD_GROUP
    for first in range(0, H, G):
        part = order[first * nb:min(first + G, H) * nb]
        heads = part // nb
        assert heads.min() == first and heads.max() == min(first + G, H) - 1
        weights = vis[heads, part % nb]
        assert (np.diff(weights) <= 0).all()   # heaviest first


def _tile_loop(q, k, v, lut, counts, block, causal):
    """The kernel's function in plain torch, tile by tile: each (batch
    row, head, query block) walks the visible entries of its LUT row in
    order with an f32 online softmax (S = q.k^T in f32, then the scale;
    only the diagonal block masked), P rounded to the storage dtype before
    P.V, l summing the unrounded P; a tile with no visible entry is 0."""
    B, H, T, D = q.shape
    nb = T // block
    scale = D ** -0.5
    out = torch.zeros((B, H, T, D), dtype=torch.float32)
    tri = torch.arange(block)[None, :] > torch.arange(block)[:, None]
    for b in range(B):
        for h in range(H):
            for qb in range(nb):
                qt = q[b, h, qb * block:(qb + 1) * block].float()
                m = torch.full((block, 1), float("-inf"))
                l_ = torch.zeros((block, 1))
                acc = torch.zeros((block, D))
                for j in range(int(counts[h, qb])):
                    kb = int(lut[h, qb, j])
                    if not (0 <= kb < nb) or (causal and kb > qb):
                        continue
                    ks = k[b, h, kb * block:(kb + 1) * block].float()
                    vs = v[b, h, kb * block:(kb + 1) * block].float()
                    s = (qt @ ks.T) * scale
                    if causal and kb == qb:
                        s = s.masked_fill(tri, float("-inf"))
                    mn = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn)
                    l_ = l_ * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + p.to(q.dtype).float() @ vs
                    m = mn
                live = torch.isfinite(m)
                out[b, h, qb * block:(qb + 1) * block] = torch.where(
                    live, acc / l_.clamp_min(1e-30), 0.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", SPARSE_ATOL)])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_tile_loop_matches_pallas(name, block, dtype, tol):
    H, D, B = 2, 64, 1
    lay, causal = _layout(name, H, block)
    lut, counts = port_bsa.build_lut(lay)
    rng = np.random.default_rng(block + len(name))
    q, k, v = (rng.standard_normal((B, H, T_SMALL, D), np.float32)
               for _ in range(3))
    tt = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    got = _tile_loop(*tt, lut, counts, block, causal)
    want = jax_bsa.block_sparse_attention(
        *[jnp.asarray(x, dtype) for x in (q, k, v)], jnp.asarray(lut),
        jnp.asarray(counts), block, causal=causal, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if name == "(vi) dead rows":
        assert torch.equal(got[:, :, :block].float(),
                           torch.zeros_like(got[:, :, :block].float()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
