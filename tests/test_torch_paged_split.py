"""The paged decode kernel's split plan and its split-then-merge algebra, on
the CPU.

``ops/csrc/paged_attention.cu`` cuts the key range of each (slot, kv head,
row group) into ``splits`` contiguous ranges of ``chunk`` keys
(``paged_split_plan`` in ``ops/decode_attention.py``), runs an f32 online
softmax over each live range, and merges the partials (m, l, acc) in split
order. The kernel runs only on the card; here:

* the plan: every key position of every slot falls in exactly one split,
  in order, for ragged lengths; the splits with visible keys come first,
  and the plan depends on static sizes only;
* the algebra: a plain-torch emulation of split-then-merge in the kernel's
  fixed order, empty splits included, against the JAX package's
  ``paged_decode_attention`` (the Pallas kernel in interpret mode, as its
  own tests run it): 1e-5 in float32 (both sides compute an exact f32
  softmax; only the order of the sums differs) and chip_smoke.py's
  DECODE_TOL, 1e-2, in bfloat16 (f32 math on both sides, the output
  rounded to bf16: one rounding step of |o| <= ~1 is <= 3.9e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import decode_attention as tda

DECODE_TOL = 1e-2


def _ranges(span, splits, chunk):
    return [(i * chunk, min((i + 1) * chunk, span)) for i in range(splits)]


def _live(hi, chunk):
    """Splits the kernel runs for a visible bound ``hi`` (split 0 always:
    it writes the zeros of a unit that sees no key)."""
    return -(-hi // chunk) if hi > 0 else 1


@pytest.mark.parametrize("span", [1, 7, 64, 100, 128, 256, 1000, 1024,
                                  4096])
@pytest.mark.parametrize("units,sms", [(1, 132), (8, 132), (64, 132),
                                       (200, 132), (4096, 132), (4, 1)])
def test_plan_covers_every_position_once_in_order(span, units, sms):
    splits, chunk = tda.paged_split_plan(span, units, sms)
    assert 1 <= splits <= 16 and chunk >= 1
    ranges = _ranges(span, splits, chunk)
    assert all(lo < hi for lo, hi in ranges)   # no split past the span
    assert [p for lo, hi in ranges for p in range(lo, hi)] == \
        list(range(span))
    rng = np.random.default_rng(span * 31 + units)
    lengths = {0, 1, span, span - 1, *rng.integers(0, span + 1, 16)}
    for n in lengths:
        live = _live(n, chunk)
        assert 1 <= live <= splits
        seen = [p for lo, hi in ranges[:live] for p in range(lo, min(hi, n))]
        assert seen == list(range(n))
        assert all(lo >= n for lo, _ in ranges[live:])


@pytest.mark.parametrize("KH", [25, 8])
def test_plan_covers_the_card_at_the_main_path_shapes(KH):
    """S=8 slots over 1024 keys, GPT-2 XL (25 kv heads) and H=32/KH=8: a
    grid of at least one block an SM of an H100 (132 SMs), each split with
    at least 128 keys (the plans measured fastest there: (4, 256) and
    (8, 128))."""
    splits, chunk = tda.paged_split_plan(1024, 8 * KH, 132)
    assert 8 * KH * splits >= 132 and splits * chunk >= 1024
    assert chunk >= 128


@pytest.mark.parametrize("units", [4 * 25, 8 * 25, 8 * 8])
def test_plan_chunk_does_not_depend_on_the_pool_geometry(units):
    """Servers of one model whose pools differ only in blocks a slot (MB)
    split at the same key positions, so they sum in the same order."""
    chunks = {tda.paged_split_plan(mb * 128, units, 132)[1]
              for mb in (2, 4, 8, 16)}
    assert len(chunks) == 1
    assert tda.paged_row_groups(1) == tda.paged_row_groups(8) == 1
    assert tda.paged_row_groups(9) == tda.paged_row_groups(16) == 2


def _split_merge(q, kp, vp, tables, lens, splits, chunk, live_only):
    """The kernel's function in plain torch: per (slot, kv head) and split,
    an f32 softmax partial (m, l, acc) over the split's visible keys (an
    empty split is (-inf, 0, 0)); then the partials merged in split order.
    ``live_only``: as the kernel, only the splits with keys (split 0
    always); else every split, the empty ones merged too."""
    S, H, D = q.shape
    KH = kp.shape[2]
    R = H // KH
    span = tables.shape[1] * kp.shape[1]
    k = tda._gather(kp, tables).float()   # [S, span, KH, D]
    v = tda._gather(vp, tables).float()
    out = torch.zeros((S, H, D), dtype=torch.float32)
    for s in range(S):
        n = int(lens[s])
        for h in range(H):
            qh = q[s, h].float() * D ** -0.5
            parts = []
            ranges = _ranges(span, splits, chunk)
            for lo, hi in ranges[:_live(n, chunk)] if live_only else ranges:
                hi = min(hi, n)
                if lo >= hi:
                    parts.append((float("-inf"), 0.0, torch.zeros(D)))
                    continue
                sc = k[s, lo:hi, h // R] @ qh
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m.item(), p.sum().item(),
                               p @ v[s, lo:hi, h // R]))
            mx = max(m for m, _, _ in parts)
            ref = 0.0 if mx == float("-inf") else mx
            lt, at = 0.0, torch.zeros(D)
            for m, l_, a in parts:
                f = np.exp(np.float32(m - ref))
                lt += l_ * f
                at = at + a * f
            out[s, h] = at / max(lt, 1e-30)
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, DECODE_TOL)])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
@pytest.mark.parametrize("plan", ["auto", (8, 32), (3, 86)])
@pytest.mark.parametrize("live_only", [True, False])
def test_split_then_merge_matches_pallas(dtype, tol, H, KH, plan,
                                         live_only):
    """Lengths 0, 1, BS-1, BS, BS+1 and MB*BS in one batch: splits empty,
    partial and full."""
    NB, BS, MB, D = 40, 16, 16, 16
    span = MB * BS
    rng = np.random.default_rng(H + KH)
    lens = np.array([0, 1, BS - 1, BS, BS + 1, span], np.int32)
    S = len(lens)
    tables = np.stack([rng.permutation(np.arange(1, NB))[:MB]
                       for _ in range(S)]).astype(np.int32)
    kp, vp = (rng.standard_normal((NB, BS, KH, D), np.float32)
              for _ in range(2))
    q = rng.standard_normal((S, H, D), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, kp, vp))
    splits, chunk = (tda.paged_split_plan(span, S * KH, 132)
                     if plan == "auto" else plan)
    assert splits > 1 and splits * chunk >= span
    got = _split_merge(tq, tk, tv, torch.from_numpy(tables),
                       torch.from_numpy(lens), splits, chunk, live_only)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jda.paged_decode_attention(
        *(jnp.asarray(x, jdt) for x in (q, kp, vp)), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
