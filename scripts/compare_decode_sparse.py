#!/usr/bin/env python3
"""The dense decode (B4) and block-sparse (B8) kernels of this checkout
against another checkout's, on one NVIDIA GPU, in one process.

    git archive <commit> deepspeed_tpu_torch | tar -x -C build/parent
    python3 scripts/compare_decode_sparse.py build/parent

Loads the other checkout's wrappers (``ops/decode_attention.py``,
``ops/block_sparse_attention.py``) with their own kernel sources
(``other_checkout.py``). B4 at chip_smoke.py's phase decode cases (B=8,
S=1024, bf16, seeded lengths in [1, 1024], layer views of a 2-layer cache;
GPT-2 XL heads H=KH=25, D=64, and H=32, KH=8, D=128), then R=3 (H=24,
KH=8) and R=7 (H=28, KH=4, D=128), which only this checkout takes. B8 at
phase sparse's cases (i) Fixed (B=2, T=4096, 16 heads of 128, blocks of
64, causal, strided views), (ii) BigBird, (iii) GPT-2 XL Longformer at
blocks of 128, (v) Fixed per head and (vii) fp16; this checkout's with the
tile order ``SparseSelfAttention`` caches. Each kernel is checked against
the plain version (chip_smoke.py's DECODE_TOL, SPARSE_TOL) and for the
same bits on a second call, then timed in turns (other, this, this, other;
device time by CUDA events behind a device spin, after an L2 flush, as
chip_smoke.py's ``cuda_ms``) beside the plain version, SDPA (B4 with a
length mask, B8 with the dense mask of the layout) and the bound. Then
each wrapper's host wall per call (B4 at generate's GPT-2 XL shape, B8 at
case (i)): the median over 2000 calls of each checkout's, interleaved one
by one, each after a sync; and the floor of ``stamp_decode_sparse.py`` (an empty
kernel on each grid, the live K/V bytes of B4's GPT-2 XL case read once).
Prints one JSON line per kernel and case and the card's name and power
limit.
"""
from __future__ import annotations

import inspect
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from chip_smoke import (DECODE_TOL, H100_BF16_FLOPS,  # noqa: E402
                        H100_F32_FLOPS, SPARSE_TOL, _bound, _fixed_1p3b,
                        _sparse_error, _visible_entries, cuda_ms)
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa  # noqa: E402
from deepspeed_tpu_torch.ops import decode_attention as da  # noqa: E402
from other_checkout import card, in_turns, load_wrapper  # noqa: E402
from stamp_decode_sparse import _decode_builders, floors  # noqa: E402

DECODE_CASES = [("gpt2-xl", 25, 25, 64), ("gqa H=32 KH=8 D=128", 32, 8, 128),
                ("R=3 H=24 KH=8 D=128", 24, 8, 128),
                ("R=7 H=28 KH=4 D=128", 28, 4, 128)]


def host_us(fns, calls=2000):
    """Median host wall of one call of each of ``fns`` (tag -> function),
    the calls interleaved one by one in alternating order, each after a
    sync (outside the timing): B8 runs longer than its call, and without
    the sync the launch queue fills and throttles the calls."""
    times = {tag: [] for tag in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    order = list(fns.items())
    for i in range(calls):
        for tag, fn in (order if i % 2 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[tag].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {tag: float(np.median(t)) * 1e6 for tag, t in times.items()}


def sparse_cases():
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    bf16, f16 = torch.bfloat16, torch.float16
    # name, B, T, H, D, block, layout, causal, dtype, strided views
    return [
        ("(i) gpt2-1.3b fixed", 2, 4096, 16, 128, 64,
         _fixed_1p3b(sa).make_layout(4096), True, bf16, True),
        ("(ii) bigbird", 2, 4096, 16, 128, 64,
         sa.BigBirdSparsityConfig(num_heads=16, block=64).make_layout(4096),
         False, bf16, True),
        ("(iii) gpt2-xl longformer", 2, 2048, 25, 64, 128,
         sa.BSLongformerSparsityConfig(num_heads=25, block=128
                                       ).make_layout(2048), False, bf16,
         False),
        ("(v) fixed per-head", 2, 2048, 16, 128, 64,
         sa.FixedSparsityConfig(num_heads=16, block=64, num_local_blocks=4,
                                different_layout_per_head=True,
                                num_different_global_patterns=4
                                ).make_layout(2048), False, bf16, False),
        ("(vii) fp16", 2, 2048, 16, 128, 64,
         _fixed_1p3b(sa).make_layout(2048), True, f16, True)]


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import layout_to_dense_mask
    F = torch.nn.functional
    other_da = load_wrapper(sys.argv[1], "decode_attention",
                            _decode_builders(sys.argv[1]))
    other_bsa = load_wrapper(sys.argv[1], "block_sparse_attention",
                             ["BUILDER"])
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    tiny = torch.empty(1, dtype=torch.int32, device="cuda")

    # ---- B4 (chip_smoke.py's phase decode seeds and order)
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    B, S = 8, 1024
    xl_lens = None
    for name, H, KH, D in DECODE_CASES:
        kc, vc = (torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                              dtype=torch.bfloat16)[1] for _ in range(2))
        q = torch.randn((B, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                               device="cuda")
        xl_lens = lens if xl_lens is None else xl_lens
        args = (q, kc, vc, lens)
        plain = da.decode_attention_reference(*args)
        calls = {"this": lambda: da.decode_attention(*args)}
        if H // KH in (1, 2, 4, 8):   # the group sizes the parent took
            calls["other"] = lambda: other_da.decode_attention(*args)
        errs = {}
        for tag, fn in calls.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            errs[tag] = (a.float() - plain.float()).abs().max().item()
            if not errs[tag] <= DECODE_TOL:
                raise RuntimeError(f"decode {name}: {tag} kernel off the "
                                   f"plain version: {errs[tag]}")
            if tag == "this" and not torch.equal(a, b):
                raise RuntimeError(f"decode {name}: other bits on the same "
                                   f"inputs")
        times = (in_turns(calls, 50, flush, cuda_ms) if "other" in calls
                 else {"this": [cuda_ms(calls["this"], 50, flush)
                                for _ in range(2)]})
        live = int(lens.sum())
        bound, by = _bound(2 * 2 * live * KH * D + 2 * 2 * B * H * D + 4 * B,
                           4 * live * H * D, H100_F32_FLOPS)
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=KH != H), 50, flush)
        print(json.dumps({
            "kernel": "decode_attention", "shape": name,
            "lengths": lens.tolist(), "this_ms": times["this"],
            "other_ms": times.get("other"),
            "plain_ms": cuda_ms(lambda: da.decode_attention_reference(*args),
                                10, flush),
            "sdpa_ms": lib, "bound_ms": bound, "bound_by": by,
            "max_abs_err": errs}), flush=True)
        del kc, vc

    # ---- B8 (chip_smoke.py's phase sparse seed)
    g = torch.Generator(device="cuda").manual_seed(11)
    other_takes_order = "order" in inspect.signature(
        other_bsa.block_sparse_attention).parameters
    for name, B, T, H, D, block, lay, causal, dt, strided in sparse_cases():
        lut_np, counts_np = bsa.build_lut(lay)
        lut, counts = (torch.as_tensor(x, device="cuda")
                       for x in (lut_np, counts_np))
        order = torch.as_tensor(bsa.tile_order(lut_np, counts_np, causal),
                                device="cuda")
        if strided:   # [B, H, T, D] views of a fused [B, T, 3, H, D] output
            q, k, v = (x.transpose(1, 2) for x in torch.randn(
                (B, T, 3, H, D), generator=g, device="cuda",
                dtype=dt).unbind(2))
        else:
            q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda",
                                   dtype=dt) for _ in range(3))
        args = (q, k, v, lut, counts, block, causal)
        kw = {"order": order} if other_takes_order else {}
        calls = {"this": lambda: bsa.block_sparse_attention(*args,
                                                            order=order),
                 "other": lambda: other_bsa.block_sparse_attention(*args,
                                                                   **kw)}
        ref = bsa.block_sparse_attention_reference(*args)
        stats = {}
        for tag, fn in calls.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            st, ok = _sparse_error(a.transpose(1, 2), ref.transpose(1, 2),
                                   SPARSE_TOL["16"])
            if not ok:
                raise RuntimeError(f"sparse {name}: {tag} kernel off its "
                                   f"limits ({st})")
            if tag == "this" and not torch.equal(a, b):
                raise RuntimeError(f"sparse {name}: other bits on the same "
                                   f"inputs")
            stats[tag] = st["max_err"]
        times = in_turns(calls, 20, flush, cuda_ms)
        full, diag = _visible_entries(lut_np, counts_np, causal)
        flops = 4 * B * D * (block * block * full
                             + block * (block + 1) // 2 * diag)
        bound, by = _bound(4 * B * T * H * D * q.element_size()
                           + lut_np.nbytes + counts_np.nbytes, flops,
                           H100_BF16_FLOPS)
        mask = torch.as_tensor(layout_to_dense_mask(lay, block, causal),
                               device="cuda")[None]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 10, flush)
        del mask
        print(json.dumps({
            "kernel": "block_sparse_attention", "shape": name,
            "this_ms": times["this"], "other_ms": times["other"],
            "plain_ms": cuda_ms(lambda: bsa.block_sparse_attention_reference(
                *args), 3, flush),
            "sdpa_ms": lib, "bound_ms": bound, "bound_by": by,
            "max_abs_err": stats}), flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()

    # ---- host wall per call, the checkouts' calls interleaved
    kc = torch.randn((2, 8, 1024, 25, 64), device="cuda",
                     dtype=torch.bfloat16)[1]
    q = torch.randn((8, 25, 64), device="cuda", dtype=torch.bfloat16)
    lens = torch.full((8,), 500, dtype=torch.int32, device="cuda")
    us = host_us({"this": lambda: da.decode_attention(q, kc, kc, lens),
                  "other": lambda: other_da.decode_attention(q, kc, kc,
                                                             lens)})
    print(json.dumps({"kernel": "decode_attention", "host_us_per_call": us,
                      "shape": "q [8, 25, 64], cache [8, 1024, 25, 64]"}),
          flush=True)
    del kc
    name, B, T, H, D, block, lay, causal, dt, strided = sparse_cases()[0]
    lut_np, counts_np = bsa.build_lut(lay)
    lut, counts = (torch.as_tensor(x, device="cuda")
                   for x in (lut_np, counts_np))
    order = torch.as_tensor(bsa.tile_order(lut_np, counts_np, causal),
                            device="cuda")
    q, k, v = (x.transpose(1, 2) for x in torch.randn(
        (B, T, 3, H, D), device="cuda", dtype=dt).unbind(2))
    args = (q, k, v, lut, counts, block, causal)
    kw = {"order": order} if other_takes_order else {}
    us = host_us({"this": lambda: bsa.block_sparse_attention(*args,
                                                             order=order),
                  "other": lambda: other_bsa.block_sparse_attention(*args,
                                                                    **kw)})
    print(json.dumps({"kernel": "block_sparse_attention",
                      "host_us_per_call": us, "shape": name}), flush=True)
    del q, k, v
    for rec in floors(flush, tiny, xl_lens):
        print(json.dumps(rec), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
