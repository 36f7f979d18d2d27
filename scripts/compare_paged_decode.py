#!/usr/bin/env python3
"""The paged decode kernel (B5, B5i) and the paged verify kernel that shares
its source (B7, B7i) of this checkout against another checkout's, on one
NVIDIA GPU, in one process.

    git archive <commit> deepspeed_tpu_torch | tar -x -C build/parent
    python3 scripts/compare_paged_decode.py build/parent

Loads the other checkout's wrapper (``ops/decode_attention.py``) with its
own ``paged_attention.cu`` (``other_checkout.py``). At chip_smoke.py's
phase paged shapes (S=8 slots, BS=128, MB=8, NB=65, bf16, seeded lengths
in [1, 1024], shuffled tables; GPT-2 XL heads H=KH=25, D=64, and GQA H=32,
KH=8, D=128), for the fp and the int8 pool, it checks both wrappers
against the plain version (chip_smoke.py's DECODE_TOL) and that a second
call gives the same bits, then times each kernel in turns (other, this,
this, other; device time by CUDA events behind a device spin, after an L2
flush, as chip_smoke.py's ``cuda_ms``) beside SDPA over the cache already
gathered (and dequantized) and the bound. Then the host wall of one
``paged_decode_attention`` call at the GPT-2 XL shape: the median over
2000 calls of each wrapper, interleaved one by one, without a sync. Prints one JSON line per kernel and shape and the
card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (DECODE_TOL, H100_F32_FLOPS, _bound,  # noqa: E402
                        _int8_layer_pool, _paged_tables, cuda_ms)
from deepspeed_tpu_torch.ops import decode_attention as da  # noqa: E402
from other_checkout import card, in_turns, load_wrapper  # noqa: E402

S, BS, MB, NB, K = 8, 128, 8, 65, 4
SHAPES = [("gpt2-xl", 25, 25, 64), ("gqa H=32 KH=8 D=128", 32, 8, 128)]


def host_us(fns, calls=2000):
    """Median host wall of one call of each of ``fns`` (tag -> function),
    the calls interleaved one by one in alternating order (so a slow
    stretch of a shared host hits both alike), no sync between them."""
    times = {tag: [] for tag in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    order = list(fns.items())
    for i in range(calls):
        for tag, fn in (order if i % 2 else order[::-1]):
            t0 = time.perf_counter()
            fn()
            times[tag].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {tag: float(np.median(t)) * 1e6 for tag, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    mods = {"other": load_wrapper(sys.argv[1], "decode_attention",
                                  ["PAGED_BUILDER"]), "this": da}
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    span = MB * BS
    for shape, H, KH, D in SHAPES:
        def rnd(*s):
            return torch.randn(s, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        kp, vp = rnd(2, NB, BS, KH, D)[1], rnd(2, NB, BS, KH, D)[1]
        kq, ks = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        vq, vs = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        lens_np = rng.integers(1, span + 1, S).astype(np.int32)
        vlens_np = rng.integers(1, span - K + 1, S).astype(np.int32)
        tables = torch.as_tensor(_paged_tables(rng, -(-lens_np // BS), NB,
                                               MB), device="cuda")
        vtables = torch.as_tensor(_paged_tables(
            rng, -(-(vlens_np + K) // BS), NB, MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        vlens = torch.as_tensor(vlens_np, device="cuda")
        q, qv = rnd(S, H, D), rnd(S, K, H, D)
        live, vkeys = int(lens_np.sum()), int(vlens_np.sum()) + S * K
        pairs = sum(K * int(n) + K * (K + 1) // 2 for n in vlens_np)
        fp, i8 = (kp, vp, {}), (kq, vq, dict(k_scale=ks, v_scale=vs))
        # name, pool, the call's args, live keys, flops, query rows
        cases = [("paged_decode_attention", fp, (q, tables, lens), live,
                  4 * live * H * D, 1),
                 ("paged_decode_attention_int8", i8, (q, tables, lens), live,
                  4 * live * H * D, 1),
                 ("paged_verify_attention", fp, (qv, vtables, vlens), vkeys,
                  4 * pairs * H * D, K),
                 ("paged_verify_attention_int8", i8, (qv, vtables, vlens),
                  vkeys, 4 * pairs * H * D, K)]
        for name, (kpool, vpool, sc), (qq, tt, ll), keys, flops, rows in cases:
            verify = "verify" in name
            fname = ("paged_verify_attention" if verify
                     else "paged_decode_attention")
            plain = getattr(da, fname + "_reference")(
                qq, kpool, vpool, tt, ll, **sc)
            calls = {tag: (lambda m=m: getattr(m, fname)(
                qq, kpool, vpool, tt, ll, **sc)) for tag, m in mods.items()}
            errs = {}
            for tag, fn in calls.items():
                a, b = fn(), fn()
                torch.cuda.synchronize()
                errs[tag] = (a.float() - plain.float()).abs().max().item()
                if not errs[tag] <= DECODE_TOL:
                    raise RuntimeError(f"{name} {shape}: {tag} kernel off "
                                       f"the plain version: {errs[tag]}")
                if tag == "this" and not torch.equal(a, b):
                    raise RuntimeError(f"{name} {shape}: other bits on the "
                                       f"same inputs")
            times = in_turns(calls, 50, flush, cuda_ms)
            # SDPA over the cache already gathered (and dequantized)
            t = tt.long()
            if sc:
                kc, vc = [(p[t].float() * sp[t].transpose(-1, -2)[..., None]
                           ).to(torch.bfloat16) for p, sp in ((kq, ks),
                                                              (vq, vs))]
            else:
                kc, vc = kp[t], vp[t]
            kc, vc = (x.reshape(S, span, KH, D).transpose(1, 2)
                      for x in (kc, vc))
            pos = torch.arange(span, device="cuda")
            mask = (pos[None, None, :] <= ll[:, None, None]
                    + torch.arange(rows, device="cuda")[None, :, None]
                    if verify else pos[None, None, :] < ll[:, None, None])
            qt = qq.transpose(1, 2) if verify else qq[:, :, None]
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask[:, None], enable_gqa=KH != H), 50,
                flush)
            kv_bytes = (2 * D + 8) * keys * KH if sc else 2 * 2 * keys * KH * D
            bound, by = _bound(kv_bytes + 2 * 2 * S * rows * H * D
                               + 4 * S * (MB + 1), flops, H100_F32_FLOPS)
            print(json.dumps({
                "kernel": name, "shape": shape, "this_ms": times["this"],
                "other_ms": times["other"], "sdpa_ms": lib,
                "bound_ms": bound, "bound_by": by,
                "plan": None if verify else da.paged_split_plan(
                    span, S * KH * da.paged_row_groups(H // KH),
                    torch.cuda.get_device_properties(0).multi_processor_count),
                "max_abs_err": errs}), flush=True)
    # the host wall of one decode call at the GPT-2 XL shape
    H, KH, D = 25, 25, 64
    kp = torch.randn((NB, BS, KH, D), device="cuda", dtype=torch.bfloat16)
    q = torch.randn((S, H, D), device="cuda", dtype=torch.bfloat16)
    lens = torch.full((S,), 500, dtype=torch.int32, device="cuda")
    tables = torch.arange(1, S * MB + 1, dtype=torch.int32,
                          device="cuda").reshape(S, MB)
    us = host_us({tag: (lambda m=m: m.paged_decode_attention(
        q, kp, kp, tables, lens)) for tag, m in mods.items()})
    print(json.dumps({"host_us_per_call": us, "shape": "gpt2-xl S=8"}),
          flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
