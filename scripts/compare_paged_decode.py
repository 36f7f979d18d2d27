#!/usr/bin/env python3
"""The paged kernels of this checkout against another checkout's, on one
NVIDIA GPU, in one process: decode (B5, B5i), verify (B7, B7i) and chunked
prefill (B6, B6i).

    git archive <commit> deepspeed_tpu_torch | tar -x -C build/parent
    python3 scripts/compare_paged_decode.py build/parent

Loads the other checkout's wrapper (``ops/decode_attention.py``) with its
own ``paged_attention.cu`` and ``paged_chunk_attention.cu``
(``other_checkout.py``). At chip_smoke.py's phase paged shapes (S=8 slots,
BS=128, MB=8, NB=65, bf16, seeded lengths in [1, 1024], shuffled tables;
verify K=4; chunks of C=256 at start 0, 256 and 512 of one slot, and the
short chunks of a server with smaller ``prefill_chunk_tokens``, whose q
tiles leave most SMs idle: C=64 and 128 at start 512 and 896; GPT-2 XL
heads H=KH=25, D=64, and GQA H=32, KH=8, D=128), for the fp and the int8
pool, it checks both wrappers against the plain version (chip_smoke.py's
DECODE_TOL, FLASH_TOL for the chunk) and that a second call of this
checkout's gives the same bits, then times each kernel in turns (other,
this, this, other; device time by CUDA events behind a device spin, after
an L2 flush, as chip_smoke.py's ``cuda_ms``) beside SDPA over the cache
already gathered (and dequantized) and the bound. Then the host wall of
one call of each fp wrapper at the GPT-2 XL shape (decode and verify at
S=8, a C=256 chunk at start 256): the median over 2000 calls of each
checkout's, interleaved one by one, without a sync. Prints one JSON line
per kernel and shape and the card's name and power limit.
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

from chip_smoke import (DECODE_TOL, FLASH_TOL, H100_BF16_FLOPS,  # noqa: E402
                        H100_F32_FLOPS, _bound, _int8_layer_pool,
                        _paged_tables, cuda_ms)
from deepspeed_tpu_torch.ops import decode_attention as da  # noqa: E402
from other_checkout import card, in_turns, load_wrapper  # noqa: E402

S, BS, MB, NB, K, C = 8, 128, 8, 65, 4, 256
CHUNKS = [(C, 0), (C, 256), (C, 512), (64, 512), (64, 896), (128, 512),
          (128, 896)]   # (C, start)
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
                                  ["PAGED_BUILDER", "CHUNK_BUILDER"]),
            "this": da}
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    span = MB * BS
    pos = torch.arange(span, device="cuda")
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
        row = torch.as_tensor(_paged_tables(rng, [MB], NB, MB)[0],
                              device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        vlens = torch.as_tensor(vlens_np, device="cuda")
        q, qv = rnd(S, H, D), rnd(S, K, H, D)
        live, vkeys = int(lens_np.sum()), int(vlens_np.sum()) + S * K
        vpairs = sum(K * int(n) + K * (K + 1) // 2 for n in vlens_np)
        pools = {"": (kp, vp, {}),
                 "_int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
        # function, case, its args before the pools' scales, live keys a
        # kv head, flops, q/o bytes, table bytes, tolerance, SDPA's q and
        # mask over the gathered cache [slots, KH, span, D], its tables
        cases = [("paged_decode_attention", "", (q, None, None, tables,
                                                 lens),
                  live, 4 * live * H * D, 2 * 2 * S * H * D, 4 * S * (MB + 1),
                  DECODE_TOL, q[:, :, None],
                  (pos[None, None, :] < lens[:, None, None])[:, None],
                  tables, H100_F32_FLOPS),
                 ("paged_verify_attention", "", (qv, None, None, vtables,
                                                 vlens),
                  vkeys, 4 * vpairs * H * D, 2 * 2 * S * K * H * D,
                  4 * S * (MB + 1), DECODE_TOL, qv.transpose(1, 2),
                  (pos[None, None, :] <= vlens[:, None, None]
                   + torch.arange(K, device="cuda")[None, :, None])[:, None],
                  vtables, H100_BF16_FLOPS)]
        for c, start in CHUNKS:
            qc = rnd(c, H, D)
            cases.append((
                "paged_chunk_attention",
                f" start={start}" if c == C else f" C={c} start={start}",
                (qc, None, None, row, start), start + c,
                4 * (c * start + c * (c + 1) // 2) * H * D, 2 * 2 * c * H * D,
                4 * MB, FLASH_TOL, qc.transpose(0, 1)[None],
                pos[None, :] <= start + torch.arange(
                    c, device="cuda")[:, None],
                row[None], H100_BF16_FLOPS))
        for (fname, at, args, keys, flops, qo_bytes, t_bytes, tol, qt, mask,
             tt, peak) in cases:
            for suffix, (kpool, vpool, sc) in pools.items():
                call_args = (args[0], kpool, vpool, *args[3:])
                plain = getattr(da, fname + "_reference")(*call_args, **sc)
                calls = {tag: (lambda m=m: getattr(m, fname)(
                    *call_args, **sc)) for tag, m in mods.items()}
                name = fname + suffix
                errs = {}
                for tag, fn in calls.items():
                    a, b = fn(), fn()
                    torch.cuda.synchronize()
                    errs[tag] = (a.float() - plain.float()).abs().max().item()
                    if not errs[tag] <= tol:
                        raise RuntimeError(f"{name} {shape}{at}: {tag} kernel "
                                           f"off the plain version: "
                                           f"{errs[tag]}")
                    if tag == "this" and not torch.equal(a, b):
                        raise RuntimeError(f"{name} {shape}{at}: other bits "
                                           f"on the same inputs")
                times = in_turns(calls, 50, flush, cuda_ms)
                # SDPA over the cache already gathered (and dequantized)
                t = tt.long()
                if sc:
                    kc, vc = [(p[t].float()
                               * sp[t].transpose(-1, -2)[..., None]
                               ).to(torch.bfloat16)
                              for p, sp in ((kq, ks), (vq, vs))]
                else:
                    kc, vc = kp[t], vp[t]
                kc, vc = (x.reshape(t.shape[0], span, KH, D).transpose(1, 2)
                          for x in (kc, vc))
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kc, vc, attn_mask=mask, enable_gqa=KH != H), 50,
                    flush)
                kv_bytes = ((2 * D + 8) * keys * KH if sc
                            else 2 * 2 * keys * KH * D)
                bound, by = _bound(kv_bytes + qo_bytes + t_bytes, flops, peak)
                print(json.dumps({
                    "kernel": name, "shape": shape + at,
                    "this_ms": times["this"], "other_ms": times["other"],
                    "sdpa_ms": lib, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": errs}), flush=True)
    # the host wall of one call of each fp wrapper at the GPT-2 XL shape
    H, KH, D = 25, 25, 64
    kp = torch.randn((NB, BS, KH, D), device="cuda", dtype=torch.bfloat16)
    lens = torch.full((S,), 500, dtype=torch.int32, device="cuda")
    tables = torch.arange(1, S * MB + 1, dtype=torch.int32,
                          device="cuda").reshape(S, MB)
    walls = {
        ("paged_decode_attention", f"gpt2-xl S={S}"): (
            torch.randn((S, H, D), device="cuda", dtype=torch.bfloat16), kp,
            kp, tables, lens),
        ("paged_verify_attention", f"gpt2-xl S={S} K={K}"): (
            torch.randn((S, K, H, D), device="cuda", dtype=torch.bfloat16),
            kp, kp, tables, lens),
        ("paged_chunk_attention", f"gpt2-xl C={C} start=256"): (
            torch.randn((C, H, D), device="cuda", dtype=torch.bfloat16), kp,
            kp, tables[0], 256)}
    for (fname, shape), args in walls.items():
        us = host_us({tag: (lambda m=m: getattr(m, fname)(*args))
                      for tag, m in mods.items()})
        print(json.dumps({"kernel": fname, "host_us_per_call": us,
                          "shape": shape}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
