#!/usr/bin/env python3
"""The LayerNorm kernels (B9 forward, B10 backward) of this checkout
against those of another checkout of the repository, on one NVIDIA GPU,
in one process.

    git archive <commit> deepspeed_tpu_torch | tar -x -C build/parent
    python3 scripts/compare_layer_norm.py build/parent

Loads the other checkout's wrapper (``ops/layer_norm.py``) with its own
``layer_norm.cu`` (``other_checkout.py``). At the shapes of chip_smoke.py's
phase layer_norm (the GPT-2 1.3B training shape, GPT-2 XL width, a ragged
R, fp16, fp32 and rows of 10001 elements; f32 weights), it checks both
wrappers' B9 output, mean and rstd and B10's dx, dw and db against the
plain versions (chip_smoke.py's LN_TOL, LN_STAT_TOL and LN_SUM_TOL) and
that a second call gives the same bits, then times them in turns (other,
this, this, other; device time by CUDA events behind a device spin, after
an L2 flush, as chip_smoke.py's ``cuda_ms``) beside ``F.layer_norm`` and
``native_layer_norm_backward`` (weights in x's dtype) and the bounds, and
prints one JSON line per shape and kernel and the card's name and power
limit. A shape a wrapper refuses (ValueError) is timed for the other only.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    H100_F32_FLOPS, LN_STAT_TOL, LN_SUM_TOL, LN_TOL, _bound, _ln_elem_ok,
    _rel_l2, cuda_ms)
from deepspeed_tpu_torch.ops import layer_norm as ln  # noqa: E402
from other_checkout import card, in_turns, load_wrapper  # noqa: E402

SHAPES = [("gpt2-1.3b train", (8 * 1024, 2048), torch.bfloat16),
          ("gpt2-xl width", (8192, 1600), torch.bfloat16),
          ("ragged", (1000, 768), torch.bfloat16),
          ("fp16", (4096, 2048), torch.float16),
          ("fp32", (4096, 2048), torch.float32),
          ("wide unaligned", (2048, 10001), torch.bfloat16)]


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = load_wrapper(sys.argv[1], "layer_norm", ["BUILDER"])
    wrappers = {"other": other.layer_norm_fwd, "this": ln.layer_norm_fwd}
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    for name, (R, N), dt in SHAPES:
        x = torch.randn((R, N), generator=g, device="cuda", dtype=dt) * 2 + .5
        w = torch.randn(N, generator=g, device="cuda") + 1
        b = torch.randn(N, generator=g, device="cuda")
        go = torch.randn((R, N), generator=g, device="cuda", dtype=dt)
        compare_bwd(name, other.layer_norm_bwd, x, w, b, go, flush)
        ro, rmean, rrstd = ln.layer_norm_fwd_reference(x, w, b, 1e-5)
        tol = LN_TOL["32" if dt == torch.float32 else "16"]
        errs = {}
        for tag, fn in wrappers.items():
            o, mean, rstd = fn(x, w, b)
            o2, mean2, rstd2 = fn(x, w, b)
            torch.cuda.synchronize()
            stat = max(((a - r).abs() / r.abs().clamp_min(1e-30)).max()
                       .item() for a, r in ((mean, rmean), (rstd, rrstd)))
            errs[tag] = (o.float() - ro.float()).abs().max().item()
            if not (_ln_elem_ok(o, ro, tol) and stat <= LN_STAT_TOL):
                raise RuntimeError(f"{name}: {tag} kernel off the plain "
                                   f"version: {errs[tag]}, {stat}")
            if not (torch.equal(o, o2) and torch.equal(mean, mean2)
                    and torch.equal(rstd, rstd2)):
                raise RuntimeError(f"{name}: {tag} kernel gave other bits "
                                   f"on the same inputs")
        times = in_turns({t: (lambda fn=fn: fn(x, w, b))
                          for t, fn in wrappers.items()}, 50, flush, cuda_ms)
        wl, bl = w.to(dt), b.to(dt)
        lib = cuda_ms(lambda: F.layer_norm(x, (N,), wl, bl, 1e-5), 50, flush)
        esz = x.element_size()
        bound, by = _bound(2 * R * N * esz + 8 * N + 8 * R, 8 * R * N,
                           H100_F32_FLOPS)
        print(json.dumps({
            "kernel": "B9", "shape": name, "R": R, "N": N, "dtype": str(dt),
            "this_ms": times["this"], "other_ms": times["other"],
            "layer_norm_ms": lib, "bound_ms": bound, "bound_by": by,
            "this_tb_per_s": 2 * R * N * esz / min(times["this"]) / 1e9,
            "max_abs_err": errs}), flush=True)
        del x, ro, go
    print(card(), flush=True)
    return 0


def compare_bwd(name, other_bwd, x, w, b, go, flush):
    """B10 of both checkouts on one shape: the plain version's gates, the
    same bits twice, then device ms in turns beside PyTorch's backward."""
    R, N = x.shape
    dt = x.dtype
    _, mean, rstd = ln.layer_norm_fwd(x, w, b)
    rdx, rdw, rdb = ln.layer_norm_bwd_reference(x, w, mean, rstd, go)
    tol = LN_TOL["32" if dt == torch.float32 else "16"]
    wrappers, errs = {}, {}
    for tag, fn in (("other", other_bwd), ("this", ln.layer_norm_bwd)):
        try:
            dx, dw, db = fn(x, w, mean, rstd, go)
        except ValueError as e:   # a row the wrapper does not take
            errs[tag] = f"refused: {e}"
            continue
        dx2, dw2, db2 = fn(x, w, mean, rstd, go)
        torch.cuda.synchronize()
        errs[tag] = (dx.float() - rdx.float()).abs().max().item()
        sums = max(_rel_l2(dw, rdw), _rel_l2(db, rdb))
        if not (_ln_elem_ok(dx, rdx, tol) and sums <= LN_SUM_TOL):
            raise RuntimeError(f"{name}: {tag} B10 off the plain version: "
                               f"{errs[tag]}, {sums}")
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)
                and torch.equal(db, db2)):
            raise RuntimeError(f"{name}: {tag} B10 gave other bits on the "
                               f"same inputs")
        wrappers[tag] = lambda fn=fn: fn(x, w, mean, rstd, go)
    if len(wrappers) == 2:
        times = in_turns(wrappers, 50, flush, cuda_ms)
    else:
        times = {t: [cuda_ms(fn, 50, flush) for _ in range(2)]
                 for t, fn in wrappers.items()}
    wl, bl = w.to(dt), b.to(dt)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [N], wl, bl, 1e-5)
    lib = cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        go, x, [N], lmean, lrstd, wl, bl, [True, True, True]), 50, flush)
    esz = x.element_size()
    bound, by = _bound(3 * R * N * esz + 4 * N + 8 * R + 8 * N, 14 * R * N,
                       H100_F32_FLOPS)
    print(json.dumps({
        "kernel": "B10", "shape": name, "R": R, "N": N, "dtype": str(dt),
        "this_ms": times.get("this"), "other_ms": times.get("other"),
        "native_backward_ms": lib, "bound_ms": bound, "bound_by": by,
        "max_abs_err": errs}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
