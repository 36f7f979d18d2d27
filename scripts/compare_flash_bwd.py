#!/usr/bin/env python3
"""The flash-attention backward kernels (B2 dq, B3 dk/dv) of this checkout
against those of another checkout of the repository, on one NVIDIA GPU, in
one process.

    python3 scripts/compare_flash_bwd.py OTHER_CHECKOUT

Builds ``OTHER_CHECKOUT/deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu``
with this checkout's nvcc flags into ``build/`` and loads it beside this
checkout's library (the C interface of either: with or without the
persistent kernels' tile counter, with or without the true head dim beside
the kernel width). At two shapes, causal bf16 with q/k/v as
views of one fused [B, T, 3 H D] projection (as the models hand them over):

* the GPT-2 1.3B training step, [8, 1024, 16, 128];
* GPT-2 XL, [8, 1024, 25, 64];

it checks both pairs against the plain PyTorch versions (chip_smoke.py's
``BWD_TOL`` gates), then times dq, dk/dv and the pair in turns (other,
this, this, other; device time by CUDA events behind a device spin, after
an L2 flush, as chip_smoke.py's ``cuda_ms``), beside SDPA's backward (dq,
dk and dv in one call) and the bounds, and prints one JSON line per shape
and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (BWD_TOL, H100_BF16_FLOPS, _bound,  # noqa: E402
                        bwd_error, cuda_ms)
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import builder  # noqa: E402

SHAPES = [("gpt2-1.3b train T=1024", 8, 1024, 16, 128),
          ("gpt2-xl T=1024", 8, 1024, 25, 64)]


def load_other(checkout: str) -> ctypes.CDLL:
    src = os.path.join(checkout, "deepspeed_tpu_torch", "ops", "csrc",
                       "flash_attention_bwd.cu")
    out = os.path.join(ROOT, "build", "other_flash_attention_bwd.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([builder.find_nvcc(), *builder.NVCC_FLAGS, src, "-o", out],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    text = open(src).read()
    lib.counter = "void* next_tile" in text
    lib.dv = "int D, int Dv" in text
    # the persistent kernels' C interface adds the tile counter and, for
    # dk/dv, the distance of the lse and delta rows; the head-dim route the
    # true head dim beside the kernel width
    for fn, n_ints, n_strides in (
            (lib.dstt_flash_attention_bwd_dq, 5 + lib.dv, 15),
            (lib.dstt_flash_attention_bwd_dkv,
             (6 if lib.counter else 5) + lib.dv, 12)):
        fn.argtypes = ([ctypes.c_void_p] * (9 if lib.counter else 8)
                       + [ctypes.c_int] * n_ints + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dstt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, rc):
    if rc:
        raise RuntimeError(f"launch failed: {lib.dstt_cuda_error_string(rc)}")


def _counter(lib):
    return ([torch.zeros(1, dtype=torch.int32, device="cuda").data_ptr()]
            if lib.counter else [])


def launch_dq(lib, q, k, v, o, lse, do, dq, delta):
    B, T, H, D = q.shape
    _check(lib, lib.dstt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_counter(lib), B, T,
        H, k.shape[2], D, *([D] if lib.dv else []),
        *fa._strides(q, k, v, o, do), 1.0 / math.sqrt(D),
        1, 2, torch.cuda.current_stream().cuda_stream))


def launch_dkv(lib, q, k, v, lse, delta, do, dk, dv):
    B, T, H, D = q.shape   # T is a multiple of 4: lse rows are T apart
    _check(lib, lib.dstt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_counter(lib), B, T, H, k.shape[2], D, *([D] if lib.dv else []),
        *([T] if lib.counter else []),
        *fa._strides(q, k, v, do),
        1.0 / math.sqrt(D), 1, 2, torch.cuda.current_stream().cuda_stream))


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this, other = fa.BWD_BUILDER.load(), load_other(sys.argv[1])
    this.counter = this.dv = True
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, B, T, H, D in SHAPES:
        qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        do = torch.randn((B, T, H, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        scale = 1.0 / math.sqrt(D)
        rq, rdelta = fa._bwd_dq_reference(q, k, v, o, lse, do, True, scale)
        rk, rv = fa._bwd_dkv_reference(q, k, v, lse, rdelta, do, True, scale)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty_like(lse)
        errs = {}
        for tag, lib in (("other", other), ("this", this)):
            launch_dq(lib, q, k, v, o, lse, do, dq, delta)
            launch_dkv(lib, q, k, v, lse, delta, do, dk, dv)
            torch.cuda.synchronize()
            stats = {key: bwd_error(a, r, **BWD_TOL["16"]) for key, a, r in
                     (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
            for key, st in stats.items():
                lim = BWD_TOL["16"]["l2"]
                if not (math.isfinite(st["max_err"]) and st["elem"] <= 1.0
                        and st["rel_l2"] <= lim and st["tile_l2"] <= lim):
                    raise RuntimeError(f"{name}: {tag} {key} off the plain "
                                       f"version: {st}")
            errs[tag] = {key: st["max_err"] for key, st in stats.items()}
        runs = {
            "dq": lambda lib: launch_dq(lib, q, k, v, o, lse, do, dq, delta),
            "dkv": lambda lib: launch_dkv(lib, q, k, v, lse, delta, do, dk,
                                          dv)}
        runs["pair"] = lambda lib: (runs["dq"](lib), runs["dkv"](lib))
        times = {f"{tag}_{kind}_ms": [] for tag in ("this", "other")
                 for kind in runs}
        for tag in ("other", "this", "this", "other"):
            lib = other if tag == "other" else this
            for kind, fn in runs.items():
                times[f"{tag}_{kind}_ms"].append(
                    cuda_ms(lambda: fn(lib), 50, flush))
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        sdpa = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 50, flush)
        pairs = T * (T + 1) // 2
        flops = {"dq": 6 * B * H * D * pairs, "dkv": 8 * B * H * D * pairs}
        bhtd, bht = B * T * H * D, B * H * T
        bounds = {"dq": _bound(2 * 6 * bhtd + 8 * bht, flops["dq"],
                               H100_BF16_FLOPS),
                  "dkv": _bound(2 * 6 * bhtd + 8 * bht, flops["dkv"],
                                H100_BF16_FLOPS)}
        print(json.dumps({
            "shape": name, "B": B, "T": T, "H": H, "D": D, **times,
            "sdpa_bwd_ms": sdpa,
            "bound_ms": {kind: b[0] for kind, b in bounds.items()},
            "bound_by": {kind: b[1] for kind, b in bounds.items()},
            "this_tflops": {kind: flops[kind] / min(times[f"this_{kind}_ms"])
                            / 1e9 for kind in flops},
            "other_tflops": {kind: flops[kind]
                             / min(times[f"other_{kind}_ms"]) / 1e9
                             for kind in flops},
            "max_abs_err": errs}), flush=True)
        del qkv, q, k, v, o, lse, do, dq, dk, dv, rq, rk, rv, out, qt, kt, vt
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
