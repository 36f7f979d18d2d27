#!/usr/bin/env python3
"""The flash-attention forward kernel (B1) of this checkout against the B1
of another checkout of the repository, on one NVIDIA GPU, in one process.

    python3 scripts/compare_flash_fwd.py OTHER_CHECKOUT

Builds ``OTHER_CHECKOUT/deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu``
with this checkout's nvcc flags into ``build/`` and loads it beside this
checkout's library (the C interface of either: with or without the
persistent kernel's tile counter, with or without the true head dim beside
the kernel width). At two shapes, causal
bf16 with q/k/v as views of one fused [B, T, 3 H D] projection (as the
models hand them over):

* GPT-2 XL prefill, [8, 1024, 25, 64];
* the GPT-2 1.3B training step, [8, 1024, 16, 128];

it checks both kernels against the plain PyTorch version (chip_smoke.py's
tolerances), then times them in turns (other, this, this, other; device
time by CUDA events behind a device spin, after an L2 flush, as
chip_smoke.py's ``cuda_ms``), beside SDPA and the bound, and prints one
JSON line per shape and the card's name and power limit.
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

from chip_smoke import (FLASH_TOL, H100_BF16_FLOPS, H100_BYTES_PER_S,  # noqa: E402
                        LSE_TOL, cuda_ms)
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import builder  # noqa: E402

SHAPES = [("gpt2-xl T=1024", 8, 1024, 25, 64),
          ("gpt2-1.3b train T=1024", 8, 1024, 16, 128)]


def load_other(checkout: str) -> ctypes.CDLL:
    src = os.path.join(checkout, "deepspeed_tpu_torch", "ops", "csrc",
                       "flash_attention_fwd.cu")
    out = os.path.join(ROOT, "build", "other_flash_attention_fwd.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([builder.find_nvcc(), *builder.NVCC_FLAGS, src, "-o", out],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    text = open(src).read()
    lib.counter = "void* next_tile" in text
    lib.dv = "int D, int Dv" in text
    lib.dstt_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * (6 if lib.counter else 5)
        + [ctypes.c_int] * (6 if lib.dv else 5)
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_flash_attention_fwd.restype = ctypes.c_int
    lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dstt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib, q, k, v, o, lse):
    """One launch as the wrapper makes it (a zeroed tile counter for the
    persistent kernel)."""
    B, T, H, D = q.shape
    counter = ([torch.zeros(1, dtype=torch.int32, device="cuda").data_ptr()]
               if lib.counter else [])
    rc = lib.dstt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *counter, B, T, H, k.shape[2], D,
        *([D] if lib.dv else []), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / math.sqrt(D), 1, 2, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {lib.dstt_cuda_error_string(rc)}")


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this, other = fa.BUILDER.load(), load_other(sys.argv[1])
    this.counter = this.dv = True
    F = torch.nn.functional
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, B, T, H, D in SHAPES:
        qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        o = torch.empty((B, T, H, D), dtype=q.dtype, device="cuda")
        lse = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
        ref, lse_ref = fa.flash_attention_reference(q, k, v, True)
        errs = {}
        for tag, lib in (("other", other), ("this", this)):
            launch(lib, q, k, v, o, lse)
            torch.cuda.synchronize()
            errs[tag] = ((o.float() - ref.float()).abs().max().item(),
                         (lse - lse_ref).abs().max().item())
            if not (errs[tag][0] <= FLASH_TOL and errs[tag][1] <= LSE_TOL):
                raise RuntimeError(f"{name}: {tag} kernel off the plain "
                                   f"version: {errs[tag]}")
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            lib = other if tag == "other" else this
            times[tag].append(cuda_ms(lambda: launch(lib, q, k, v, o, lse),
                                      50, flush))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50, flush)
        flops = 4 * B * H * D * T * (T + 1) // 2
        nbytes = 2 * 4 * B * T * H * D + 4 * B * H * T
        tf, tb = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        print(json.dumps({
            "shape": name, "B": B, "T": T, "H": H, "D": D,
            "this_ms": times["this"], "other_ms": times["other"],
            "sdpa_ms": sdpa, "bound_ms": max(tf, tb) * 1e3,
            "bound_by": "operations" if tf > tb else "bytes",
            "this_tflops": flops / min(times["this"]) / 1e9,
            "max_abs_err": errs}), flush=True)
        del qkv, q, k, v, o, lse, ref, lse_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
