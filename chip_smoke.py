#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
before its last line:

1. build  — compile every CUDA kernel of the slice from
   ``deepspeed_tpu_torch/ops/csrc`` (one nvcc per source, in parallel).
2. flash  — the flash-attention kernel against its plain PyTorch version in
   bf16 at GPT-2 XL prefill shapes (B=8, T in {128, 1024}, H=25, D=64), a
   GQA case (H=32, KH=8, D=128), a ragged T and a full (non-causal) case.
3. decode — the decode-attention kernel against its plain version at
   B=8, S=1024, H=25, D=64 with seeded lengths in [1, 1024], a GQA case and
   a length-0 row.
4. e2e    — ``deepspeed_tpu_torch.init_inference`` → ``generate`` at GPT-2 XL
   width (48 layers, n_embd 1600, 25 heads, bf16, random weights from a
   seed) on 8 seeded prompts of 64-900 tokens, 32 new tokens, greedy. The
   kernel launch counts are set to 0 just before that call and read just
   after. Then decode == prefill: decode-path logits against
   ``causal_forward`` logits taken with the flash kernel's plain version.

It prints the card's name and power limit (nvidia-smi), one JSON line of
per-kernel numbers, and, last, ``{"ok": true, "device": {...}}``. It exits
non-zero with no result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
# bf16 output of attention (|o| <= ~1, one bf16 step is <= 3.9e-3 there);
# both sides round P to bf16 but may land one step apart where their exp
# differs in the last bits
FLASH_TOL = 2e-2
LSE_TOL = 1e-3   # f32 on both sides; only summation order differs
DECODE_TOL = 1e-2   # f32 math on both sides, output rounded to bf16
# decode == prefill on full-model logits (std ~1): the two paths round in
# bf16 at different places (GEMMs of M=2 vs M=2048 rows pick different
# kernels; attention through two different implementations) and the
# residual stream of 48 random-weight layers grows to where one bf16 step
# is ~0.06, so logits may differ by ~0.1; a position or cache-slot bug
# moves them by O(1)
E2E_MAX_TOL = 0.35
E2E_MEAN_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after
    ``flush`` is rewritten (it is larger than the 50 MB L2, so every launch
    finds its inputs in device memory, as the model's call does)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def phase_build():
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.op_builder import build_all
    t0 = time.perf_counter()
    build_all([fa.BUILDER, da.BUILDER])
    log(f"[build] both kernels built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    for b in (fa.BUILDER, da.BUILDER):
        for line in b.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {b.name}: {line.strip()}")


def phase_flash(flush):
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [("gpt2-xl T=128", 8, 128, 25, 25, 64, True),
             ("gpt2-xl T=1024", 8, 1024, 25, 25, 64, True),
             ("gqa H=32 KH=8 D=128", 2, 1024, 32, 8, 128, True),
             ("ragged T=1000", 8, 1000, 25, 25, 64, True),
             ("full T=300", 2, 300, 25, 25, 64, False)]
    worst, main = 0.0, None
    for name, B, T, H, KH, D, causal in cases:
        q = torch.randn((B, T, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn((B, T, KH, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn((B, T, KH, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash {name}: max |o - o_ref| = {err} > {FLASH_TOL}")
        check(math.isfinite(lerr) and lerr <= LSE_TOL,
              f"flash {name}: max |lse - lse_ref| = {lerr} > {LSE_TOL}")
        worst = max(worst, err)
        pairs = T * (T + 1) // 2 if causal else T * T
        flops = 4 * B * H * D * pairs
        nbytes = 2 * (2 * B * T * H * D + 2 * B * T * KH * D) + 4 * B * H * T
        bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / H100_BF16_FLOPS
                    > nbytes / H100_BYTES_PER_S else "bytes")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal), 20,
                     flush)
        plain = cuda_ms(lambda: flash_attention_reference(q, k, v, causal),
                        5, flush)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=KH != H), 20, flush)
        log(f"[flash] {name}: max|o err| {err!r} (tol {FLASH_TOL}), "
            f"max|lse err| {lerr!r} (tol {LSE_TOL}); kernel {ms!r} ms, "
            f"plain {plain!r} ms, sdpa {lib!r} ms, bound {bound!r} ms "
            f"({bound_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        if name == "gpt2-xl T=1024":
            main = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                        bound_by=bound_by, library_ms=lib)
        del q, k, v, o, o_ref, lse, lse_ref
    return dict(main, max_abs_err=worst)


def phase_decode(flush):
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    cases = [("gpt2-xl", 8, 1024, 25, 25, 64), ("gqa H=32 KH=8 D=128", 8,
                                                  1024, 32, 8, 128)]
    worst, main = 0.0, None
    for name, B, S, H, KH, D in cases:
        # the layer view of a 2-layer cache, as the model passes it
        kc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        vc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        q = torch.randn((B, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                               device="cuda")
        o = decode_attention(q, kc, vc, lens)
        o_ref = decode_attention_reference(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= DECODE_TOL,
              f"decode {name}: max |o - o_ref| = {err} > {DECODE_TOL}")
        worst = max(worst, err)
        live = int(lens.sum())
        nbytes = 2 * 2 * live * KH * D + 2 * 2 * B * H * D + 4 * B
        flops = 4 * live * H * D
        bound = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / H100_BYTES_PER_S
                    >= flops / H100_F32_FLOPS else "operations")
        ms = cuda_ms(lambda: decode_attention(q, kc, vc, lens), 50, flush)
        plain = cuda_ms(lambda: decode_attention_reference(q, kc, vc, lens),
                        10, flush)
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=KH != H), 50, flush)
        log(f"[decode] {name}: lengths sum {live}, max|o err| {err!r} "
            f"(tol {DECODE_TOL}); kernel {ms!r} ms, plain {plain!r} ms, "
            f"sdpa {lib!r} ms, bound {bound!r} ms ({bound_by}), "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        if name == "gpt2-xl":
            main = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                        bound_by=bound_by, library_ms=lib)
    # a length-0 row gives zeros, as the TPU kernel does
    lens = torch.tensor([0, 5], dtype=torch.int32, device="cuda")
    o = decode_attention(q[:2], kc[:2], vc[:2], lens)
    check(bool((o[0] == 0).all()) and bool(torch.isfinite(o).all()),
          "decode: a length-0 row must give zeros")
    return dict(main, max_abs_err=worst)


def gpt2_xl_config():
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    # HF openai-community/gpt2-xl config.json, at its published widths
    return InferenceTransformerConfig(
        vocab_size=50257, n_positions=1024, n_embd=1600, n_layer=48,
        n_head=25, activation="gelu_new", layer_norm_eps=1e-5,
        positional="learned", tied_lm_head=True, dtype=torch.bfloat16)


def phase_e2e(cfg, dev="cuda"):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        causal_forward, decode_step, init_params, prefill)
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_fwd
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[e2e] random weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.3f} s")
    engine = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype=str(cfg.dtype).replace("torch.", ""), device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(cfg.n_positions // 16, cfg.n_positions * 7 // 8 + 5, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 32
    engine.generate(prompts, max_new_tokens=2)   # warm-up: cuBLAS, allocator

    def timed(n):
        t = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=n)
        return out, time.perf_counter() - t

    _, t_pre = timed(1)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    decode_attention.launches = 0
    out, t_gen = timed(new)   # THE main path
    n_flash, n_decode = flash_attention_fwd.launches, decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    _, t_pre2 = timed(1)
    _, t_gen2 = timed(new)
    steps = new - 1   # token 0 comes from the prefill logits
    check(n_flash == cfg.n_layer,
          f"flash launches {n_flash} != {cfg.n_layer} (one prefill)")
    check(n_decode == cfg.n_layer * steps,
          f"decode launches {n_decode} != {cfg.n_layer} x {steps} steps")
    for b, row in enumerate(out):
        check(len(row) == lens[b] + new and row[:lens[b]] == prompts[b],
              f"row {b}: prompt not kept or wrong length {len(row)}")
        check(all(0 <= t < cfg.vocab_size for t in row[lens[b]:]),
              f"row {b}: token out of range")
    per_tok = [(tg - tp) / steps * 1e3 for tg, tp in
               ((t_gen, t_pre), (t_gen2, t_pre2))]
    log(f"[e2e] generate 8 x {new} tokens: {t_gen!r} s and {t_gen2!r} s; "
        f"prefill (generate of 1 token) {t_pre * 1e3!r} ms and "
        f"{t_pre2 * 1e3!r} ms; decode {per_tok[0]!r} and {per_tok[1]!r} "
        f"ms per step; {8 * new / t_gen!r} tokens/s; peak memory "
        f"{peak} bytes; launches flash {n_flash}, decode {n_decode}")

    # per-step host time: enqueue (no sync) vs device time of one step
    with torch.inference_mode():
        ids = np.zeros((8, cfg.n_positions), np.int64)
        for b, p in enumerate(prompts):
            ids[b, :len(p)] = p
        cache = engine._make_cache(8, cfg.n_positions)
        lg, cache = prefill(engine.params, engine.model_config,
                            torch.as_tensor(ids, device=dev),
                            torch.as_tensor(lens, device=dev), cache)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        host, dev_ms = [], []
        for _ in range(8):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            th = time.perf_counter()
            s.record()
            lg, cache = decode_step(engine.params, engine.model_config, tok,
                                    cache)
            e.record()
            host.append(time.perf_counter() - th)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            dev_ms.append(s.elapsed_time(e))
    log(f"[e2e] one decode step (B=8): host enqueue "
        f"{float(np.median(host)) * 1e3!r} ms, device "
        f"{float(np.median(dev_ms))!r} ms "
        f"(medians of 8)")

    # decode == prefill: decode-path logits (kernels) against a forward
    # over the same tokens through the flash kernel's plain version
    rows = [int(np.argmin(lens)), int(np.argmax(lens))]
    k_steps = 4
    with torch.inference_mode():
        p_ids = np.zeros((2, cfg.n_positions), np.int64)
        f_ids = np.zeros((2, cfg.n_positions), np.int64)
        for i, r in enumerate(rows):
            p_ids[i, :lens[r]] = prompts[r]
            f_ids[i, :lens[r] + k_steps] = out[r][:lens[r] + k_steps]
        plen = torch.as_tensor(lens[rows], device=dev)
        cache = engine._make_cache(2, cfg.n_positions)
        lg, cache = prefill(engine.params, engine.model_config,
                            torch.as_tensor(p_ids, device=dev), plen,
                            cache)
        dec = [lg]
        for s in range(k_steps):
            tok = torch.as_tensor([out[r][lens[r] + s] for r in rows],
                                  device=dev)
            lg, cache = decode_step(engine.params, engine.model_config, tok,
                                    cache)
            dec.append(lg)
        ref = causal_forward(engine.params, engine.model_config,
                             torch.as_tensor(f_ids, device=dev),
                             reference_attention=True)
        errs = []
        for s, lg in enumerate(dec):
            for i, r in enumerate(rows):
                d = (lg[i] - ref[i, lens[r] - 1 + s]).abs()
                errs.append((d.max().item(), d.mean().item()))
    mx = max(e[0] for e in errs)
    mean = max(e[1] for e in errs)
    log(f"[e2e] decode == prefill on rows {rows}, {k_steps + 1} positions "
        f"each: max |logit diff| {mx!r} (tol {E2E_MAX_TOL}), worst mean "
        f"{mean!r} (tol {E2E_MEAN_TOL})")
    check(math.isfinite(mx) and mx <= E2E_MAX_TOL and mean <= E2E_MEAN_TOL,
          "decode-path logits disagree with the full forward")
    return {"flash_attention_fwd": n_flash, "decode_attention": n_decode}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401 — fails outside a checkout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    phase_build()
    kernels = {"flash_attention_fwd": phase_flash(flush),
               "decode_attention": phase_decode(flush)}
    launches = phase_e2e(gpt2_xl_config())
    meta = {
        "flash_attention_fwd": (
            "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:65"),
        "decode_attention": (
            "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:78"),
    }
    rows = []
    for name, nums in kernels.items():
        src, rep = meta[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
                     "plain_ms": nums["plain_ms"],
                     "bound_ms": nums["bound_ms"],
                     "bound_by": nums["bound_by"],
                     "library_ms": nums["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
