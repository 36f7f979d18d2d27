#!/usr/bin/env python3
"""Where the time of an int8 GPT-2 XL decode step goes, on one NVIDIA GPU.

Builds GPT-2 XL at its published widths (random weights from a seed, as
chip_smoke.py does) three times over the same weights: bf16, int8
weight-only (``dtype="int8"``: row-group int8 storage, each projection
dequantized into bf16 per call) and w8a8 (``quant.activation``: every
projection an int8 x int8 ``torch._int_mm`` with per-token activation
quant). For each it prefills chip_smoke.py's 8 prompts into the engine's
kept dense cache and profiles 8 replays of ``generate``'s CUDA graph of
the decode step under ``torch.profiler``, in turns bf16, int8, w8a8, w8a8,
int8, bf16. It prints each run's host wall, device kernel time, busy
share, kernels a step and the device time by kind of kernel, then the
split of an int8 and a w8a8 step: ``_int_mm`` (cuBLAS int8 kernels, by
name), the dequant copies (weight-only) or quant elementwise work (w8a8)
— the elementwise, copy and reduction time the step spends beyond the
bf16 step's —, the 16-bit GEMMs and attention, and the rest. Each step's
time on CUDA events (median of 20 replays) is printed too. Then, with those
weights freed, one ``train_batch`` of GPT-2 1.3B (chip_smoke.py's train
configuration) in bf16 and with ``int8_training`` (SwitchBack), each after
a warm-up step, with its device time by the same kinds.

    python3 scripts/profile_int8.py [TRACE_DIR]
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import gpt2_xl_config  # noqa: E402

STEPS = 8
KINDS = ("int8 GEMM (_int_mm)", "16-bit GEMM", "attention kernels",
         "elementwise, copies, reductions")


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def kind(kernel: str) -> str:
    k = kernel.lower()
    gemm = any(s in k for s in ("nvjet", "gemm", "cutlass", "sm90_", "xmma"))
    if gemm and any(s in k for s in ("_s8", "s8s8", "int8", "imma")):
        return KINDS[0]
    if gemm:
        return KINDS[1]
    if any(s in kernel for s in ("flash_fwd", "decode_kernel", "paged_",
                                 "decode_dense")):
        return KINDS[2]
    return KINDS[3]


def profiled(name, fn, steps, trace_dir):
    """Device time by kind over ``steps`` calls of ``fn``, per call."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    n = sum(e.count for e in kernels)
    by = dict.fromkeys(KINDS, 0.0)
    for e in kernels:
        by[kind(e.key)] += device_us(e) / steps / 1e3
    print(f"[{name}] {steps} steps: host wall {wall * 1e3!r} ms, device "
          f"kernel time {total / 1e3!r} ms, busy share "
          f"{total / 1e6 / wall!r}, {n / steps!r} kernels a step")
    for k, ms in by.items():
        print(f"[{name}]   {ms:9.4f} ms a step  {k}")
    for e in sorted(kernels, key=device_us, reverse=True)[:10]:
        print(f"[{name}]   {device_us(e) / steps / 1e3:9.4f} ms a step "
              f"{e.count // steps:5d} x  {e.key[:110]}")
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"trace_int8_{name}.json"))
    return by, n / steps


def profile_steps(name, step, tok, trace_dir):
    """Device time by kind over ``STEPS`` replays of ``step``."""
    state = [tok]

    def one():
        state[0] = step(state[0]).argmax(-1)
    return profiled(name, one, STEPS, trace_dir)


def train_steps(trace_dir):
    """One profiled ``train_batch`` of gpt2-1.3b, bf16 and SwitchBack."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    batch = {"input_ids": np.random.default_rng(6).integers(
        0, 50257, (16, 1024), dtype=np.int32)}
    for int8 in (False, True):
        model = GPT2LMModel(dataclasses.replace(config_for("gpt2-1.3b"),
                                                int8_training=int8))
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=model.init(
                torch.Generator(device="cuda").manual_seed(0)),
            config={"train_micro_batch_size_per_gpu": 8,
                    "gradient_accumulation_steps": 2,
                    "gradient_clipping": 1.0, "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW", "params": {
                        "lr": 1e-4, "weight_decay": 0.01}}})
        engine.train_batch(batch)   # warm-up
        profiled("train_step_" + ("int8" if int8 else "bf16"),
                 lambda: engine.train_batch(batch), 1, trace_dir)
        del engine, model
        torch.cuda.empty_cache()


def event_ms(step, tok, n=20):
    out = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        tok = step(tok).argmax(-1)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        init_params, prefill)
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_xl_config()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    lens = rng.integers(cfg.n_positions // 16, cfg.n_positions * 7 // 8 + 5,
                        8)
    ids = np.zeros((8, cfg.n_positions), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(0, cfg.vocab_size, n)
    modes = {"bf16": dict(dtype="bfloat16"), "int8": dict(dtype="int8"),
             "w8a8": dict(dtype="bfloat16", quant={
                 "enabled": True, "activation": {"enabled": True}})}
    steps = {}
    with torch.inference_mode():
        for name, kw in modes.items():
            eng = deepspeed_tpu_torch.init_inference(
                (cfg, params), max_out_tokens=cfg.n_positions, **kw)
            eng.generate([ids[0, :lens[0]].tolist()], max_new_tokens=2)
            cache = eng._make_cache(8, cfg.n_positions)
            lg, cache = prefill(eng.params, eng.model_config,
                                torch.as_tensor(ids, device="cuda"),
                                torch.as_tensor(lens, device="cuda"), cache)
            step = eng._decode_fn(cache)
            tok = lg.argmax(-1)
            for _ in range(2):   # the graph's warm-up and capture
                tok = step(tok).argmax(-1)
            steps[name] = (eng, step, tok)
        res = {}
        for name in ("bf16", "int8", "w8a8", "w8a8", "int8", "bf16"):
            _, step, tok = steps[name]
            res.setdefault(name, []).append(
                profile_steps(name, step, tok, trace_dir))
            print(f"[{name}] one replayed step on CUDA events: "
                  f"{event_ms(step, tok)!r} ms (median of 20)")
    base = {k: float(np.mean([r[0][k] for r in res["bf16"]])) for k in KINDS}
    for name in ("int8", "w8a8"):
        by = {k: float(np.mean([r[0][k] for r in res[name]])) for k in KINDS}
        extra = by[KINDS[3]] - base[KINDS[3]]
        what = "dequant copies" if name == "int8" else "quant elementwise"
        kernels = np.mean([r[1] for r in res[name]]) - np.mean(
            [r[1] for r in res["bf16"]])
        print(f"[split] {name} decode step (B=8, graphed, ms a step of "
              f"device time, mean of 2 profiles): _int_mm {by[KINDS[0]]!r}; "
              f"{what} (elementwise beyond bf16's step) {extra!r}; 16-bit "
              f"GEMMs {by[KINDS[1]]!r} (bf16 step {base[KINDS[1]]!r}); "
              f"attention {by[KINDS[2]]!r}; the rest (bf16's own "
              f"elementwise) {base[KINDS[3]]!r}; {float(kernels)!r} more "
              f"kernels a step than bf16's; {smi}")
    del steps, params, eng, cache, lg
    gc.collect()   # engines and their graphs hold reference cycles
    torch.cuda.empty_cache()
    train_steps(trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
