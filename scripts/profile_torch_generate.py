#!/usr/bin/env python3
"""Where the time of deepspeed_tpu_torch's generation, serving and
training goes, on one NVIDIA GPU.

Builds GPT-2 XL at its published widths (random weights from a seed), runs
one prefill of 8 prompts (64-900 tokens, the prompts of chip_smoke.py),
then 8 decode steps eagerly (``decode_x8``) and 8 as replays of
``generate``'s CUDA graph of the step (``decode_x8_graphs``), then 8
steady-state steps of the paged ``ContinuousBatchingServer`` (default
config, 8 resident requests, the async loop) over an fp pool and again
over an int8 pool (``kv_cache_dtype="int8"``), each with its step graph
(``serve_x8``, ``serve_x8_int8``) and eagerly (``..._eager``), in turns:
graphs, eager, eager, graphs; then, with those weights freed, one
``train_batch`` of the
GPT-2 1.3B preset in bf16 (chip_smoke.py's train configuration: micro-batch
8, 2 accumulation steps, T=1024, remat, AdamW), all under
``torch.profiler``, and prints for each phase:
the host wall time, the summed device time of all kernels, the device's
busy share of the wall (kernel time / wall), the device time by kind of
kernel, and the kernels that take the most device time. Given a
directory, it also writes each phase's Chrome trace there.

    python3 scripts/profile_torch_generate.py [TRACE_DIR]
"""
from __future__ import annotations

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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import gpt2_xl_config  # noqa: E402


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def category(kernel: str) -> str:
    if any(s in kernel for s in ("bwd_dq", "bwd_dkv")):
        return "port kernels (flash backward)"
    if any(s in kernel for s in ("flash_fwd", "decode_kernel", "paged_",
                                 "decode_dense")):
        return "port kernels (attention)"
    if "multi_tensor" in kernel or "foreach" in kernel:
        return "optimizer and gradient passes (foreach)"
    if any(s in kernel for s in ("nvjet", "gemm", "cutlass", "sm90_")):
        return "GEMM (cuBLAS)"
    if "copy" in kernel:
        return "copies and dtype casts"
    if "reduce" in kernel:
        return "reductions (norm statistics, argmax)"
    return "other elementwise (add, mul, gelu, index)"


def report(name, prof, wall_s, trace_dir):
    """Sums over kernel events only (the CPU-side op rows of the profile
    carry the same device time again)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    print(f"[{name}] host wall {wall_s * 1e3!r} ms, device kernel time "
          f"{total / 1e3!r} ms, device busy share {total / 1e6 / wall_s!r}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    cats = {}
    for e in kernels:
        cats[category(e.key)] = cats.get(category(e.key), 0.0) + device_us(e)
    for c, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   {us / 1e3:10.3f} ms  {c}")
    for e in sorted(kernels, key=device_us, reverse=True)[:12]:
        print(f"[{name}]   {device_us(e) / 1e3:10.3f} ms  {e.count:6d} x  "
              f"{e.key[:90]}")
    # B4, the dense decode kernel (either checkout's name for it)
    b4 = [e for e in kernels if any(k in e.key for k in (
        "decode_dense_kernel", "decode_kernel<"))]
    if b4:
        n = sum(e.count for e in b4)
        print(f"[{name}] B4 (dense decode) device time per launch "
              f"{sum(device_us(e) for e in b4) / n!r} us over {n} launches")
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"trace_{name}.json"))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        decode_step, init_params, prefill)
    args = sys.argv[1:]
    other = None
    if "--other" in args:
        i = args.index("--other")
        other = args[i + 1]
        del args[i:i + 2]
    decode_only = "--decode-only" in args
    args = [a for a in args if a != "--decode-only"]
    trace_dir = args[0] if args else None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = gpt2_xl_config()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                dtype="bfloat16")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 901, 8)
    ids = np.zeros((8, 1024), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(0, cfg.vocab_size, n)
    ids_t = torch.as_tensor(ids, device="cuda")
    lens_t = torch.as_tensor(lens, device="cuda")
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        engine.generate([ids[b, :n].tolist() for b, n in enumerate(lens)],
                        max_new_tokens=4)   # warm-up
        cache = engine._make_cache(8, 1024)
        torch.cuda.synchronize()
        with profile(activities=act) as prof:
            t0 = time.perf_counter()
            lg, cache = prefill(engine.params, engine.model_config, ids_t,
                                lens_t, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("prefill", prof, wall, trace_dir)
        tok = lg.argmax(-1)
        import deepspeed_tpu_torch.model_implementations.transformer as tt
        graphed = engine._decode_fn(cache)   # the graph generate kept
        for _ in range(2):   # its warm-up and capture, if it has none yet
            graphed(tok)
        torch.cuda.synchronize()
        with profile(activities=act) as prof:
            t0 = time.perf_counter()
            step_tok = tok
            for _ in range(8):
                step_tok = graphed(step_tok).argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode_x8_graphs", prof, wall, trace_dir)
        turns = [("decode_x8", tt.decode_attention)]
        if other:
            from other_checkout import load_wrapper
            from stamp_decode_sparse import _decode_builders
            mod = load_wrapper(other, "decode_attention",
                               _decode_builders(other))
            turns += [("decode_x8_other", mod.decode_attention),
                      ("decode_x8", tt.decode_attention)]
        for name, fn in turns:
            tt.decode_attention = fn   # the model's dense decode
            step_cache = cache.clone() if hasattr(cache, "clone") else cache
            step_tok = tok
            for _ in range(2):   # warm-up (the other's first build)
                decode_step(engine.params, engine.model_config, step_tok,
                            step_cache)
            torch.cuda.synchronize()
            with profile(activities=act) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    lg, step_cache = decode_step(engine.params,
                                                 engine.model_config,
                                                 step_tok, step_cache)
                    step_tok = lg.argmax(-1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(name, prof, wall, trace_dir)
        tt.decode_attention = turns[0][1]
    if decode_only:
        return 0
    for kv_dtype in ("fp", "int8"):
        for graphs in (True, False, False, True):
            serve_x8(engine, ids, lens, act, trace_dir, kv_dtype, graphs)
    del engine, params, cache, lg, tok
    torch.cuda.empty_cache()
    train_step(act, trace_dir)
    return 0


def train_step(act, trace_dir):
    """One optimizer step of GPT-2 1.3B after a warm-up step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    model = GPT2LMModel(config_for("gpt2-1.3b"))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model,
        model_parameters=model.init(
            torch.Generator(device="cuda").manual_seed(0)),
        config={"train_micro_batch_size_per_gpu": 8,
                "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "weight_decay": 0.01}}})
    batch = {"input_ids": np.random.default_rng(6).integers(
        0, 50257, (16, 1024), dtype=np.int32)}
    engine.train_batch(batch)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("train_step", prof, wall, trace_dir)


def serve_x8(engine, ids, lens, act, trace_dir, kv_dtype, graphs):
    """8 steady-state server steps over a ``kv_dtype`` pool: every slot
    resident and decoding, no queue, so each step() dispatches one decode
    program (a replay of its graph, or eagerly when ``graphs`` is False)
    and commits the one before it."""
    from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                               DeepSpeedInferenceConfig)
    engine.config = DeepSpeedInferenceConfig(dtype="bfloat16",
                                             kv_cache_dtype=kv_dtype)
    srv = ContinuousBatchingServer(engine)
    srv._cuda_graphs = graphs
    for b, n in enumerate(lens):
        srv.submit(ids[b, :n].tolist(), max_new_tokens=64)
    for _ in range(4):   # admission (prefills), the pipeline's start, and
        srv.step()       # the step graph's warm-up and capture
    torch.cuda.synchronize()
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    name = "serve_x8" + ("" if kv_dtype == "fp" else f"_{kv_dtype}") + (
        "" if graphs else "_eager")
    if graphs:
        g = srv._graphs["decode"]
        print(f"[{name}] graph: capture {g.capture_s!r} s, {g.replays} "
              f"replays, graph pool {g.pool_bytes} bytes")
    report(name, prof, wall, trace_dir)
    srv.close()


if __name__ == "__main__":
    sys.exit(main())
