#!/usr/bin/env python3
"""What the observability plane's defaults cost on the clock, on one
NVIDIA GPU.

Serving: GPT-2 XL at its published widths (random weights from a seed)
behind the paged server, on the 16 requests of ``chip_smoke.py``'s phase
serve (a) (prompts of 64-700 tokens in two batches of 8, 4 steps between
them, 32 new tokens each), with the default plane (the step profiler, the
KV-pool accountant, the request ledger and the capacity model) and with
``step_profile`` and accounting off, in turns on/off/off/on/... Each run
prints its tokens/s, its median step wall and the decode graphs it
captured; every run must serve the first run's tokens.

Training: gpt2-1.3b at phase train's shape (bf16, AdamW, micro-batch 8,
2 accumulation steps, 1024 positions, random weights from a seed) with
the monitor events every step (``steps_per_print`` 1: each step then
reads its loss, learning rate and gradient norm on the host) and never,
in turns: each turn's mean step wall over back-to-back ``train_batch``
calls with one sync after the last (a bf16 step reads nothing on the host
otherwise, so a sync inside a step shows as lost overlap).

    python3 scripts/observe_cost.py [--turns 8] [--train-steps 8]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import OFF_TELEMETRY, gpt2_xl_config, train_engine  # noqa

NEW_TOKENS = 32


def serve_once(engine, knobs, batches):
    """One server over ``engine``: batch 0, 4 steps, batch 1, drain.
    Returns (tokens, tokens/s, median step s, decode graphs, profiler
    built)."""
    from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                               DeepSpeedInferenceConfig)
    from deepspeed_tpu_torch.telemetry import MetricRegistry
    engine.config = DeepSpeedInferenceConfig(dtype="bfloat16", **knobs)
    srv = ContinuousBatchingServer(engine, registry=MetricRegistry())
    torch.cuda.synchronize()
    walls, ids = [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        ids += [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in batch]
        for _ in range(4 if i == 0 else 0):
            ts = time.perf_counter()
            srv.step()
            walls.append(time.perf_counter() - ts)
    while not srv.scheduler.idle:
        ts = time.perf_counter()
        srv.step()
        walls.append(time.perf_counter() - ts)
    out = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [out[r] for r in ids]
    n = NEW_TOKENS * len(ids)
    res = (tokens, n / wall, float(np.median(walls)),
           srv.stats["decode_traces"], srv._profiler is not None)
    srv.close()
    return res


def serve_cost(turns):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import \
        init_params
    cfg = gpt2_xl_config()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                dtype="bfloat16")
    engine.generate([[1, 2, 3]], max_new_tokens=2)   # warm-up
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 701, 16)]
    batches = [prompts[:8], prompts[8:]]
    serve_once(engine, {}, batches)   # builds the kernels, warms cuBLAS
    first, rows = None, {"on": [], "off": []}
    for turn in range(turns):
        tag = "on" if turn % 4 in (0, 3) else "off"
        tokens, tps, step_s, graphs, built = serve_once(
            engine, {} if tag == "on" else {"telemetry": OFF_TELEMETRY},
            batches)
        first = tokens if first is None else first
        assert tokens == first, f"turn {turn}: other tokens"
        assert built == (tag == "on"), f"turn {turn}: profiler {built}"
        rows[tag].append((tps, step_s * 1e3))
        print(f"[serve] turn {turn}, plane {tag}: {tps!r} tokens/s, median "
              f"step {step_s * 1e3!r} ms, decode graphs {graphs}",
              flush=True)
    on, off = (np.mean(rows[k], 0) for k in ("on", "off"))
    print(f"[serve] means on/off: tokens/s {on[0] / off[0]!r}, median step "
          f"{on[1] / off[1]!r}", flush=True)
    del engine, params
    torch.cuda.empty_cache()


def train_cost(turns, steps):
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    cfg = config_for("gpt2-1.3b")
    model = GPT2LMModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    micro, gas = 8, 2
    engine = train_engine(model, params, micro, gas)
    del params
    rng = np.random.default_rng(6)
    batch = {"input_ids": rng.integers(
        0, cfg.vocab_size, (micro * gas, cfg.n_positions), dtype=np.int32)}
    engine.train_batch(batch)   # warm-up
    torch.cuda.synchronize()
    rows = {1: [], 10**9: []}
    for turn in range(turns):
        every = 1 if turn % 4 in (0, 3) else 10**9
        engine.config.steps_per_print = every
        t = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        rows[every].append((time.perf_counter() - t) / steps)
        print(f"[train] turn {turn}, monitor events "
              f"{'every step' if every == 1 else 'never'}: mean step "
              f"{rows[every][-1] * 1e3!r} ms over {steps} steps", flush=True)
    print(f"[train] mean step every/never "
          f"{np.mean(rows[1]) / np.mean(rows[10**9])!r}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    serve_cost(args.turns)
    train_cost(args.turns, args.train_steps)
    print(f"[wall] {time.perf_counter() - t0!r} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
