#!/usr/bin/env python3
"""Host cost of one CUDA-graph replay of deepspeed_tpu_torch's decode
steps, on one NVIDIA GPU.

Builds GPT-2 XL at its published widths (random weights from a seed) and
four graphs of one decode step at batch 8: ``generate``'s own (the dense
cache of 8 x 1024 positions it keeps, logits out), the same step with its
greedy tokens out, and a paged decode step over an S=8 pool (blocks of
128, lengths 300-900), logits out and tokens out. For each, starting from
an idle device, it times on the host clock each part of a call: staging the
input (a device-to-device copy), the replay (``cudaGraphLaunch``), the
copy of the static output, and the wait until the device is done; medians
of 20 calls, in µs. A replay that returns while the device still works
shows a small replay time and a long wait; a part that blocks shows the
device's time itself.

    python3 scripts/graph_host_cost.py
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import _paged_tables, gpt2_xl_config  # noqa: E402


def parts(name, graph, stage, calls=20):
    rows = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage()
        t1 = time.perf_counter()
        graph._replay()
        t2 = time.perf_counter()
        graph.output.clone()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    stage_us, replay_us, clone_us, wait_us = np.median(rows, 0) * 1e6
    print(f"[{name}] output {tuple(graph.output.shape)} "
          f"{graph.output.dtype}: stage {stage_us!r} us, replay "
          f"{replay_us!r} us, clone {clone_us!r} us, wait {wait_us!r} us "
          f"(medians of {calls})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
    from deepspeed_tpu_torch.inference.kv_cache import init_paged_cache
    from deepspeed_tpu_torch.model_implementations.transformer import (
        decode_step, init_params, paged_decode_step)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = gpt2_xl_config()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                dtype="bfloat16")
    p, c = engine.params, engine.model_config
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 901, 8)]
    with torch.inference_mode():
        engine.generate(prompts, max_new_tokens=3)   # warm-up and capture
        _, cache, gen = engine._kept
        tok = torch.zeros(8, dtype=torch.long, device="cuda")
        parts("generate, logits", gen, lambda: gen.inputs[0].copy_(tok))
        greedy = GraphedStep(
            "dense_tokens",
            lambda t: decode_step(p, c, t, cache)[0].argmax(-1),
            (tok.clone(),), lambda: (cache.k, cache.v, cache.lengths))
        greedy(), greedy()
        parts("dense step, tokens", greedy,
              lambda: greedy.inputs[0].copy_(tok))
        pool = init_paged_cache(cfg.n_layer, 8, 65, 128, 8, cfg.kv_heads,
                                cfg.head_dim, device="cuda")
        lens = rng.integers(300, 900, 8)
        pool.block_tables.copy_(torch.as_tensor(
            _paged_tables(rng, -(-(lens + 1) // 128), 65, 8),
            device="cuda"))
        pool.lengths.copy_(torch.as_tensor(lens, device="cuda"))
        active = torch.ones(8, dtype=torch.bool, device="cuda")
        for what, head in (("logits", lambda lg: lg),
                           ("tokens", lambda lg: lg.argmax(-1))):
            g = GraphedStep(
                f"paged_{what}",
                lambda t, head=head: head(paged_decode_step(
                    p, c, t, pool, active)[0]),
                (tok.clone(),), lambda: (pool.k, pool.v, pool.lengths))
            g(), g()
            parts(f"paged step, {what}", g, lambda: g.inputs[0].copy_(tok))
            pool.lengths.copy_(torch.as_tensor(lens, device="cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
