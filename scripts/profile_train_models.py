#!/usr/bin/env python3
"""Where the time of a LLaMA and a BERT training step goes, on one NVIDIA
GPU.

Builds, in turn, the three training runs of ``chip_smoke.py``'s phase
llama_bert from its tables ``LLAMA_RUNS`` and ``BERT_RUN`` (random
weights from a seed; ``chip_smoke.train_engine``: bf16, AdamW):
``llama-1b`` at full width and depth (micro 4 x gas 2 x T 2048, remat),
``llama-7b-gqa`` at full width and 8 of its 32 layers (micro 2 x gas 1 x
T 4096, remat) and ``bert-large`` at full width and depth (micro 16 x gas
2 x T 512, no remat), unmasked and then with ``bert_padding_mask`` (the
layer's einsum route). Each takes one warm-up ``train_batch``, then
one under ``torch.profiler``, and prints the host wall, the device's
kernel time and busy share, the time by kind of kernel and the kernels
that take the most (``profile_torch_generate.report``). Given a
directory, it also writes each step's Chrome trace there.

    python3 scripts/profile_train_models.py [TRACE_DIR]
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (BERT_RUN, LLAMA_RUNS, bert_batch,  # noqa: E402
                        bert_padding_mask, train_engine)
from profile_torch_generate import report  # noqa: E402


def _profile(name, engine, batch, act, trace_dir):
    engine.train_batch(batch)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=act) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(name, prof, wall, trace_dir)
    print(f"[{name}] peak memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.models import bert, llama
    torch.backends.cuda.matmul.allow_tf32 = False
    trace_dir = sys.argv[1] if len(sys.argv) > 1 else None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rng = np.random.default_rng(0)
    for name, over, micro, gas, T, _ in LLAMA_RUNS:
        cfg = llama.config_for(name, **over)
        model = llama.LlamaLMModel(cfg)
        engine = train_engine(model, model.init(
            torch.Generator(device="cuda").manual_seed(0)), micro, gas)
        batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                           (micro * gas, T), dtype=np.int32)}
        _profile(f"train_{name}", engine, batch, act, trace_dir)
        del engine
        torch.cuda.empty_cache()
    name, over, micro, gas, T, _ = BERT_RUN
    cfg = bert.config_for(name, **over)
    model = bert.BertPreTrainingModel(cfg)
    engine = train_engine(model, model.init(
        torch.Generator(device="cuda").manual_seed(0)), micro, gas)
    batch = bert_batch(cfg, rng, micro * gas, T)
    _profile(f"train_{name}", engine, batch, act, trace_dir)
    _profile(f"train_{name}_masked", engine, dict(
        batch, attention_mask=bert_padding_mask(micro * gas, T)), act,
        trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
