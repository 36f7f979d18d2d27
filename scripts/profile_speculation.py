#!/usr/bin/env python3
"""Where the time of a speculative round and of a beam step goes, on one
NVIDIA GPU.

Builds GPT-2 XL at its published widths and a GPT-2 (124M) draft (random
weights from seeds, bf16), prefills phase e2e's 8 prompts of
``chip_smoke.py`` into a dense cache of 8 x 1024 positions, and times on
CUDA events (medians of 10, each call from an idle device): one replayed
decode step of the target, one replayed verify chunk (K=4, the
``generate_verify`` graph), the same chunk eager, one replayed draft
decode step, and the in-place beam reorder of the 8 rows' live cache (the
``index_select`` and ``copy_`` of ``generate``'s beam loop, at the
longest prompt's length). Then it runs ``torch.profiler`` over one
eager verify chunk and over one whole ``generate_speculative`` call (the
124M draft, and prompt lookup), and prints the kernels by device time.

    python3 scripts/profile_speculation.py
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

from chip_smoke import gpt2_small_config, gpt2_xl_config  # noqa: E402


def event_ms(fn, calls=10):
    """Median device ms and host ms of ``fn`` over ``calls`` calls after
    two warm-up calls, each from an idle device."""
    dev, host = [], []
    for i in range(calls + 2):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.record()
        fn()
        e.record()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        if i >= 2:
            dev.append(s.elapsed_time(e))
            host.append(t * 1e3)
    return float(np.median(dev)), float(np.median(host))


def table(prof, rows=15):
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=rows), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        decode_chunk, init_params, prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg, dcfg = gpt2_xl_config(), gpt2_small_config()

    def engine(c, seed):
        p = init_params(torch.Generator(device="cuda").manual_seed(seed), c)
        return deepspeed_tpu_torch.init_inference(
            (c, p), dtype="bfloat16", max_out_tokens=cfg.n_positions)

    target, draft = engine(cfg, 0), engine(dcfg, 1)
    rng = np.random.default_rng(0)   # chip_smoke.py phase e2e's prompts
    lens = rng.integers(cfg.n_positions // 16,
                        cfg.n_positions * 7 // 8 + 5, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    ids = np.zeros((8, cfg.n_positions), np.int64)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    ids_t = torch.as_tensor(ids, device="cuda")
    lens_t = torch.as_tensor(lens, device="cuda")
    res = {}
    with torch.inference_mode():
        cache = target._make_cache(8, cfg.n_positions)
        prefill(target.params, cfg, ids_t, lens_t, cache)
        live = cache.lengths.clone()
        toks = torch.randint(0, cfg.vocab_size, (8, 4), device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(2))
        step, verify = target._decode_fn(cache), target._chunk_fn(cache, 4)

        def decode():
            step(toks[:, 0])
            cache.lengths.copy_(live)
        res["target decode step, replayed"] = event_ms(decode)
        res["verify chunk K=4, replayed"] = event_ms(lambda: verify(toks))
        res["verify chunk K=4, eager"] = event_ms(
            lambda: decode_chunk(target.params, cfg, toks, cache))
        dcache = draft._make_cache(8, cfg.n_positions, role="draft")
        prefill(draft.params, dcfg, ids_t, lens_t, dcache)
        dlive = dcache.lengths.clone()
        dstep = draft._decode_fn(dcache)

        def draft_decode():
            dstep(toks[:, 0])
            dcache.lengths.copy_(dlive)
        res["124M draft decode step, replayed"] = event_ms(draft_decode)
        rows = torch.tensor([1, 0, 3, 2, 5, 4, 7, 6], device="cuda")
        hi = int(lens.max()) + 1

        def reorder():
            for x in (cache.k, cache.v):
                x[:, :, :hi].copy_(x[:, :, :hi].index_select(1, rows))
        res[f"beam reorder of 8 rows x {hi} positions"] = event_ms(reorder)
        for name, (d, h) in res.items():
            print(f"[spec profile] {smi}: {name}: device {d!r} ms, host "
                  f"{h!r} ms (medians of 10)", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_chunk(target.params, cfg, toks, cache)
            torch.cuda.synchronize()
        print("[spec profile] one eager verify chunk, by kernel:")
        table(prof)
    for name, d in (("124M draft", draft), ("prompt lookup", None)):
        target.generate_speculative(prompts, d, max_new_tokens=32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        target.generate_speculative(prompts, d, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            target.generate_speculative(prompts, d, max_new_tokens=32)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"[spec profile] {smi}: generate_speculative {name}, B=8, 32 "
              f"new tokens, K=4: {wall!r} s unprofiled, "
              f"{target.last_speculative_stats}; kernel time profiled "
              f"{busy / 1e3!r} ms", flush=True)
        table(prof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
