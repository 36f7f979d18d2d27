"""Train llama-7b-gqa at its published 32 layers on one H100, the Adam
moments on NVMe.

llama-7b-gqa has 7,241,732,096 parameters. Its training state at 12
bytes a parameter on the host (the f32 master and two f32 moments) is
86.9 GB, more than the host memory of a one-card machine with 96 GiB
leaves beside the process; with ``offload_optimizer: {device: nvme}`` the
57.9 GB of moments live in swap files under the checkout's ``build/`` and
stream through the aio pool around each leaf's host Adam, and the host
keeps the f32 master (29.0 GB) and two moment arenas of the largest leaf.

The run: bf16, AdamW (lr 1e-4, weight decay 0.01, clipping 1.0), micro 2
x gas 1 x T 4096 on seeded random tokens and weights, remat, goodput on;
3 steps, the first of which warms up. Before it starts the script checks
the free disk against the swap bytes plus 5% and exits non-zero, naming
the shortfall, if they do not fit; it never cuts the model itself
(``--layers`` does). The zero moments start as files of holes (the first
step writes every moment once); the swap files are removed at the end.

It prints each step's wall time, loss, grad norm and goodput split
(data wait, device, host), the optimizer step's split (waits for the swap
files, host Adam, waits for gradients), the swap bytes and GB/s, the
device peak, the host RSS peak (sampled from ``/proc/self/statm`` every
20 ms), the bytes on disk, and whether the swap files could sit in the
page cache beside the process (``MemTotal`` of ``/proc/meminfo`` against
the swap bytes plus the RSS peak); it drops no cache and changes no
setting of the machine. The last line is a JSON summary.

    python3 scripts/train_nvme_llama.py [--steps 3] [--layers 32]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRESET = "llama-7b-gqa"
PARAMS_32 = 7241732096
MICRO, GAS, T = 2, 1, 4096
DISK_MARGIN = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


class HostRss:
    """The process's resident set, sampled every 20 ms while active."""

    def __init__(self):
        self.peak, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def now() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.now())
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())


def mem_total() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def dir_bytes(path: str):
    """``(apparent, allocated)`` bytes of the files under ``path`` (the
    zero moments are holes until the first write-back)."""
    st = [os.stat(os.path.join(d, f)) for d, _, fs in os.walk(path)
          for f in fs]
    return (sum(x.st_size for x in st), sum(x.st_blocks * 512 for x in st))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=32,
                    help="depth (32 is the published one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA card: this script trains on the card")
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as llama_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi()}")
    cfg = llama_mod.config_for(PRESET, n_layer=args.layers)
    model = llama_mod.LlamaLMModel(cfg)
    n = sum(math.prod(p.shape) for p in model.module.parameters())
    if args.layers == 32 and n != PARAMS_32:
        log(f"{PRESET}: {n} parameters, expected {PARAMS_32}")
        return 1
    swap_bytes = 8 * n
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    need = int(swap_bytes * (1 + DISK_MARGIN))
    log(f"{PRESET} x{cfg.n_layer}: {n} parameters; the moments' swap files "
        f"need {swap_bytes} bytes (+{DISK_MARGIN:.0%}: {need}); {free} bytes "
        f"free under {root}")
    if free < need:
        log(f"NOT ENOUGH DISK: the swap files need {need} bytes, {free} are "
            f"free under {root}: short by {need - free} bytes; the model is "
            f"not cut")
        return 3
    swap = tempfile.mkdtemp(prefix="nvme_llama_", dir=root)
    rng = np.random.default_rng(24)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (MICRO * GAS, T),
                                       dtype=np.int32)}
    summary = {}
    try:
        with HostRss() as rss:
            t0 = time.perf_counter()
            params = model.init(torch.Generator(device="cuda").manual_seed(
                24))
            engine = deepspeed_tpu_torch.initialize(
                model=model, model_parameters=params, config={
                    "train_micro_batch_size_per_gpu": MICRO,
                    "gradient_accumulation_steps": GAS,
                    "gradient_clipping": 1.0, "bf16": {"enabled": True},
                    "zero_optimization": {"stage": 1, "offload_optimizer": {
                        "device": "nvme", "nvme_path": swap,
                        "implementation": "host"}},
                    "optimizer": {"type": "AdamW", "params": {
                        "lr": 1e-4, "weight_decay": 0.01}},
                    "telemetry": {"goodput": True}})[0]
            del params
            torch.cuda.empty_cache()
            init_s = time.perf_counter() - t0
            on_disk = dir_bytes(swap)
            log(f"engine in {init_s!r} s, of which the zero moments' files "
                f"{engine.host_opt.init_s!r} s ({on_disk[0]} bytes, "
                f"{on_disk[1]} allocated); host RSS {HostRss.now()} bytes")
            torch.cuda.reset_peak_memory_stats()
            steps = []
            prev = engine.goodput.snapshot()
            for i in range(args.steps):
                t = time.perf_counter()
                m = engine.train_batch(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                g = engine.goodput.snapshot()
                split = {k: g[k] - prev[k] for k in
                         ("wall_s", "data_wait_s", "device_s", "host_s")}
                prev = g
                times = dict(engine.offload_step_times)
                moved = times["swap_read_bytes"] + times["swap_write_bytes"]
                row = {"step": i + 1, "wall_s": wall,
                       "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "goodput": split, "optimizer": times,
                       "swap_gbps": moved / times["total_s"] / 1e9,
                       "tokens_per_s": MICRO * GAS * T / wall}
                steps.append(row)
                log(f"step {i + 1}{' (warm-up)' if i == 0 else ''}: wall "
                    f"{wall!r} s, loss {row['loss']!r}, grad norm "
                    f"{row['grad_norm']!r}; goodput {split!r}; optimizer "
                    f"{times!r}; {moved} bytes swapped at "
                    f"{row['swap_gbps']!r} GB/s over the optimizer step")
            peak = torch.cuda.max_memory_allocated()
            on_disk = dir_bytes(swap)
            engine.destroy()
        finite = all(math.isfinite(r["loss"]) and math.isfinite(
            r["grad_norm"]) for r in steps)
        total = mem_total()
        fits = swap_bytes + rss.peak <= total
        log(f"device peak {peak} bytes; host RSS peak {rss.peak} bytes; "
            f"{on_disk[1]} bytes on disk ({on_disk[0]} apparent); MemTotal "
            f"{total} bytes: the swap "
            f"files {'could' if fits else 'could not'} sit in the page "
            f"cache beside the process (no cache was dropped: reads may be "
            f"warm); losses finite {finite}")
        summary = {"model": PRESET, "layers": cfg.n_layer, "params": n,
                   "micro": MICRO, "gas": GAS, "T": T, "init_s": init_s,
                   "zero_moments_s": engine.host_opt.init_s,
                   "steps": steps, "device_peak": peak,
                   "host_rss_peak": rss.peak,
                   "swap_bytes_on_disk": on_disk[1],
                   "mem_total": total, "page_cache_fits": fits,
                   "finite": finite, "card": smi()}
    finally:
        shutil.rmtree(swap, ignore_errors=True)
    print(json.dumps(summary))
    return 0 if summary.get("finite") else 1


if __name__ == "__main__":
    sys.exit(main())
