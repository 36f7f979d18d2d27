"""Collective micro-benchmarks (the ``ds_bench`` /
``benchmarks/communication/*`` analog; counterpart of
``deepspeed_tpu/benchmarks_comm.py``): sweep message sizes over
all_reduce / all_gather / reduce_scatter / all_to_all / ppermute through
the comm facade over a mesh axis's process group, and report the latency
and the algorithmic bus bandwidth per rank. It runs on the card
(``cuda:LOCAL_RANK``, NCCL, timed with CUDA events) unless the caller
asks for the CPU (``--device cpu``, gloo, timed with the host clock).

Run: ``torchrun --nproc-per-node N -m deepspeed_tpu_torch.benchmarks_comm
--sizes-mb 1,4,16``; without torchrun one process sweeps at world size 1.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "ppermute")


def _op(name: str, axis: str, n: int):
    from deepspeed_tpu_torch.comm import comm as C
    if name == "all_reduce":
        return lambda x: C.all_reduce(x, axis_name=axis)
    if name == "all_gather":
        return lambda x: C.all_gather(x, axis_name=axis)
    if name == "reduce_scatter":
        return lambda x: C.reduce_scatter(x, axis_name=axis)
    if name == "all_to_all":
        return lambda x: C.all_to_all(x.reshape(n, -1), axis_name=axis,
                                      split_axis=0,
                                      concat_axis=0).reshape(-1)
    if name == "ppermute":
        perm = [(i, (i + 1) % n) for i in range(n)]
        return lambda x: C.ppermute(x, perm, axis_name=axis)
    raise ValueError(name)


def _bus_bytes(name: str, per_device_bytes: int, n: int) -> float:
    """Algorithmic bus bytes per rank from the per-rank message size
    (ring conventions, the reference's bandwidth formulas)."""
    if name == "all_reduce":
        return 2 * per_device_bytes * (n - 1) / n
    if name in ("all_gather", "reduce_scatter", "all_to_all"):
        return per_device_bytes * (n - 1) / n
    return per_device_bytes  # ppermute: one hop


def _sweep_device(device) -> torch.device:
    """The caller's device, else the CPU under a gloo group, else the
    rank's card; never the CPU when a card is expected."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm.comm import get_local_rank
    if device is not None:
        return torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "benchmarks_comm: no CUDA device; pass device='cpu' "
            "(--device cpu) to sweep gloo on the host")
    return torch.device("cuda", get_local_rank())


def run_sweep(sizes_mb=(1, 4, 16), trials: int = 5,
              collectives=COLLECTIVES, axis: str = "data",
              device=None) -> List[Dict]:
    """One record per (collective, size): ``latency_ms`` a call (mean
    over ``trials`` after one warm-up) and ``busbw_GiBps``. ``size_mb``
    is the global message; each rank holds its ``1/n``, as a JAX array
    sharded over the axis. Every rank calls it. ``device`` defaults to
    the rank's card (the CPU only under a gloo group)."""
    from deepspeed_tpu_torch.comm.mesh import axis_size, get_global_mesh
    mesh = get_global_mesh()
    n = axis_size(axis) if mesh is not None else 1
    device = _sweep_device(device)
    cuda = device.type == "cuda"
    results = []
    for name in collectives:
        fn = _op(name, axis, n)
        for mb in sizes_mb:
            elems = int(mb * (1 << 20)) // 4
            # per-rank shards must themselves split n ways for
            # reduce_scatter/all_to_all: a global size a multiple of n^2
            per_dev = max(n * n, elems // (n * n) * (n * n))
            x = torch.ones(per_dev // n, dtype=torch.float32, device=device)
            fn(x)   # warm-up (NCCL's communicator, allocations)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize(device)
                start.record()
                for _ in range(trials):
                    fn(x)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / trials
            else:
                t0 = time.perf_counter()
                for _ in range(trials):
                    fn(x)
                dt = (time.perf_counter() - t0) / trials
            nbytes = per_dev // n * 4   # per-rank payload
            busbw = _bus_bytes(name, nbytes, n) / max(dt, 1e-9)
            results.append({
                "collective": name, "size_mb": mb, "devices": n,
                "latency_ms": round(dt * 1e3, 3),
                "busbw_GiBps": round(busbw / (1 << 30), 3)})
    return results


def main() -> None:
    import argparse
    import json

    from deepspeed_tpu_torch.comm import comm
    ap = argparse.ArgumentParser(description="collective bandwidth sweep")
    ap.add_argument("--sizes-mb", default="1,4,16")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--collectives", default=",".join(COLLECTIVES))
    ap.add_argument("--device", default=None, help="cpu for gloo")
    args = ap.parse_args()
    comm.init_distributed(device=args.device)
    out = run_sweep(tuple(float(s) for s in args.sizes_mb.split(",")),
                    args.trials, tuple(args.collectives.split(",")),
                    device=args.device)
    if comm.get_rank() == 0:
        for r in out:
            print(json.dumps(r))
    comm.destroy_process_group()


if __name__ == "__main__":
    main()
