#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors: two ranks on the one card.

NCCL refuses two ranks on one device, so a run of several ranks on a
one-card box has only gloo. This starts two processes (a gloo group
through a ``FileStore`` under the checkout's ``build/``), both on
``cuda:0``, and tries each call the training engine's collective path
makes (``comm/comm.py``), printing one JSON object: each rank's exit code
and each call's ``ok``, the error it raised, or ``started`` for the call
during which the process died. Run from the root of a checkout:

    python3 scripts/probe_gloo_cuda.py
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import sys
import tempfile
import traceback


def _calls(dist, torch, rank, ws):
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    sub = [None]

    def new_group():
        sub[0] = dist.new_group([0, 1])
    return {
        "all_reduce SUM": lambda: dist.all_reduce(x.clone()),
        "all_reduce MIN": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MIN),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * ws, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // ws, device="cuda"), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device="cuda"), x),
        "batch_isend_irecv": lambda: [r.wait() for r in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, 1 - rank),
             dist.P2POp(dist.irecv, torch.empty_like(x), 1 - rank)])],
        "new_group": new_group,
        "all_gather_into_tensor (subgroup)": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * ws, device="cuda"), x, group=sub[0]),
    }


def _rank(rank, ws, store_path, out):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, ws),
                            rank=rank, world_size=ws,
                            timeout=datetime.timedelta(seconds=30))
    res = {}
    path = os.path.join(out, f"rank{rank}.json")
    for name, fn in _calls(dist, torch, rank, ws).items():
        # written before each call: a call that kills the process (gloo
        # aborts on some errors) stays recorded as "started"
        res[name] = "started"
        with open(path, "w") as f:
            json.dump(res, f)
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe reports each
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    dist.barrier()
    dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="gloo_probe_", dir=root)
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, 2, os.path.join(
            tmp, "store"), tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out = {}
        for r in range(2):
            path = os.path.join(tmp, f"rank{r}.json")
            got = json.load(open(path)) if os.path.exists(path) else {}
            out[f"rank{r}"] = {"exit": procs[r].exitcode, "calls": got}
        print(json.dumps({"torch": torch.__version__,
                          "card": torch.cuda.get_device_name(0), **out}))
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
