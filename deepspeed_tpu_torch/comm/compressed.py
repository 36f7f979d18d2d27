"""Error-compensated 1-bit compressed all-reduce.

Counterpart of ``deepspeed_tpu/comm/compressed.py`` (reference
``runtime/comm/nccl.py:51`` ``compressed_allreduce``: sign compression
with a per-tensor scale, worker AND server error feedback). The JAX
version runs inside ``shard_map`` over a mesh axis; here the mean runs
over the axis's process group (``comm.all_reduce(AVG)``). Per tensor and
step::

    corrected  = x + worker_error
    scale_w    = mean(|corrected|)
    worker_err = corrected - scale_w * sign(corrected)
    gathered   = mean over ranks of scale_w * sign(corrected)
    served     = gathered + server_error
    scale_s    = mean(|served|)
    server_err = served - scale_s * sign(served)
    result     = scale_s * sign(served)          (the same on every rank)

The 1-bit optimizers that drive it are ROADMAP.md A9.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from deepspeed_tpu_torch.comm import comm


def _sign(x):
    # sign(0) := +1: a 1-bit code has no zero
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def compress(x: torch.Tensor, error: torch.Tensor):
    """One-sided compression step → ``(compressed, new_error)``."""
    corrected = x.to(torch.float32) + error
    scale = corrected.abs().mean()
    comp = scale * _sign(corrected)
    return comp, corrected - comp


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, axis_name="data"
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """1-bit all-reduce (mean) with double error feedback over
    ``axis_name``; returns ``(result, new_worker_error,
    new_server_error)``."""
    comp, new_worker_error = compress(x, worker_error)
    gathered = comm.all_reduce(comp, comm.AVG, axis_name=axis_name)
    served, new_server_error = compress(gathered, server_error)
    return served, new_worker_error, new_server_error


def init_error_feedback(x: Dict[str, torch.Tensor]):
    """Zero worker and server error buffers shaped like ``x`` (a dict)."""
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in x.items()}
    return zeros, {k: v.clone() for k, v in zeros.items()}


def compressed_allreduce_tree(grads: Dict[str, torch.Tensor],
                              worker_error, server_error, axis_name="data"):
    """:func:`compressed_allreduce` over each leaf of a dict, in its
    order."""
    out, new_w, new_s = {}, {}, {}
    for k, g in grads.items():
        out[k], new_w[k], new_s[k] = compressed_allreduce(
            g, worker_error[k], server_error[k], axis_name)
    return out, new_w, new_s
