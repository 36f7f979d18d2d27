"""Gradient norms and clipping (counterpart of
``deepspeed_tpu/runtime/utils.py``), on flat dicts or lists of tensors."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.runtime.precision import grads_finite  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_coef", "global_norm", "grads_finite"]


def global_norm(grads: Iterable[torch.Tensor], norm_type: float = 2.0,
                sharded: Optional[Sequence] = None,
                axis_name=None) -> torch.Tensor:
    """Norm over every element of every tensor, as an f32 device scalar.
    With ``axis_name`` (an axis or a tuple of axes) the tensors are this
    rank's part of a tree spread over those mesh axes: a tensor flagged in
    ``sharded`` is a block whose squares add up over the ranks, any other
    is the same on every rank and counts once (rank 0's). A flag may name
    the axes a tensor's blocks are spread over (a tuple): it counts once
    along the others."""
    grads = [g.float() for g in grads]
    if norm_type == float("inf"):
        m = torch.stack([g.abs().max() for g in grads]).max()
        return m if axis_name is None else \
            comm.all_reduce(m, comm.MAX, axis_name)
    if norm_type == 2.0:
        parts = torch.stack(torch._foreach_norm(grads, 2.0)).square()
    else:
        parts = torch.stack([(g.abs() ** norm_type).sum() for g in grads])
    if axis_name is not None:
        axes = (axis_name,) if isinstance(axis_name, str) else \
            tuple(axis_name)
        first = {a: comm.axis_index(a) == 0 for a in axes}

        def counted(s):
            split = axes if s is True else tuple(s or ())
            return all(first[a] for a in axes if a not in split)
        keep = torch.tensor([counted(s) for s in sharded],
                            dtype=parts.dtype, device=parts.device)
        parts = comm.all_reduce(parts * keep, comm.SUM, axes)
    if norm_type == 2.0:
        return parts.sum().sqrt()
    return parts.sum() ** (1.0 / norm_type)


def clip_coef(clip: float, gnorm: torch.Tensor) -> torch.Tensor:
    """Global-norm clip coefficient ``min(1, clip / (gnorm + 1e-6))``. A
    NaN norm leaves the grads unscaled (coefficient 1), so a NaN in one
    gradient does not spread into all of them; an inf norm gives 0."""
    coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
    return torch.where(torch.isnan(gnorm), torch.ones_like(coef), coef)


def clip_grad_norm_(grads: List[torch.Tensor], max_norm: float,
                    norm_type: float = 2.0
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns ``(grads, pre_clip_norm)``."""
    norm = global_norm(grads, norm_type)
    torch._foreach_mul_(grads, clip_coef(max_norm, norm))
    return grads, norm
