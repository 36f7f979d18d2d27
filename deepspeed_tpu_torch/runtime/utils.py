"""Gradient norms and clipping (counterpart of
``deepspeed_tpu/runtime/utils.py``), on flat dicts or lists of tensors."""
from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from deepspeed_tpu_torch.runtime.precision import grads_finite  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_coef", "global_norm", "grads_finite"]


def global_norm(grads: Iterable[torch.Tensor],
                norm_type: float = 2.0) -> torch.Tensor:
    """Norm over every element of every tensor, as an f32 device scalar."""
    grads = [g.float() for g in grads]
    if norm_type == float("inf"):
        return torch.stack([g.abs().max() for g in grads]).max()
    if norm_type == 2.0:
        norms = torch._foreach_norm(grads, 2.0)
        return torch.stack(norms).square().sum().sqrt()
    acc = sum((g.abs() ** norm_type).sum() for g in grads)
    return acc ** (1.0 / norm_type)


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
