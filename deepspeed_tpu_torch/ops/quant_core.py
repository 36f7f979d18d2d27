"""Per-axis symmetric int8 quantization — the port's copy of
``deepspeed_tpu/ops/quant_core.py`` (``quantize_int8`` :35,
``dequantize_int8`` :47). The int8 paged KV pool's writers quantize each
written (position, head) row along the head dim, and its gathers and the
paged kernels' plain versions dequantize; SwitchBack int8 training
(``ops/int8_training.py``) quantizes activations per token and weights per
column or per tensor.

* ``scale = amax / 127`` along ``axis`` (or one scale for the whole tensor
  when ``axis=None``); an all-zero slice gets scale 1.0, so its dequant is
  exact zero, never 0/0.
* ``q = clip(round(x / scale), -127, 127)``, rounding half to even as
  ``jnp.round`` does — symmetric, -128 unused.
* The round trip is elementwise within ``scale / 2``: relative to the
  slice amax the error never exceeds ``1/254``.
"""
from __future__ import annotations

import torch

INT8_QMAX = 127.0


def quantize_int8(x: torch.Tensor, axis, reduce_amax=None):
    """Symmetric int8 along ``axis`` (int, tuple, or None = one scale for
    the whole tensor): returns ``(q int8, scale f32)`` with the scale
    broadcastable against ``x`` (kept dims of size 1 along ``axis`` when
    ``axis`` is not None). ``reduce_amax`` makes the amax that of a slice
    split over ranks (each holds part of ``axis``)."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    s = torch.where(amax > 0, amax / INT8_QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), s


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype`` — the inverse of
    :func:`quantize_int8` up to the ``scale / 2`` rounding bound."""
    return (q.float() * scale).to(dtype)
