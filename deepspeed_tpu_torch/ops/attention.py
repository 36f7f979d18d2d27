"""Causal self-attention for training.

Counterpart of ``deepspeed_tpu/ops/attention.py``. The JAX package sends
``T >= 256`` on a TPU to its Pallas flash kernel and everything else to an
einsum reference; the port sends every call through
:class:`~deepspeed_tpu_torch.ops.flash_attention.FlashAttentionFunction`,
whose CUDA kernels take any ``T`` (on a CPU tensor the same Function runs
the kernels' plain versions, so the CPU tests exercise its plumbing).
:func:`causal_attention_reference` is the einsum oracle.
"""
from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops.flash_attention import FlashAttentionFunction


def causal_attention_reference(q, k, v, scale=None, causal: bool = True):
    """Numerics oracle: plain softmax attention with an f32 softmax.
    ``q [B, T, H, D] -> [B, T, H, D]``; k/v may carry fewer heads
    (``[B, T, KH, D]``, ``KH | H``), broadcast per query group."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"q heads {H} not divisible by kv heads {KH}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    g = H // KH
    q5 = q.reshape(B, T, KH, g, D)
    att = torch.einsum("bqhgd,bkhd->bhgqk", q5, k).float() * scale
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~mask, -1e30)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", att.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def causal_attention(q, k, v, scale=None):
    """Causal self-attention ``[B, T, H, D] -> [B, T, H, D]`` through the
    flash forward and backward kernels; k/v may carry fewer heads."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return FlashAttentionFunction.apply(q, k, v, True, float(scale))
