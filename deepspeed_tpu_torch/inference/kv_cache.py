"""Dense KV cache — the inference workspace.

Counterpart of the dense part of ``deepspeed_tpu/inference/kv_cache.py``
(``KVCache`` through ``advance``, :28-151): keys and values
``[L, B, S_max, KH, D]`` plus per-sequence live ``lengths [B]`` (int32, on
the cache's device). JAX threads an immutable, donated cache through its
jitted steps; here :func:`write_prompt` and :func:`append_token` write the
k/v buffers in place (one allocation per generation, no copies), while
``lengths`` is replaced, never mutated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, S, KH, D]
    v: torch.Tensor        # [L, B, S, KH, D]
    lengths: torch.Tensor  # [B] int32 — live tokens per sequence

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def auto_max_tokens(num_layers: int, batch: int, num_kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16,
                    reserve_fraction: float = 0.1, shard_factor: int = 1,
                    device=None) -> Optional[int]:
    """Free-memory KV budget: how many cache tokens per sequence fit the
    device's currently free memory, minus a reserve for activations.
    Returns ``None`` for a device that reports no memory stats (the CPU) —
    callers fall back to the explicit default. Raises when stats exist but
    free memory cannot hold even a 128-token cache."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    from deepspeed_tpu_torch.accelerator import get_accelerator
    stats = get_accelerator().memory_stats(device.index)
    limit = int(stats.get("bytes_limit", 0))
    if limit <= 0:
        return None
    free = max(0, limit - int(stats.get("bytes_in_use", 0)))
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_token = (num_layers * 2 * num_kv_heads * head_dim * itemsize * batch
                 ) // max(int(shard_factor), 1)
    tokens = (int(free * (1.0 - reserve_fraction)) // max(per_token, 1)
              // 128) * 128
    if tokens < 128:
        raise RuntimeError(
            "max_out_tokens='auto': free accelerator memory "
            f"({free / 2**20:.0f} MiB of {limit / 2**20:.0f} MiB limit) "
            f"cannot hold even a 128-token KV cache at {per_token} "
            "bytes/token — reduce batch/model size, free memory, or set "
            "max_out_tokens explicitly")
    return tokens


def init_cache(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, max_seq, num_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def write_prompt(cache: KVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor, lengths: torch.Tensor) -> KVCache:
    """Prefill: write ``[B, T, KH, D]`` keys/values at positions 0..T-1 of
    ``layer``, IN PLACE, and set ``lengths``.

    Right-padded positions hold garbage; they are either masked by decode
    (col >= lengths) or overwritten by later appends at ``lengths[b]``.
    Pad positions past the cache's end are dropped.
    """
    T = min(k.shape[1], cache.max_seq)
    cache.k[layer, :, :T] = k[:, :T]
    cache.v[layer, :, :T] = v[:, :T]
    return dataclasses.replace(
        cache, lengths=lengths.to(device=cache.k.device, dtype=torch.int32))


def append_token(cache: KVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor) -> KVCache:
    """Decode: write one token's ``[B, KH, D]`` k/v at ``lengths[b]`` of
    ``layer``, IN PLACE.

    Lengths are NOT advanced here (all layers append at the same position);
    call :func:`advance` once per step after the last layer.
    """
    rows = torch.arange(k.shape[0], device=cache.k.device)
    pos = cache.lengths.long()
    cache.k[layer, rows, pos] = k.to(cache.k.dtype)
    cache.v[layer, rows, pos] = v.to(cache.v.dtype)
    return cache


def advance(cache: KVCache, n: int = 1) -> KVCache:
    """A cache whose lengths are ``n`` further on (same k/v buffers)."""
    return dataclasses.replace(cache, lengths=cache.lengths + n)
