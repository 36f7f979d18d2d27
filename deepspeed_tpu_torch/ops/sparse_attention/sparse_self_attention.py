"""SparseSelfAttention front-end.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
takes q/k/v ``[B, T, H, D]`` and a :class:`SparsityConfig`, caches the
layout, the device LUT and the kernel's tile order per sequence length,
and runs the block-sparse kernel (B8, ``ops/block_sparse_attention.py``)
on CUDA tensors, or its plain version on CPU tensors. The kernel reads the ``[B, T, H, D]`` inputs and
writes the ``[B, T, H, D]`` output through their strides: no transpose is
copied.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.block_sparse_attention import (
    block_sparse_attention, build_lut, tile_order)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)

NEG_INF = -1e30


def layout_to_dense_mask(layout: np.ndarray, block: int,
                         causal: bool) -> np.ndarray:
    """[H, nb, nb] block layout → [H, T, T] element mask (oracle path)."""
    H, nb, _ = layout.shape
    T = nb * block
    mask = np.kron(layout.astype(bool), np.ones((block, block), bool))
    if causal:
        mask &= np.tril(np.ones((T, T), bool))[None]
    return mask


def _masked_attention(q, k, v, mask):
    """Dense masked softmax attention in f32 over ``[B, T, H, D]``; ``mask``
    broadcasts to ``[B, H, T, T]``. Rows with no live key give zeros."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(att.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    live = mask.any(-1).transpose(1, 2)[..., None]        # [B|1, T, H, 1]
    return torch.where(live, out, 0.0).to(q.dtype)


def sparse_attention_reference(q, k, v, layout: np.ndarray, block: int,
                               causal: bool) -> torch.Tensor:
    """Dense-masked numerics oracle. q/k/v [B, T, H, D]."""
    mask = torch.as_tensor(layout_to_dense_mask(layout, block, causal),
                           device=q.device)
    return _masked_attention(q, k, v, mask[None])


def _bthd_out(q):
    """A ``[B, T, H, D]`` output, seen as ``[B, H, T, D]`` by the kernel."""
    return torch.empty(q.shape, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def sparse_attention(q, k, v, layout: np.ndarray, block: int,
                     causal: bool = False) -> torch.Tensor:
    """Block-sparse attention. q/k/v ``[B, T, H, D]`` → same shape."""
    lut, counts = (torch.as_tensor(x, device=q.device)
                   for x in build_lut(layout))
    out = block_sparse_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lut, counts,
        block=block, causal=causal, out=_bthd_out(q))
    return out.transpose(1, 2)


class SparseSelfAttention:
    """Drop-in sparse attention op (reference ``SparseSelfAttention``).

    >>> op = SparseSelfAttention(FixedSparsityConfig(num_heads=16,
    ...                                              block=64))
    >>> ctx = op(q, k, v)   # [B, T, H, D]
    """

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._cache: Dict[int, Tuple[np.ndarray, torch.Tensor,
                                     torch.Tensor]] = {}
        self._orders: Dict[int, torch.Tensor] = {}   # the kernel's tile order

    @property
    def causal(self) -> bool:
        return getattr(self.sparsity_config, "attention",
                       "bidirectional") == "unidirectional"

    def layout(self, seq_len: int) -> np.ndarray:
        return self._entry(seq_len)[0]

    def _entry(self, seq_len: int, device: Optional[torch.device] = None):
        """(layout, lut, counts) for ``seq_len``; the LUT is built once per
        length and kept on the device of the call that needs it."""
        entry = self._cache.get(seq_len)
        if entry is None:
            lay = self.sparsity_config.make_layout(seq_len)
            entry = (lay, *(torch.as_tensor(x) for x in build_lut(lay)))
        if device is not None and entry[1].device != device:
            entry = (entry[0], entry[1].to(device), entry[2].to(device))
        self._cache[seq_len] = entry
        return entry

    def __call__(self, query, key, value, key_padding_mask=None):
        B, T, H, D = query.shape
        if H != self.sparsity_config.num_heads:
            raise ValueError(
                f"q has {H} heads but sparsity config was built for "
                f"{self.sparsity_config.num_heads}")
        lay, lut, counts = self._entry(T, query.device)
        if key_padding_mask is not None:
            # padded keys masked in dense torch math, as the JAX package
            # does outside its kernel; fully padded rows give zeros
            mask = torch.as_tensor(layout_to_dense_mask(
                lay, self.sparsity_config.block, self.causal),
                device=query.device)[None]
            kpm = torch.as_tensor(key_padding_mask, device=query.device)
            mask = mask & kpm[:, None, None, :].bool()
            return _masked_attention(query, key, value, mask)
        order = self._orders.get(T)
        if order is None or order.device != query.device:
            lut_np, counts_np = build_lut(lay)
            order = self._orders[T] = torch.as_tensor(
                tile_order(lut_np, counts_np, self.causal),
                device=query.device)
        out = block_sparse_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
            lut, counts, block=self.sparsity_config.block, causal=self.causal,
            out=_bthd_out(query), order=order)
        return out.transpose(1, 2)
