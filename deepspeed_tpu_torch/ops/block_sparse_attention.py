"""Block-sparse attention — a hand-written CUDA kernel for Hopper.

Replaces the Pallas kernel ``_kernel`` of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py`` (:44, entry
``block_sparse_attention`` :91) by ``ops/csrc/block_sparse_attention.cu``
(kernel B8). Each (batch row, head, query block) walks only the active key
blocks its LUT row lists, ``lut[h, qb, :counts[h, qb]]``, with an online
softmax, so the sparse attention matrix never exists in device memory and
inactive blocks cost nothing. The source's note gives its design and what
bounds it on the H100.

Layout at :func:`block_sparse_attention` is the JAX package's: q/k/v
``[B, H, T, D]``, read through their strides (``[B, T, H, D]`` views of a
fused projection need no copy). Numerics follow the TPU kernel: scores are
``dot(q, k)`` in f32, *then* multiplied by ``scale``; a causal mask hides
``col > row``; the softmax runs in f32 and P is rounded to the storage
dtype before ``P.V``; a row with no visible key (count 0, or every visible
block causally masked) gives exactly 0.

Head dims: any ``D <= 256`` (:func:`~deepspeed_tpu_torch.ops.head_dim.
head_dim_route`). Where a row of ``D`` elements is whole 16-byte chunks
(16-bit: ``D % 8 == 0``, f32: ``D % 4 == 0``) the kernel runs its 64-,
128- or 256-wide instantiation on the tensors as they are; any other ``D``
(the padded route, correct and slow) zero-pads q, k and v to that width,
one copy each, and writes the first ``D`` columns of the result. ``D >
256`` raises (fault D1c).

On CPU tensors the wrapper runs :func:`block_sparse_attention_reference`;
on CUDA tensors it launches the kernel or raises. It counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.head_dim import (head_dim_route, pad_head_dim,
                                              unpad_head_dim)
from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder, check_launch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BLOCKS = (16, 32, 64, 128)   # the upstream Triton set; 16 is the default


HEAD_GROUP = 8   # heads of a batch row whose tiles the kernel takes together


def _bind(lib: ctypes.CDLL) -> None:
    lib.dstt_block_sparse_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_block_sparse_attention.restype = ctypes.c_int


BUILDER = CUDAOpBuilder("block_sparse_attention", _bind)
_COUNTERS = {}   # stream -> the persistent kernel's tile counter (the kernel leaves it 0)


def build_lut(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """layout [H, nb, nb] → (lut [H, nb, max_active] int32 padded with 0,
    counts [H, nb] int32). Host-side, as in the JAX package."""
    H, nb, _ = layout.shape
    counts = layout.sum(-1).astype(np.int32)
    max_active = max(1, int(counts.max()))
    lut = np.zeros((H, nb, max_active), np.int32)
    for h in range(H):
        for qb in range(nb):
            cols = np.nonzero(layout[h, qb])[0]
            lut[h, qb, :len(cols)] = cols
    return lut, counts


def visible_entries(lut: np.ndarray, counts: np.ndarray,
                    causal: bool) -> np.ndarray:
    """How many LUT entries of each (head, query block) the kernel
    multiplies → ``[H, nb]``: the first ``count`` of the row, inside
    ``[0, nb)``, and under the causal mask not above the diagonal."""
    H, nb, A = lut.shape
    live = ((np.arange(A) < counts[..., None]) & (lut >= 0) & (lut < nb))
    if causal:
        live &= lut <= np.arange(nb)[None, :, None]
    return live.sum(-1)


def tile_order(lut: np.ndarray, counts: np.ndarray,
               causal: bool) -> np.ndarray:
    """The order in which the kernel takes the tiles of a batch row, for
    blocks of 64 and 128: ``int32 [H * nb]`` of ``h * nb + qb``, the tiles
    of each group of HEAD_GROUP heads together (their K/V stay in L2),
    groups in head order, and within a group the tile with the most
    visible entries first (ties: the later query block, then the lower
    head). Host-side, from the LUT's numpy arrays, once per LUT."""
    H, nb, _ = lut.shape
    vis = visible_entries(lut, counts, causal)
    out = []
    for first in range(0, H, HEAD_GROUP):
        heads = np.arange(first, min(first + HEAD_GROUP, H))
        hh, qq = np.meshgrid(heads, np.arange(nb), indexing="ij")
        hh, qq = hh.ravel(), qq.ravel()
        out.append((hh * nb + qq)[np.lexsort((hh, -qq, -vis[hh, qq]))])
    return np.concatenate(out).astype(np.int32)


def _check_shapes(q, k, v, lut, counts, block):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"block_sparse_attention wants q/k/v [B, H, T, D] of "
                         f"one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, D = q.shape
    if T % block:
        raise ValueError(f"seq {T} not divisible by block {block}")
    nb = T // block
    if (lut.dim() != 3 or tuple(lut.shape[:2]) != (H, nb)
            or tuple(counts.shape) != (H, nb)):
        raise ValueError(f"lut must be [H={H}, nb={nb}, max_active] and "
                         f"counts [H, nb], got {tuple(lut.shape)}, "
                         f"{tuple(counts.shape)}")


def block_sparse_attention_reference(q, k, v, lut, counts, block: int,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel on ``[B, H, T, D]``: each query
    block's active key blocks are gathered through the LUT (entries past the
    count are masked), then one f32 softmax per row with the TPU kernel's
    numerics."""
    _check_shapes(q, k, v, lut, counts, block)
    B, H, T, D = q.shape
    nb = T // block
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lut, counts = lut.long(), counts.long()
    A = lut.shape[-1]
    heads = torch.arange(H, device=q.device)[:, None, None]
    kg = k.reshape(B, H, nb, block, D)[:, heads, lut]   # [B, H, nb, A, blk, D]
    vg = v.reshape(B, H, nb, block, D)[:, heads, lut]
    qb = q.reshape(B, H, nb, block, D)
    s = torch.einsum("bhnqd,bhnakd->bhnqak", qb.float(), kg.float()) * scale
    live = (torch.arange(A, device=q.device) < counts[..., None])[:, :, None,
                                                                  :, None]
    if causal:
        row = (torch.arange(nb, device=q.device)[:, None] * block
               + torch.arange(block, device=q.device))      # [nb, blk]
        col = (lut[..., None] * block
               + torch.arange(block, device=q.device))      # [H, nb, A, blk]
        live = live & (col[:, :, None] <= row[None, :, :, None, None])
    s = s.masked_fill(~live, NEG_INF).reshape(B, H, nb, block, A * block)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhnqj,bhnjd->bhnqd", p.to(q.dtype).float(),
                       vg.reshape(B, H, nb, A * block, D).float())
    out = torch.where(m > NEG_INF / 2, acc / l.clamp_min(1e-30), 0.0)
    return out.to(q.dtype).reshape(B, H, T, D)


def _check_kernel_args(q, k, v, lut, counts, out, block, order):
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, lut, counts,
                                                           out)):
        raise ValueError(f"block_sparse_attention runs on cuda or cpu "
                         f"tensors, all on one device; got q on {dev}, k "
                         f"{k.device}, v {v.device}, lut {lut.device}, counts "
                         f"{counts.device}, out {out.device}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"block_sparse_attention launches on the current "
                         f"device cuda:{torch.cuda.current_device()}, tensors "
                         f"are on {dev}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype) \
            or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_sparse_attention kernel takes float32, "
                        f"float16 or bfloat16 q/k/v/out of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}")
    if block not in _BLOCKS:
        raise ValueError(f"block_sparse_attention kernel takes blocks "
                         f"{_BLOCKS}, got {block}")
    ints = (("lut", lut), ("counts", counts))
    if order is not None:
        H, nb = counts.shape
        if tuple(order.shape) != (H * nb,) or order.device != dev:
            raise ValueError(f"block_sparse_attention: order must be [H * nb "
                             f"= {H * nb}] on {dev}, got {tuple(order.shape)} "
                             f"on {order.device}")
        ints += (("order", order),)
    for name, t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"block_sparse_attention kernel takes a "
                            f"contiguous int32 {name}, got {t.dtype} with "
                            f"strides {t.stride()}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        vec = 16 // x.element_size()
        if (x.stride(3) != 1 or any(s % vec for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(
                f"block_sparse_attention kernel needs {name} with a "
                f"contiguous head dim, 16-byte aligned rows and strides that "
                f"are multiples of {vec} elements; got strides {x.stride()}")


def block_sparse_attention(q, k, v, lut, counts, block: int,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           out: Optional[torch.Tensor] = None,
                           order: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q/k/v ``[B, H, T, D]`` + LUT ``[H, nb, max_active]`` and counts
    ``[H, nb]`` (int32, from :func:`build_lut`) → ``[B, H, T, D]``. Rows with
    no visible key give zeros. ``out``, when given, is a ``[B, H, T, D]``
    tensor (any strides with a contiguous head dim) written in place and
    returned, so a ``[B, T, H, D]`` result needs no transpose copy.
    ``order``, when given, is :func:`tile_order` of the LUT on q's device:
    the order in which the kernel takes its tiles at blocks of 64 and 128
    (without it, the later query blocks first). It moves no result."""
    _check_shapes(q, k, v, lut, counts, block)
    if out is not None and out.shape != q.shape:
        raise ValueError(f"out must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if all(x.device.type == "cpu" for x in (q, k, v, lut, counts)):
        o = block_sparse_attention_reference(q, k, v, lut, counts, block,
                                             causal, scale)
        return o if out is None else out.copy_(o)
    B, H, T, D = q.shape
    DK, pad = head_dim_route(D, q.element_size())
    if pad:   # the padded route: one zero-padded copy of each operand
        return unpad_head_dim(block_sparse_attention(
            *(pad_head_dim(x, DK) for x in (q, k, v)), lut, counts, block,
            causal, scale, order=order), D, out)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check_kernel_args(q, k, v, lut, counts, out, block, order)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counter = _COUNTERS.get(stream)
    if counter is None:
        counter = _COUNTERS[stream] = torch.zeros(1, dtype=torch.int32,
                                                  device=q.device)
    lib = BUILDER.load()
    rc = lib.dstt_block_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lut.data_ptr(), counts.data_ptr(),
        None if order is None else order.data_ptr(), counter.data_ptr(), B, H,
        T, DK, D, block, lut.shape[2],
        *[s for x in (q, k, v, out) for s in x.stride()[:3]], float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, "block_sparse_attention", rc)
    block_sparse_attention.launches += 1
    return out


block_sparse_attention.launches = 0
