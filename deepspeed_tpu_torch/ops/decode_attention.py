"""Decode attention over the dense KV cache and over the paged pool —
hand-written CUDA kernels.

Replaces four Pallas kernels of
``deepspeed_tpu/ops/pallas/decode_attention.py``:

* ``_decode_kernel`` (:78, entry ``decode_attention :115``) by
  ``decode_dense_kernel`` of ``ops/csrc/paged_attention.cu``: one query
  token per row against ``[B, S, KH, D]`` (typically the layer view
  ``cache.k[layer]`` of a ``[L, B, S, KH, D]`` cache, read through its
  strides), row ``b`` attending positions ``< lengths[b]``, any ``H / KH``;
* ``_paged_decode_kernel`` (:164, entry ``paged_decode_attention :217``)
  and ``_paged_verify_kernel`` (:421, entry ``paged_verify_attention
  :479``) by ``ops/csrc/paged_attention.cu``: one query per slot, or each
  slot's K candidate tokens, through block tables ``[S, MB]`` into the
  pool ``[NB, BS, KH, D]`` (the layer view of ``PagedKVCache.k``);
* ``_paged_chunk_kernel`` (:292, entry ``paged_chunk_attention :350``) by
  ``ops/csrc/paged_chunk_attention.cu``: one slot's prefill chunk through
  its table row.

Each paged kernel has an int8 variant (the int8 branch of each Pallas
kernel, ``_deq_tile`` :46): an int8 pool with its f32 scale tiles ``[NB,
KH, BS]`` goes to ``paged_{decode,chunk,verify}_attention_int8``, which the
fp wrappers call when they are given ``k_scale``/``v_scale``.

Each source's note gives its design and what bounds it on the H100. A row
with no visible key gives zeros, as the TPU kernels do.

Head dims: any ``D <= 256`` (:func:`~deepspeed_tpu_torch.ops.head_dim.
head_dim_route`). Where a row of ``D`` elements of q and of the cache or
pool is whole 16-byte chunks (16-bit: ``D % 8 == 0``, f32: ``D % 4 == 0``,
an int8 pool: ``D % 16 == 0``) the kernels run their 64-, 128- or 256-wide
instantiation on the tensors as they are; any other ``D`` (the padded
route, correct and slow: it copies the whole cache or pool of the layer on
every call) zero-pads q and the cache or pools to that width and slices the
output back. ``D > 256`` raises (fault D1c).

On CPU tensors each wrapper runs its plain PyTorch version (the
``*_reference`` function beside it, which dequantizes an int8 pool up
front); on CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in ``.launches``, the int8 variants apart from the fp
ones.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.head_dim import (head_dim_route, pad_head_dim,
                                              unpad_head_dim)
from deepspeed_tpu_torch.ops.op_builder import (CUDAOpBuilder, check_launch,
                                               sm_count)
from deepspeed_tpu_torch.ops.quant_core import dequantize_int8

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check_shapes(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention wants q [B, H, D] and caches "
                         f"[B, S, KH, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % k_cache.shape[2]:
        raise ValueError(f"q heads {H} not divisible by kv heads "
                         f"{k_cache.shape[2]}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B={B}], got "
                         f"{tuple(lengths.shape)}")


def decode_attention_reference(q, k_cache, v_cache, lengths,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 math, zeros for a length-0
    row)."""
    _check_shapes(q, k_cache, v_cache, lengths)
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    rep = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kc = k_cache.repeat_interleave(rep, dim=2) if rep > 1 else k_cache
    vc = v_cache.repeat_interleave(rep, dim=2) if rep > 1 else v_cache
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, kc.float())
    live = torch.arange(S, device=q.device)[None, None, :] < \
        lengths.to(q.device)[:, None, None]
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    acc = torch.einsum("bhs,bshd->bhd", p, vc.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _route(q, int8: bool):
    """``(kernel width, pad)`` of q's head dim over q and its cache or
    pools (an int8 pool's rows are the narrowest)."""
    return head_dim_route(q.shape[-1], 1 if int8 else q.element_size())


def _check_operands(name, floats, ints, int8=(), scales=()):
    """Raise unless the kernel ``name`` can take these CUDA operands:
    ``floats`` (q first, then caches or pools) of one float dtype and
    ``int8`` pools, each with a contiguous head dim, 16-byte aligned rows
    and strides that are whole 16-byte vectors; ``scales`` float32 with a
    contiguous last dim; ``ints`` (lengths, block tables) int32 with a
    contiguous last dim. The callers take the padded route first, so the
    head dim needs no check here."""
    q = floats[0]
    dev = q.device
    if any(x.device != dev for x in (*floats, *int8, *scales, *ints)):
        raise ValueError(f"{name}: q, caches, scales, tables and lengths "
                         f"must be on one device")
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name} launches on the current device "
                         f"cuda:{torch.cuda.current_device()}, tensors are "
                         f"on {dev}")
    if any(x.dtype != q.dtype for x in floats) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32, float16 or bfloat16 "
                        f"q/caches of one dtype, got "
                        f"{[str(x.dtype) for x in floats]}")
    if any(x.dtype != torch.int8 for x in int8):
        raise TypeError(f"{name} kernel takes int8 pools, got "
                        f"{[str(x.dtype) for x in int8]}")
    if any(x.dtype != torch.float32 or x.stride(-1) != 1 for x in scales):
        raise TypeError(f"{name} kernel takes float32 scale tiles with a "
                        f"contiguous block dim")
    if any(x.dtype != torch.int32 or x.stride(-1) != 1 for x in ints):
        raise TypeError(f"{name} kernel takes int32 lengths and tables with "
                        f"a contiguous last dim")
    for x in (*floats, *int8):
        vec = 16 // x.element_size()
        if x.stride(-1) != 1 or any(st % vec for st in x.stride()[:-1]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{name} kernel needs q and caches with a contiguous head "
                f"dim, 16-byte aligned rows and strides that are multiples "
                f"of {vec} elements; got strides {x.stride()}")


def _check_kernel_args(q, k_cache, v_cache, lengths):
    _check_operands("decode_attention", (q, k_cache, v_cache), (lengths,))


def decode_attention(q, k_cache, v_cache, lengths,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against the cache, GQA-native → ``[B, H, D]``."""
    _check_shapes(q, k_cache, v_cache, lengths)
    if q.device.type == k_cache.device.type == v_cache.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths, scale)
    B, H, D = q.shape
    scale = _scale(scale, D)
    DK, pad = _route(q, False)
    if pad:   # the padded route: copies of q and the whole cache
        return unpad_head_dim(decode_attention(
            *(pad_head_dim(x, DK) for x in (q, k_cache, v_cache)), lengths,
            scale), D)
    _check_kernel_args(q, k_cache, v_cache, lengths)
    S, KH = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part, splits, chunk = _dense_args(q, stream, B, S, KH, DK)
    lib = PAGED_BUILDER.load()
    rc = lib.dstt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), tickets, part, B, S, H, KH, DK, D,
        splits, chunk, *q.stride()[:2], *k_cache.stride()[:3],
        *v_cache.stride()[:3], *o.stride()[:2], scale,
        _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


# ------------------------------------------------------------------ paged


def _bind_paged(lib: ctypes.CDLL) -> None:
    lib.dstt_decode_attention.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_decode_attention.restype = ctypes.c_int
    lib.dstt_paged_decode_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_decode_attention.restype = ctypes.c_int
    lib.dstt_paged_verify_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 13
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_verify_attention.restype = ctypes.c_int
    lib.dstt_paged_decode_attention_int8.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 15
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_decode_attention_int8.restype = ctypes.c_int
    lib.dstt_paged_verify_attention_int8.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 17
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_verify_attention_int8.restype = ctypes.c_int


def _bind_chunk(lib: ctypes.CDLL) -> None:
    lib.dstt_paged_chunk_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_chunk_attention.restype = ctypes.c_int
    lib.dstt_paged_chunk_attention_int8.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 14
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_paged_chunk_attention_int8.restype = ctypes.c_int


PAGED_BUILDER = CUDAOpBuilder("paged_attention", _bind_paged)
CHUNK_BUILDER = CUDAOpBuilder("paged_chunk_attention", _bind_chunk)

_MAX_SPLITS = 16   # the kernel merges at most 16 partials a unit


@functools.lru_cache(maxsize=None)
def paged_split_plan(span: int, units: int, sms: int) -> Tuple[int, int]:
    """How the paged decode kernel (``paged_attention.cu``) cuts the key
    range ``[0, span)`` (span = MB * BS) of each of its ``units`` (slot,
    kv head, row group) triples among blocks: ``(splits, chunk)``, split
    ``i`` taking keys ``[i * chunk, min((i + 1) * chunk, span))``.

    A split takes 128 keys when the units alone do not fill the SMs, else
    256 (a split's fixed cost, its query rows and its merge, is paid per
    block); more only past 16 splits. The chunk does not depend on the
    span below that, so two servers of one model whose pools differ in
    blocks a slot sum each key in the same place and give the same bits.
    Static sizes only: lengths stay on the device, and a split past a
    slot's length loads nothing."""
    chunk = 128 if units < sms else 256
    if span > _MAX_SPLITS * chunk:
        chunk = -(-span // (_MAX_SPLITS * 128)) * 128
    return -(-span // chunk), chunk


@functools.lru_cache(maxsize=None)
def dense_split_plan(S: int, units: int, sms: int) -> Tuple[int, int]:
    """How the dense decode (B4, ``decode_dense_kernel`` in
    ``paged_attention.cu``) cuts the key range ``[0, S)`` of each of its
    ``units`` (batch row, kv head, row group) triples among blocks:
    ``(splits, chunk)``, split ``i`` taking keys ``[i * chunk, min((i + 1)
    * chunk, S))``.

    A split takes 384 keys when the units alone do not fill the SMs, else
    1024 (measured on the H100 at S=1024: at H=32/KH=8's 64 units 384
    beat 256 and 512; at GPT-2 XL's 200 units splits of 512 keys ran 2%
    faster behind an L2 flush but 3% slower inside ``generate``'s decode
    step, whose merges the flush hid); more only past 16 splits. The chunk
    does not depend on S below that, so two caches of one model that
    differ in length sum each key in the same place and give the same
    bits. Static sizes only: lengths stay on the device, and a split past
    a row's length loads nothing."""
    chunk = 384 if units < sms else 1024
    if S > _MAX_SPLITS * chunk:
        chunk = -(-S // (_MAX_SPLITS * 128)) * 128
    return -(-S // chunk), chunk


def paged_row_groups(nrows: int) -> int:
    """Blocks a (slot, kv head) takes for its ``nrows`` = H / KH query
    rows: up to 8 rows a block, as ``paged_attention.cu`` groups them."""
    return -(-nrows // 8)


def paged_verify_plan(span: int, S: int, KH: int,
                      rows: int) -> Tuple[int, int, int]:
    """How the paged verify kernel (``paged_attention.cu``) cuts its work:
    ``(units, splits, chunk)``. A unit is one (slot, kv head, group of up
    to 16 of the ``rows`` = K * H/KH query rows, the rows of one tensor-core
    tile); each unit's key range ``[0, span)`` is cut into splits of 256
    keys, more only past 16 splits (measured on the H100 at S=8 over 1024
    keys: 256 beat 128 and 512 at GPT-2 XL and at H=32/KH=8). The chunk
    does not depend on the span below that cap, so servers whose pools
    differ in blocks a slot sum each key in the same place. Static sizes
    only: lengths stay on the device."""
    chunk = 256
    if span > _MAX_SPLITS * chunk:
        chunk = -(-span // (_MAX_SPLITS * 128)) * 128
    return S * KH * -(-rows // 16), -(-span // chunk), chunk


# (kernel, stream, shape, kernel width) -> (tickets, partials, launch args)
_SCRATCH = {}


def _scratch(key, device, units, part, plan):
    """Arrival tickets for ``units`` units (zero; the kernels leave them
    so) and ``part`` f32 partials, kept per ``key`` (a stream is on one
    device, and launches on one stream run in order; the partials live only
    within a launch), with the C arguments ``(tickets, part, *plan)``."""
    tickets = torch.zeros(units, dtype=torch.int32, device=device)
    buf = torch.empty(part, dtype=torch.float32, device=device)
    hit = _SCRATCH[key] = (tickets, buf, (tickets.data_ptr(),
                                           buf.data_ptr(), *plan))
    return hit[2]


def _split_args(q, stream, S, KH, MB, BS, DK):
    """The plan of a paged decode launch and its scratch, as the C
    interface takes them: ``(tickets, partials, splits, chunk)``, so a call
    pays one dict lookup. The partials are of the kernel width ``DK``."""
    R = q.shape[1] // KH
    key = ("decode", stream, S, KH, R, MB * BS, DK)
    hit = _SCRATCH.get(key)
    if hit is not None:
        return hit[2]
    units = S * KH * paged_row_groups(R)
    splits, chunk = paged_split_plan(MB * BS, units, sm_count(q.device))
    rows = 1 << (min(R, 8) - 1).bit_length()
    return _scratch(key, q.device, units, units * splits * rows * (DK + 4),
                    (splits, chunk))


def _dense_args(q, stream, B, S, KH, DK):
    """:func:`_split_args` of a dense decode launch: the plan of the cache
    ``[B, S, KH, D]`` and its scratch, kept per (stream, B, KH, R, S, DK),
    all static in ``generate``."""
    R = q.shape[1] // KH
    key = ("dense", stream, B, KH, R, S, DK)
    hit = _SCRATCH.get(key)
    if hit is not None:
        return hit[2]
    units = B * KH * paged_row_groups(R)
    splits, chunk = dense_split_plan(S, units, sm_count(q.device))
    rows = 1 << (min(R, 8) - 1).bit_length()
    return _scratch(key, q.device, units, units * splits * rows * (DK + 4),
                    (splits, chunk))


def _verify_args(q, stream, KH, MB, BS, DK):
    """:func:`_split_args` of a paged verify launch (q ``[S, K, H, D]``,
    16 rows a unit; f32 queries take the decode kernel's units of up to 8
    rows, so the tickets count those)."""
    S, K, H, _ = q.shape
    rows = K * (H // KH)
    key = ("verify", stream, S, KH, rows, MB * BS, DK)
    hit = _SCRATCH.get(key)
    if hit is not None:
        return hit[2]
    units, splits, chunk = paged_verify_plan(MB * BS, S, KH, rows)
    return _scratch(key, q.device, S * KH * paged_row_groups(rows),
                    units * splits * 16 * (DK + 4), (splits, chunk))


def _check_pools(name, q, k_pool, v_pool, k_scale, v_scale):
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name} wants pools [NB, BS, KH, D], got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if q.shape[-1] != k_pool.shape[3] or q.shape[-2] % k_pool.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"pool {tuple(k_pool.shape)} (head dim, or q heads "
                         f"not divisible by kv heads)")
    quantized = k_scale is not None
    if ((v_scale is not None) != quantized
            or (k_pool.dtype == torch.int8) != quantized
            or (v_pool.dtype == torch.int8) != quantized):
        raise ValueError(f"{name}: int8 pools require k_scale/v_scale (and "
                         f"fp pools must not pass them)")
    if quantized:
        NB, BS, KH = k_pool.shape[:3]
        for x in (k_scale, v_scale):
            if tuple(x.shape) != (NB, KH, BS):
                raise ValueError(f"{name}: scale tiles must be [NB, KH, BS] "
                                 f"= {(NB, KH, BS)}, got {tuple(x.shape)}")


def _check_tables(name, S, block_tables, lengths):
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"{name} wants block_tables [S={S}, MB] and lengths "
                         f"[S], got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")


def _scale(scale, D):
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def _on_cpu(*xs):
    return all(x.device.type == "cpu" for x in xs if x is not None)


def _gather(pool, table):
    """Per-slot contiguous copies through the tables: ``[..., MB]`` ids →
    ``[..., MB * BS, KH, D]`` (gathered position j is position j)."""
    g = pool[table.long()]
    return g.reshape(*table.shape[:-1], -1, *pool.shape[2:])


def _dequant_pools(k_pool, v_pool, k_scale, v_scale):
    """The plain versions' dequantization, up front: int8 pools times
    their ``[NB, KH, BS]`` scale tiles → f32 pools (fp pools pass)."""
    if k_scale is None:
        return k_pool, v_pool
    return (dequantize_int8(k_pool, k_scale.transpose(1, 2)[..., None]),
            dequantize_int8(v_pool, v_scale.transpose(1, 2)[..., None]))


def _masked_softmax(s, visible):
    """Unnormalised f32 softmax of ``s`` over its last dim where
    ``visible``, and its normaliser; a row with nothing visible gives
    zeros (the kernels' contract)."""
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    return p, p.sum(-1, keepdim=True).clamp_min(1e-30)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     lengths, scale: Optional[float] = None,
                                     k_scale=None, v_scale=None
                                     ) -> torch.Tensor:
    """Plain version of the paged decode kernel: gather each slot's cache
    through its table (an int8 pool dequantized first), then the dense
    decode's plain version."""
    _check_pools("paged_decode_attention", q, k_pool, v_pool, k_scale,
                 v_scale)
    _check_tables("paged_decode_attention", q.shape[0], block_tables,
                  lengths)
    k_pool, v_pool = _dequant_pools(k_pool, v_pool, k_scale, v_scale)
    return decode_attention_reference(q, _gather(k_pool, block_tables),
                                      _gather(v_pool, block_tables), lengths,
                                      scale)


def paged_chunk_attention_reference(q, k_pool, v_pool, block_table, start,
                                    scale: Optional[float] = None,
                                    k_scale=None, v_scale=None
                                    ) -> torch.Tensor:
    """Plain version of the paged chunk kernel: gather the slot's cache
    through its table row (an int8 pool dequantized first), f32 softmax
    with ``col <= start + qi``."""
    _check_pools("paged_chunk_attention", q, k_pool, v_pool, k_scale,
                 v_scale)
    k_pool, v_pool = _dequant_pools(k_pool, v_pool, k_scale, v_scale)
    C, H, D = q.shape
    rep = H // k_pool.shape[2]
    kc = _gather(k_pool, block_table).repeat_interleave(rep, dim=1)
    vc = _gather(v_pool, block_table).repeat_interleave(rep, dim=1)
    s = torch.einsum("chd,shd->chs", q.float() * _scale(scale, D), kc.float())
    col = torch.arange(kc.shape[0], device=q.device)
    qi = torch.arange(C, device=q.device)
    visible = (col[None, None, :] <= start + qi[:, None, None])
    p, norm = _masked_softmax(s, visible)
    return (torch.einsum("chs,shd->chd", p, vc.float()) / norm).to(q.dtype)


def paged_verify_attention_reference(q, k_pool, v_pool, block_tables,
                                     lengths, scale: Optional[float] = None,
                                     k_scale=None, v_scale=None
                                     ) -> torch.Tensor:
    """Plain version of the paged verify kernel: gather each slot's cache
    through its table (an int8 pool dequantized first), f32 softmax with
    ``col <= lengths[s] + qi``."""
    _check_pools("paged_verify_attention", q, k_pool, v_pool, k_scale,
                 v_scale)
    S, K, H, D = q.shape
    _check_tables("paged_verify_attention", S, block_tables, lengths)
    k_pool, v_pool = _dequant_pools(k_pool, v_pool, k_scale, v_scale)
    rep = H // k_pool.shape[2]
    kc = _gather(k_pool, block_tables).repeat_interleave(rep, dim=2)
    vc = _gather(v_pool, block_tables).repeat_interleave(rep, dim=2)
    s = torch.einsum("skhd,sphd->shkp", q.float() * _scale(scale, D),
                     kc.float())
    col = torch.arange(kc.shape[1], device=q.device)
    qi = torch.arange(K, device=q.device)
    visible = col[None, None, None, :] <= (
        lengths.to(q.device)[:, None, None, None] + qi[None, None, :, None])
    p, norm = _masked_softmax(s, visible)
    return (torch.einsum("shkp,sphd->skhd", p, vc.float())
            / norm.permute(0, 2, 1, 3)).to(q.dtype)


def _check_decode_args(name, q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale):
    _check_pools(name, q, k_pool, v_pool, k_scale, v_scale)
    if q.dim() != 3:
        raise ValueError(f"{name} wants q [S, H, D], got {tuple(q.shape)}")
    _check_tables(name, q.shape[0], block_tables, lengths)


def _check_chunk_args(name, q, k_pool, v_pool, block_table, k_scale,
                      v_scale):
    _check_pools(name, q, k_pool, v_pool, k_scale, v_scale)
    if q.dim() != 3 or block_table.dim() != 1:
        raise ValueError(f"{name} wants q [C, H, D] and one table row [MB], "
                         f"got {tuple(q.shape)}, {tuple(block_table.shape)}")


def _check_verify_args(name, q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale):
    _check_pools(name, q, k_pool, v_pool, k_scale, v_scale)
    if q.dim() != 4:
        raise ValueError(f"{name} wants q [S, K, H, D], got "
                         f"{tuple(q.shape)}")
    _check_tables(name, q.shape[0], block_tables, lengths)


def _int8_args(name, q, k_pool, v_pool, k_scale, v_scale, ints):
    """Check the int8 kernels' operands; their pointers and the scale
    tiles' strides (block, head) in the C argument order."""
    _check_operands(name, (q,), ints, int8=(k_pool, v_pool),
                    scales=(k_scale, v_scale))
    return ([k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
             v_scale.data_ptr()],
            [*k_scale.stride()[:2], *v_scale.stride()[:2]])


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """One-token attention per slot through the paged pool, GQA-native:
    q ``[S, H, D]``, pools ``[NB, BS, KH, D]``, ``block_tables [S, MB]``
    int32 (dead entries point at a valid block — the null block 0),
    ``lengths [S]`` int32 → ``[S, H, D]``. An int8 pool passes its scale
    tiles ``k_scale``/``v_scale`` ``[NB, KH, BS]`` and goes to
    :func:`paged_decode_attention_int8`."""
    if k_scale is not None or v_scale is not None:
        return paged_decode_attention_int8(q, k_pool, v_pool, block_tables,
                                           lengths, k_scale, v_scale, scale)
    _check_decode_args("paged_decode_attention", q, k_pool, v_pool,
                       block_tables, lengths, None, None)
    S, H, D = q.shape
    if _on_cpu(q, k_pool, v_pool, block_tables, lengths):
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, lengths, scale)
    scale = _scale(scale, D)
    DK, pad = _route(q, False)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_decode_attention(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)),
            block_tables, lengths, scale), D)
    _check_operands("paged_decode_attention", (q, k_pool, v_pool),
                    (block_tables, lengths))
    NB, BS, KH = k_pool.shape[:3]
    MB = block_tables.shape[1]
    o = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part, splits, chunk = _split_args(q, stream, S, KH, MB, BS, DK)
    lib = PAGED_BUILDER.load()
    rc = lib.dstt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), tickets,
        part, S, H, KH, DK, D, NB, BS, MB, splits, chunk, *q.stride()[:2],
        *k_pool.stride()[:3], *v_pool.stride()[:3], block_tables.stride(0),
        *o.stride()[:2], scale, _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, "paged_decode_attention", rc)
    paged_decode_attention.launches += 1
    return o


def paged_decode_attention_int8(q, k_pool, v_pool, block_tables, lengths,
                                k_scale, v_scale,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """:func:`paged_decode_attention` over an int8 pool: int8 pools ``[NB,
    BS, KH, D]`` and their f32 scale tiles ``[NB, KH, BS]``, q and the
    output in f32, f16 or bf16."""
    name = "paged_decode_attention_int8"
    _check_decode_args(name, q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale)
    S, H, D = q.shape
    if _on_cpu(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale):
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, lengths, scale, k_scale,
            v_scale)
    scale = _scale(scale, D)
    DK, pad = _route(q, True)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_decode_attention_int8(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)),
            block_tables, lengths, k_scale, v_scale,
            scale), D)
    ptrs, sstrides = _int8_args(name, q, k_pool, v_pool, k_scale, v_scale,
                                (block_tables, lengths))
    NB, BS, KH = k_pool.shape[:3]
    MB = block_tables.shape[1]
    o = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part, splits, chunk = _split_args(q, stream, S, KH, MB, BS, DK)
    lib = PAGED_BUILDER.load()
    rc = lib.dstt_paged_decode_attention_int8(
        q.data_ptr(), *ptrs, block_tables.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), tickets, part, S, H, KH, DK, D, NB, BS, MB, splits,
        chunk, *q.stride()[:2], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *sstrides, block_tables.stride(0), *o.stride()[:2], scale,
        _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, name, rc)
    paged_decode_attention_int8.launches += 1
    return o


def paged_chunk_attention(q, k_pool, v_pool, block_table, start: int,
                          scale: Optional[float] = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """Chunked-prefill attention for one slot through the paged pool:
    q ``[C, H, D]`` at absolute positions ``start..start+C-1`` (the
    chunk's own k/v already in the pool), pools ``[NB, BS, KH, D]``, the
    slot's table row ``[MB]`` int32, ``start`` a host int → ``[C, H, D]``.
    An int8 pool passes its scale tiles and goes to
    :func:`paged_chunk_attention_int8`."""
    if k_scale is not None or v_scale is not None:
        return paged_chunk_attention_int8(q, k_pool, v_pool, block_table,
                                          start, k_scale, v_scale, scale)
    _check_chunk_args("paged_chunk_attention", q, k_pool, v_pool,
                      block_table, None, None)
    start = int(start)
    if _on_cpu(q, k_pool, v_pool, block_table):
        return paged_chunk_attention_reference(
            q, k_pool, v_pool, block_table, start, scale)
    C, H, D = q.shape
    scale = _scale(scale, D)
    DK, pad = _route(q, False)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_chunk_attention(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)), block_table,
            start, scale), D)
    _check_operands("paged_chunk_attention", (q, k_pool, v_pool),
                    (block_table,))
    NB, BS, KH = k_pool.shape[:3]
    o = torch.empty((C, H, D), dtype=q.dtype, device=q.device)
    lib = CHUNK_BUILDER.load()
    rc = lib.dstt_paged_chunk_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), o.data_ptr(), C, H, KH, DK, D, NB, BS,
        block_table.shape[0], start, *q.stride()[:2], *k_pool.stride()[:3],
        *v_pool.stride()[:3], *o.stride()[:2], scale,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "paged_chunk_attention", rc)
    paged_chunk_attention.launches += 1
    return o


def paged_chunk_attention_int8(q, k_pool, v_pool, block_table, start: int,
                               k_scale, v_scale,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """:func:`paged_chunk_attention` over an int8 pool and its f32 scale
    tiles ``[NB, KH, BS]``."""
    name = "paged_chunk_attention_int8"
    _check_chunk_args(name, q, k_pool, v_pool, block_table, k_scale,
                      v_scale)
    start = int(start)
    if _on_cpu(q, k_pool, v_pool, block_table, k_scale, v_scale):
        return paged_chunk_attention_reference(
            q, k_pool, v_pool, block_table, start, scale, k_scale, v_scale)
    C, H, D = q.shape
    scale = _scale(scale, D)
    DK, pad = _route(q, True)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_chunk_attention_int8(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)), block_table,
            start, k_scale, v_scale, scale), D)
    ptrs, sstrides = _int8_args(name, q, k_pool, v_pool, k_scale, v_scale,
                                (block_table,))
    NB, BS, KH = k_pool.shape[:3]
    o = torch.empty((C, H, D), dtype=q.dtype, device=q.device)
    lib = CHUNK_BUILDER.load()
    rc = lib.dstt_paged_chunk_attention_int8(
        q.data_ptr(), *ptrs, block_table.data_ptr(), o.data_ptr(), C, H, KH,
        DK, D, NB, BS, block_table.shape[0], start, *q.stride()[:2],
        *k_pool.stride()[:3], *v_pool.stride()[:3], *sstrides,
        *o.stride()[:2], scale, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, name, rc)
    paged_chunk_attention_int8.launches += 1
    return o


def paged_verify_attention(q, k_pool, v_pool, block_tables, lengths,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Speculative-verify attention for every slot through the paged pool:
    q ``[S, K, H, D]`` at positions ``lengths[s]..lengths[s]+K-1`` (their
    k/v already in the pool), pools ``[NB, BS, KH, D]``, ``block_tables
    [S, MB]`` and ``lengths [S]`` int32 → ``[S, K, H, D]``. An int8 pool
    passes its scale tiles and goes to
    :func:`paged_verify_attention_int8`."""
    if k_scale is not None or v_scale is not None:
        return paged_verify_attention_int8(q, k_pool, v_pool, block_tables,
                                           lengths, k_scale, v_scale, scale)
    _check_verify_args("paged_verify_attention", q, k_pool, v_pool,
                       block_tables, lengths, None, None)
    S, K, H, D = q.shape
    if _on_cpu(q, k_pool, v_pool, block_tables, lengths):
        return paged_verify_attention_reference(
            q, k_pool, v_pool, block_tables, lengths, scale)
    scale = _scale(scale, D)
    DK, pad = _route(q, False)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_verify_attention(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)),
            block_tables, lengths, scale), D)
    _check_operands("paged_verify_attention", (q, k_pool, v_pool),
                    (block_tables, lengths))
    NB, BS, KH = k_pool.shape[:3]
    MB = block_tables.shape[1]
    o = torch.empty((S, K, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part, splits, chunk = _verify_args(q, stream, KH, MB, BS, DK)
    lib = PAGED_BUILDER.load()
    rc = lib.dstt_paged_verify_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), tickets,
        part, S, K, H, KH, DK, D, NB, BS, MB, splits, chunk, *q.stride()[:3],
        *k_pool.stride()[:3], *v_pool.stride()[:3], block_tables.stride(0),
        *o.stride()[:3], scale, _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, "paged_verify_attention", rc)
    paged_verify_attention.launches += 1
    return o


def paged_verify_attention_int8(q, k_pool, v_pool, block_tables, lengths,
                                k_scale, v_scale,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """:func:`paged_verify_attention` over an int8 pool and its f32 scale
    tiles ``[NB, KH, BS]``."""
    name = "paged_verify_attention_int8"
    _check_verify_args(name, q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale)
    S, K, H, D = q.shape
    if _on_cpu(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale):
        return paged_verify_attention_reference(
            q, k_pool, v_pool, block_tables, lengths, scale, k_scale,
            v_scale)
    scale = _scale(scale, D)
    DK, pad = _route(q, True)
    if pad:   # the padded route: copies of q and the whole pools
        return unpad_head_dim(paged_verify_attention_int8(
            *(pad_head_dim(x, DK) for x in (q, k_pool, v_pool)),
            block_tables, lengths, k_scale, v_scale,
            scale), D)
    ptrs, sstrides = _int8_args(name, q, k_pool, v_pool, k_scale, v_scale,
                                (block_tables, lengths))
    NB, BS, KH = k_pool.shape[:3]
    MB = block_tables.shape[1]
    o = torch.empty((S, K, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, part, splits, chunk = _verify_args(q, stream, KH, MB, BS, DK)
    lib = PAGED_BUILDER.load()
    rc = lib.dstt_paged_verify_attention_int8(
        q.data_ptr(), *ptrs, block_tables.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), tickets, part, S, K, H, KH, DK, D, NB, BS, MB, splits,
        chunk, *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *sstrides, block_tables.stride(0), *o.stride()[:3], scale,
        _DTYPE_CODE[q.dtype], stream)
    check_launch(lib, name, rc)
    paged_verify_attention_int8.launches += 1
    return o


paged_decode_attention.launches = 0
paged_chunk_attention.launches = 0
paged_verify_attention.launches = 0
paged_decode_attention_int8.launches = 0
paged_chunk_attention_int8.launches = 0
paged_verify_attention_int8.launches = 0
