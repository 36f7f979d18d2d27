"""Decode attention over the dense KV cache — a hand-written CUDA kernel.

Replaces the Pallas ``_decode_kernel``
(``deepspeed_tpu/ops/pallas/decode_attention.py:78``, public entry
``decode_attention :115``). The kernel is ``ops/csrc/decode_attention.cu``;
its source note gives the design and what bounds it on the H100.

Layout: q ``[B, H, D]`` (one query token per row), the cache in its
storage layout ``[B, S, KH, D]`` with ``KH | H`` — typically the layer view
``cache.k[layer]`` of a ``[L, B, S, KH, D]`` cache, read through its strides
— and ``lengths [B]`` int32: row ``b`` attends positions ``< lengths[b]``.
A row of length 0 gives zeros, as the TPU kernel does.

On a CPU tensor :func:`decode_attention` runs
:func:`decode_attention_reference`, the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder, check_launch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)
_GROUP_SIZES = (1, 2, 4, 8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.dstt_decode_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_decode_attention.restype = ctypes.c_int


BUILDER = CUDAOpBuilder("decode_attention", _bind)


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


def _check_kernel_args(q, k_cache, v_cache, lengths):
    dev = q.device
    if not (k_cache.device == v_cache.device == lengths.device == dev):
        raise ValueError("q, caches and lengths must be on one device")
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"got {dev}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"decode_attention launches on the current device "
                         f"cuda:{torch.cuda.current_device()}, tensors are "
                         f"on {dev}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention kernel takes float32, float16 "
                        f"or bfloat16 q/caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("decode_attention kernel takes contiguous int32 "
                        "lengths")
    D = q.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head dim "
                         f"{_HEAD_DIMS}, got {D}")
    if q.shape[1] // k_cache.shape[2] not in _GROUP_SIZES:
        raise ValueError(f"decode_attention kernel takes query groups of "
                         f"{_GROUP_SIZES} heads per kv head, got "
                         f"{q.shape[1] // k_cache.shape[2]}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:-1]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"decode_attention kernel needs {name} with a contiguous "
                f"head dim, 16-byte aligned rows and strides that are "
                f"multiples of {vec} elements; got strides {x.stride()}")


def decode_attention(q, k_cache, v_cache, lengths,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against the cache, GQA-native → ``[B, H, D]``."""
    _check_shapes(q, k_cache, v_cache, lengths)
    if q.device.type == k_cache.device.type == v_cache.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths, scale)
    _check_kernel_args(q, k_cache, v_cache, lengths)
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lib = BUILDER.load()
    rc = lib.dstt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), B, S, H, KH, D, *q.stride()[:2],
        *k_cache.stride()[:3], *v_cache.stride()[:3], *o.stride()[:2],
        float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
