"""Flash attention forward — a hand-written CUDA kernel for Hopper.

Replaces the Pallas ``_fwd_kernel``
(``deepspeed_tpu/ops/pallas/flash_attention.py:65``, public entry
``flash_attention :389``). The kernel is ``ops/csrc/flash_attention_fwd.cu``;
its source note gives the design and what bounds it on the H100.

Layout at the public functions is the JAX package's: q ``[B, T, H, D]``,
k/v ``[B, T, KH, D]`` with ``KH | H`` (grouped-query attention reads kv head
``h // (H // KH)``, nothing is repeated). Unlike the TPU kernel, any
``T >= 1`` is taken: the kernel masks the ragged edge itself.

On a CPU tensor the functions run :func:`flash_attention_reference`, the
plain PyTorch version with the same numerics (scale folded into q in the
storage dtype, P rounded to the storage dtype before P.V, f32
accumulation). On a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder, check_launch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (64, 128)


def _bind(lib: ctypes.CDLL) -> None:
    lib.dstt_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_flash_attention_fwd.restype = ctypes.c_int


BUILDER = CUDAOpBuilder("flash_attention_fwd", _bind)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q [B, T, H, D] and k/v "
                         f"[B, T, KH, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, T) or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"incompatible with q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not divisible by kv heads "
                         f"{k.shape[2]}")
    if T < 1:
        raise ValueError("flash_attention needs T >= 1")


def flash_attention_reference(q, k, v, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(o [B, T, H, D], lse
    [B, H, T] f32)``, same numerics as the TPU kernel."""
    _check_shapes(q, k, v)
    B, T, H, D = q.shape
    rep = H // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs = (q.float() * scale).to(q.dtype)
    kx = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vx = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kx.float())
    if causal:
        vis = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), vx.float())
    o = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l))[..., 0]


def _check_kernel_args(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    if q.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"flash_attention launches on the current device "
                         f"cuda:{torch.cuda.current_device()}, tensors are "
                         f"on {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32, float16 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{_HEAD_DIMS}, got {q.shape[3]}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"flash_attention kernel needs {name} with a contiguous "
                f"head dim, 16-byte aligned rows and strides that are "
                f"multiples of {vec} elements; got strides {x.stride()}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with its log-sum-exp: ``(o [B, T, H, D], lse
    [B, H, T] float32)``; the LSE is what a backward pass needs."""
    _check_shapes(q, k, v)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check_kernel_args(q, k, v)
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = BUILDER.load()
    rc = lib.dstt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, T, H, k.shape[2], D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention, ``q [B, T, H, D] -> [B, T, H, D]`` (see
    :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
