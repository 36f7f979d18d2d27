"""Flash attention, forward and backward — hand-written CUDA kernels for
Hopper.

Replaces the Pallas kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` (:65, in ``ops/csrc/flash_attention_fwd.cu``) and the two
backward kernels ``_bwd_dq_kernel`` (:167) and ``_bwd_dkv_kernel`` (:215,
both in ``ops/csrc/flash_attention_bwd.cu``), with the ``custom_vjp``
(:363) as :class:`FlashAttentionFunction`. The source notes give each
kernel's design and what bounds it on the H100.

Layout at the public functions is the JAX package's: q ``[B, T, H, D]``,
k/v ``[B, T, KH, D]`` with ``KH | H`` (grouped-query attention reads kv head
``h // (H // KH)``, nothing is repeated). Unlike the TPU kernel, any
``T >= 1`` is taken: the kernel masks the ragged edge itself.

Head dims (:func:`~deepspeed_tpu_torch.ops.head_dim.head_dim_route`): the
forward and the backward take any ``D <= 256``. Where a row of ``D``
elements is whole 16-byte chunks (16-bit: ``D % 8 == 0``, f32: ``D % 4 ==
0``) the kernels run their 64-, 128- or 256-wide instantiation on the
tensors as they are, reading zeros past ``D`` and writing nothing there;
any other ``D`` (the padded route, correct and slow) zero-pads q, k, v, o
and dO to that width with one copy each and slices the results back. Every
kernel raises above 256 (fault D1c).

On a CPU tensor the functions run the plain PyTorch versions,
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`,
with the same numerics (scale folded into q, or into k for dk/dv, in the
storage dtype; P and dS rounded to the storage dtype before their products;
f32 accumulation). On a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.head_dim import (head_dim_route, pad_head_dim,
                                              unpad_head_dim)
from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder, check_launch

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.dstt_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_flash_attention_fwd.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    # dq reads q, k, v, o and dO (15 strides), dk/dv reads no o (12) and
    # takes the distance of the lse and delta rows; each takes 8 tensors and
    # the persistent kernel's tile counter
    for fn, n_ints, n_strides in ((lib.dstt_flash_attention_bwd_dq, 6, 15),
                                  (lib.dstt_flash_attention_bwd_dkv, 7, 12)):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int


BUILDER = CUDAOpBuilder("flash_attention_fwd", _bind)
BWD_BUILDER = CUDAOpBuilder("flash_attention_bwd", _bind_bwd)


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
    """Raise unless the kernels take q, k and v as they are (the callers
    take the padded route first, so the head dim needs no check here)."""
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
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _rows_ok(x):
            raise ValueError(
                f"flash_attention kernel needs {name} with a contiguous "
                f"head dim, 16-byte aligned rows and strides that are "
                f"multiples of {16 // x.element_size()} elements; got "
                f"strides {x.stride()}")


def _rows_ok(x: torch.Tensor) -> bool:
    """Contiguous head dim, 16-byte aligned rows: what the kernels'
    16-byte loads and their TMA tensor maps (base and strides multiples of
    16 bytes) need."""
    vec = 16 // x.element_size()
    return (x.stride(3) == 1 and not any(s % vec for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with its log-sum-exp: ``(o [B, T, H, D], lse
    [B, H, T] float32)``; the LSE is what a backward pass needs."""
    _check_shapes(q, k, v)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    DK, pad = head_dim_route(D, q.element_size())
    if pad:   # the padded route: one zero-padded copy of each operand
        o, lse = flash_attention_fwd(*(pad_head_dim(x, DK) for x in (q, k, v)),
                                     causal, scale)
        return unpad_head_dim(o, D), lse
    _check_kernel_args(q, k, v)
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    # the counter the persistent 16-bit kernel hands its tiles out with
    next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)
    lib = BUILDER.load()
    rc = lib.dstt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), next_tile.data_ptr(), B, T, H, k.shape[2], DK, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale),
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


# ---------------------------------------------------------------- backward

def _group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """``[B, T, H, D]`` f32 per q head -> ``[B, T, KH, D]``: the sum over
    each GQA group, in f32 (the TPU kernel's scratch carry)."""
    B, T, H, D = x.shape
    return x.reshape(B, T, kv_heads, H // kv_heads, D).sum(3)


def _scores(a, b, causal, lse):
    """``exp(a.b^T - lse)`` in f32 as ``[B, H, T, T]`` (query rows), with
    masked scores at -1e30 as in the TPU kernels."""
    s = torch.einsum("bqhd,bkhd->bhqk", a.float(), b.float())
    if causal:
        T = a.shape[1]
        vis = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
        s = s.masked_fill(~vis, -1e30)
    return torch.exp(s - lse[..., None])


def _expand_kv(x, heads):
    rep = heads // x.shape[2]
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def _bwd_dq_reference(q, k, v, o, lse, do, causal, scale):
    """Plain version of B2 (with the delta it computes): ``(dq [B, T, H,
    D], delta [B, H, T] f32)``."""
    H = q.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    qs = (q.float() * scale).to(q.dtype)
    kx, vx = _expand_kv(k, H), _expand_kv(v, H)
    p = _scores(qs, kx, causal, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vx.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx.float())
    return (dq * scale).to(q.dtype), delta


def _bwd_dkv_reference(q, k, v, lse, delta, do, causal, scale):
    """Plain version of B3: ``(dk, dv)``, each ``[B, T, KH, D]``."""
    H, KH = q.shape[2], k.shape[2]
    ks = (k.float() * scale).to(k.dtype)
    p = _scores(q, _expand_kv(ks, H), causal, lse)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(k.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      _expand_kv(v, H).float())
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return ((_group_sum(dk, KH) * scale).to(k.dtype),
            _group_sum(dv, KH).to(v.dtype))


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` from
    the forward's ``o`` and f32 ``lse [B, H, T]`` and the output gradient
    ``do``, with the numerics of the TPU kernels."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    dq, delta = _bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    dk, dv = _bwd_dkv_reference(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv


def _bwd_args(q, k, v, lse, do, o=None):
    """Check what the backward kernels take. ``do`` is copied to a
    contiguous tensor only when its head dim is not contiguous or its rows
    are not 16-byte aligned; q, k, v and o are read through their
    strides."""
    _check_shapes(q, k, v)
    _check_kernel_args(q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x is None:
            continue
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if o is not None and not _rows_ok(o):
        raise ValueError(f"flash_attention_bwd needs o with a contiguous "
                         f"head dim and 16-byte aligned rows; got strides "
                         f"{o.stride()}")
    if not _rows_ok(do):
        do = do.contiguous()
    B, T, H, _ = q.shape
    if (lse.shape != (B, H, T) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd needs the forward's lse, a "
                         f"contiguous float32 [B, H, T] = {(B, H, T)} "
                         f"tensor; got {tuple(lse.shape)} {lse.dtype}")
    return do


def _route(q, k, v):
    """``(kernel width, pad)`` of the head dim of q, k and v for the
    backward kernels."""
    _check_shapes(q, k, v)
    return head_dim_route(q.shape[3], q.element_size())


def _strides(*xs):
    """The (batch, time, head) strides of each tensor, in order."""
    return [s for x in xs for s in x.stride()[:3]]


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           scale: Optional[float] = None):
    """B2: ``(dq [B, T, H, D], delta [B, H, T] f32)``; ``delta =
    rowsum(do * o)`` is what :func:`flash_attention_bwd_dkv` takes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if all(x.device.type == "cpu" for x in (q, k, v, o, lse, do)):
        _check_shapes(q, k, v)
        return _bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    DK, pad = _route(q, k, v)
    if pad:   # the padded route: one zero-padded copy of each operand
        dq, delta = flash_attention_bwd_dq(
            *(pad_head_dim(x, DK) for x in (q, k, v, o)), lse,
            pad_head_dim(do, DK), causal, scale)
        return unpad_head_dim(dq, q.shape[3]), delta
    do = _bwd_args(q, k, v, lse, do, o)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)
    lib = BWD_BUILDER.load()
    rc = lib.dstt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        next_tile.data_ptr(), B, T, H, k.shape[2], DK, D,
        *_strides(q, k, v, o, do), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "flash_attention_bwd_dq", rc)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = True,
                            scale: Optional[float] = None):
    """B3: ``(dk, dv)``, each ``[B, T, KH, D]``, summed over each GQA
    group; ``delta`` comes from :func:`flash_attention_bwd_dq`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if all(x.device.type == "cpu" for x in (q, k, v, lse, delta, do)):
        _check_shapes(q, k, v)
        return _bwd_dkv_reference(q, k, v, lse, delta, do, causal, scale)
    DK, pad = _route(q, k, v)
    if pad:   # the padded route: one zero-padded copy of each operand
        res = flash_attention_bwd_dkv(
            *(pad_head_dim(x, DK) for x in (q, k, v)), lse, delta,
            pad_head_dim(do, DK), causal, scale)
        return tuple(unpad_head_dim(r, q.shape[3]) for r in res)
    do = _bwd_args(q, k, v, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 \
            or not delta.is_contiguous() or delta.device != q.device:
        raise ValueError(f"flash_attention_bwd_dkv needs delta like lse, a "
                         f"contiguous float32 {tuple(lse.shape)} tensor; got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    B, T, H, D = q.shape
    KH = k.shape[2]
    # the 16-bit kernel reads lse and delta rows by TMA, whose rows start
    # on 16 bytes: a ragged T gets rows padded to a multiple of 4
    ld = T if q.dtype == torch.float32 else -(-T // 4) * 4
    if ld != T:
        pad = torch.nn.functional.pad
        lse, delta = pad(lse, (0, ld - T)), pad(delta, (0, ld - T))
    dk = torch.empty((B, T, KH, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, KH, D), dtype=v.dtype, device=q.device)
    next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)
    lib = BWD_BUILDER.load()
    rc = lib.dstt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        next_tile.data_ptr(), B, T, H, KH, DK, D, ld,
        *_strides(q, k, v, do), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, "flash_attention_bwd_dkv", rc)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """Attention backward, ``(dq, dk, dv)``: B2 then B3 on one stream (B3
    reads the delta B2 writes)."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the TPU package's ``custom_vjp``,
    ``flash_attention.py:363``): the forward kernel saves ``(q, k, v, o,
    lse)``, the backward runs B2 and B3. ``apply(q, k, v, causal,
    scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None
