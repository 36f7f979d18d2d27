"""Fused LayerNorm (+ optional residual add) with its backward —
hand-written CUDA kernels for Hopper.

Counterpart of ``deepspeed_tpu/ops/pallas/layer_norm.py``: the Pallas
kernels ``_ln_fwd_kernel`` (:28, B9) and ``_ln_bwd_kernel`` (:41, B10) are
``layer_norm_fwd`` and ``layer_norm_bwd`` here, both in
``ops/csrc/layer_norm.cu`` (the source's note gives their design and what
bounds them on the H100), and the ``custom_vjp`` ``fused_layer_norm`` (:121)
is :class:`FusedLayerNormFunction`.

Numerics are the TPU kernels': ``x`` is ``[..., N]`` normalised over the
last dim with f32 statistics and a two-pass variance ``mean((x -
mean)^2)``; the output and ``dx`` are in ``x``'s dtype; ``mean`` / ``rstd``
are f32 ``[R, 1]``; ``dw`` / ``db`` are summed in f32 and cast to the
weight's dtype.

On CPU tensors the wrappers run their plain versions; on CUDA tensors they
launch their kernels or raise. Each counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import (CUDAOpBuilder, check_launch,
                                               sm_count)

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BWD_THREADS = 256   # a block of B10 (BWD_THREADS in layer_norm.cu)
_BWD_MIN_ROWS = 8    # rows a block of B10 takes at least, where R allows
# B10's grid-barrier counters, one pair per stream (the kernel leaves them 0)
_BWD_BARRIERS = {}


def _bind(lib: ctypes.CDLL) -> None:
    lib.dstt_layer_norm_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.dstt_layer_norm_fwd.restype = ctypes.c_int
    lib.dstt_layer_norm_bwd.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.dstt_layer_norm_bwd.restype = ctypes.c_int


BUILDER = CUDAOpBuilder("layer_norm", _bind)


def layer_norm_reference(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Numerics oracle (the JAX package's ``layer_norm_reference``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    return (xhat * weight.float() + bias.float()).to(x.dtype)


def layer_norm_fwd_reference(x2, weight, bias, eps):
    """Plain version of B9: ``(o [R, N], mean [R, 1], rstd [R, 1])``."""
    x = x2.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    o = (x - mean) * rstd * weight.float() + bias.float()
    return o.to(x2.dtype), mean, rstd


def layer_norm_bwd_reference(x2, weight, mean, rstd, g2):
    """Plain version of B10: ``(dx [R, N], dw [N], db [N])``, dw and db in
    f32."""
    x, g, w = x2.float(), g2.float(), weight.float()
    xhat = (x - mean) * rstd
    gw = g * w
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = (rstd * (gw - m1 - xhat * m2)).to(x2.dtype)
    return dx, (g * xhat).sum(0), g.sum(0)


def _check_rows(name, x2, weight, *more):
    if x2.dim() != 2 or weight.shape != (x2.shape[1],) \
            or any(m.shape != (x2.shape[1],) for m in more):
        raise ValueError(f"{name} wants x [R, N] and weights [N], got "
                         f"{tuple(x2.shape)}, {tuple(weight.shape)}, "
                         f"{[tuple(m.shape) for m in more]}")
    if x2.shape[0] < 1 or x2.shape[1] < 1:
        raise ValueError(f"{name} needs R >= 1 and N >= 1, got "
                         f"{tuple(x2.shape)}")


def _kernel_args(name, x2, rows, weights):
    """Check what the kernels take; returns the weights as contiguous f32
    and whether 16-byte loads apply (``N`` a multiple of 16 bytes, every
    row tensor 16-byte aligned)."""
    dev = x2.device
    if dev.type != "cuda" or any(t.device != dev for t in rows + weights):
        raise ValueError(f"{name} runs on cuda or cpu tensors, all on one "
                         f"device; got {[str(t.device) for t in rows]}")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name} launches on the current device "
                         f"cuda:{torch.cuda.current_device()}, tensors are on "
                         f"{dev}")
    if x2.dtype not in _DTYPE_CODE or any(t.dtype != x2.dtype for t in rows):
        raise TypeError(f"{name} kernel takes float32, float16 or bfloat16 "
                        f"rows of one dtype, got {[t.dtype for t in rows]}")
    for t in rows:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous [R, N] rows, "
                             f"got strides {t.stride()}")
    vec = (x2.shape[1] * x2.element_size() % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in rows))
    return [w.float().contiguous() for w in weights], vec


def layer_norm_fwd(x2, weight, bias, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B9: x ``[R, N]`` → ``(o [R, N] in x's dtype, mean [R, 1] f32,
    rstd [R, 1] f32)``."""
    _check_rows("layer_norm_fwd", x2, weight, bias)
    if all(t.device.type == "cpu" for t in (x2, weight, bias)):
        return layer_norm_fwd_reference(x2, weight, bias, eps)
    o = torch.empty_like(x2, memory_format=torch.contiguous_format)
    (w, b), vec = _kernel_args("layer_norm_fwd", x2, [x2, o], [weight, bias])
    R, N = x2.shape
    mean = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    lib = BUILDER.load()
    rc = lib.dstt_layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), R, N, float(eps), int(vec),
        _DTYPE_CODE[x2.dtype],
        torch.cuda.current_stream(x2.device).cuda_stream)
    check_launch(lib, "layer_norm_fwd", rc)
    layer_norm_fwd.launches += 1
    return o, mean, rstd


layer_norm_fwd.launches = 0


def _bwd_partition(R: int, N: int, elem: int, vec: bool,
                   device: torch.device) -> Tuple[int, bool]:
    """(P, ring) of B10: P persistent blocks, block p over rows [R p / P,
    R (p + 1) / P), at least 8 rows each where R allows (fewer partial
    rows to merge); ``ring`` when the ring kernel takes the rows (rows of
    16-byte chunks, at most 4 x 256 of them, ``vec``): two blocks an SM
    (one where a thread holds 4 chunks), else the wide kernel: one block
    of 512 threads an SM. Fixed for a card and shape, so the sums are
    too."""
    chunks = N * elem // 16
    ring = vec and chunks <= 4 * _BWD_THREADS
    per_sm = 2 if ring and chunks <= 2 * _BWD_THREADS else 1
    return min(-(-R // _BWD_MIN_ROWS), per_sm * sm_count(device)), ring


def layer_norm_bwd(x2, weight, mean, rstd, g2
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B10: from B9's ``mean`` / ``rstd`` and the output gradient ``g2``,
    ``(dx [R, N] in x's dtype, dw [N] f32, db [N] f32)``."""
    _check_rows("layer_norm_bwd", x2, weight)
    R, N = x2.shape
    if g2.shape != x2.shape or mean.shape != (R, 1) or rstd.shape != (R, 1):
        raise ValueError(f"layer_norm_bwd wants g {tuple(x2.shape)} and "
                         f"mean/rstd [{R}, 1], got {tuple(g2.shape)}, "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}")
    if all(t.device.type == "cpu" for t in (x2, weight, mean, rstd, g2)):
        return layer_norm_bwd_reference(x2, weight, mean, rstd, g2)
    dx = torch.empty_like(x2, memory_format=torch.contiguous_format)
    (w,), vec = _kernel_args("layer_norm_bwd", x2, [x2, g2, dx], [weight])
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x2.device):
            raise ValueError(f"layer_norm_bwd needs B9's {name}, a contiguous "
                             f"float32 [R, 1] tensor on {x2.device}; got "
                             f"{t.dtype} on {t.device}")
    P, ring = _bwd_partition(R, N, x2.element_size(), vec, x2.device)
    # the wide kernel reads rows that are no whole 16-byte chunks by aligned
    # loads, where every row tensor starts on 16 bytes
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, g2, dx))
    # partial rows of N rounded up to 4 floats (16-byte rows for the merge)
    part = torch.empty((2, P, -(-N // 4) * 4), dtype=torch.float32,
                       device=x2.device)
    stats = None if ring else torch.empty((R, 2), dtype=torch.float32,
                                          device=x2.device)
    dw = torch.empty(N, dtype=torch.float32, device=x2.device)
    db = torch.empty(N, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    bar = _BWD_BARRIERS.get(stream)
    if bar is None:
        bar = _BWD_BARRIERS[stream] = torch.zeros(2, dtype=torch.int32,
                                                  device=x2.device)
    lib = BUILDER.load()
    rc = lib.dstt_layer_norm_bwd(
        x2.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        g2.data_ptr(), dx.data_ptr(), part.data_ptr(),
        None if stats is None else stats.data_ptr(), bar.data_ptr(),
        dw.data_ptr(), db.data_ptr(), R, N, P, int(aligned),
        _DTYPE_CODE[x2.dtype], stream)
    check_launch(lib, "layer_norm_bwd", rc)
    layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_bwd.launches = 0


class FusedLayerNormFunction(torch.autograd.Function):
    """Differentiable fused LayerNorm (the JAX package's ``custom_vjp``
    ``fused_layer_norm``, ``layer_norm.py:121``): the forward runs B9 and
    saves ``(x2, weight, mean, rstd)``, the backward runs B10. ``eps`` is
    not differentiable. ``apply(x, weight, bias, eps)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        o, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.shape = shape
        return o.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, weight, mean, rstd = ctx.saved_tensors
        g2 = g.reshape(x2.shape).contiguous()
        dx, dw, db = layer_norm_bwd(x2, weight, mean, rstd, g2)
        return (dx.reshape(ctx.shape), dw.to(weight.dtype),
                db.to(weight.dtype), None)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, f32 statistics. x: [..., N]."""
    return FusedLayerNormFunction.apply(x, weight, bias, eps)


def fused_residual_layer_norm(x, residual, weight, bias, eps: float = 1e-5):
    """(x + residual) then LayerNorm: returns ``(normed, x + residual)`` so
    the caller can carry the pre-norm residual stream."""
    s = x + residual
    return fused_layer_norm(s, weight, bias, eps), s
