"""int8 x int8 GEMMs (w8a8) over int8-stored weights, for inference.

Counterpart of ``deepspeed_tpu/ops/int8_gemm.py``. A quantized weight is a
node ``{"q": int8, "scale": f32}`` (row-group scales,
``module_inject/quantize.py:quantize_weight``) or ``{"q": int8, "oscale":
f32}`` (per-output-channel scales, ``quantize_weight_out``). Without w8a8
a projection dequantizes the weight into the activation dtype
(:func:`weight_as`) and multiplies as before. With it the product runs on
int8 operands with an exact int32 accumulator:

    y = x @ (q * s)  with per-row scales s[k]
      = sum_k (x[k] * s[k]) * q[k, j]         fold s into the activation
      ~ sz * sum_k z_q[k] * q[k, j]           one dynamic per-row quant

for row-group leaves (:func:`int8_matmul`, 2-D weights), and

    y = einsum(x, q * s_out) = einsum(x_q, q) * s_x * s_out

for ``oscale`` leaves (:func:`int8_einsum`, every projection); the
activation quant is ``ops/quant_core.py``'s ``quantize_int8``, the same
arithmetic as JAX's inline one. The JAX
package leaves the int32 contraction to XLA; here it is
``torch._int_mm`` (:func:`int8_mm`), a library product as ``torch.matmul``
is for the 16-bit projections. On the card ``_int_mm`` takes more than 16
rows and a contraction and output width that are multiples of 8, and is
several times faster when its second operand is column-major: rows are
zero-padded up to 17 (a zero row quantizes to zero with scale 1), the
weights are stored column-major once, at placement
(:func:`int8_compute_layout`), and any other shape raises — it never
falls back to the dequantizing path.

A row-parallel product (``reduce``: the mesh axis its contraction is split
over) sums its partial products over that axis's group before the bias:
the dequantized product in the activation dtype, or, under w8a8, the int32
accumulators, exactly, after a per-row quant whose amax is the group's,
and the rescale after the sum, as the JAX package's GSPMD program
computes the split contraction.
"""
from __future__ import annotations

import math
from typing import Any

import functools
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.quant_core import quantize_int8
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.utils.unported import not_ported

INT_MM_MIN_ROWS = 17   # torch._int_mm on CUDA refuses 16 rows or fewer
INT_MM_MULTIPLE = 8    # ... and contraction or output widths off 8


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w


def weight_as(w, dtype):
    """A weight leaf in ``dtype``: a quantized node dequantized as JAX's
    ``dequantize_weight`` does, ``q.to(dtype) * scale.to(dtype)`` — the
    product rounded in ``dtype``, so a 16-bit weight rounds as JAX's."""
    if is_quantized(w):
        s = w["scale"] if "scale" in w else w["oscale"]
        return w["q"].to(dtype) * s.to(dtype)
    return w if w.dtype == dtype else w.to(dtype)


def _column_major(b: torch.Tensor) -> torch.Tensor:
    return b if b.stride(0) == 1 else b.t().contiguous().t()


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32``, exact. On the
    card through ``torch._int_mm`` (rows padded with zeros to
    ``INT_MM_MIN_ROWS``, ``b`` made column-major if it is not); on the CPU
    an int32 product."""
    M, K = a.shape
    N = b.shape[1]
    if not a.is_cuda:
        return torch.mm(a.int(), b.int())
    if K % INT_MM_MULTIPLE or N % INT_MM_MULTIPLE:
        raise ValueError(
            f"int8 GEMM [{M}, {K}] x [{K}, {N}]: torch._int_mm on CUDA "
            f"needs the contraction and output widths to be multiples of "
            f"{INT_MM_MULTIPLE}")
    a = a.contiguous()
    if M < INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - M, K)])
    return torch._int_mm(a, _column_major(b))[:M]


def _amax_reduce(reduce: Optional[str]):
    return None if reduce is None else functools.partial(
        comm.all_reduce, op=comm.MAX, axis_name=reduce)


def _sum(y: torch.Tensor, reduce: Optional[str]) -> torch.Tensor:
    return y if reduce is None else comm.all_reduce(y, comm.SUM, reduce)


def int8_matmul(x: torch.Tensor, qw: dict, out_dtype=None,
                reduce: Optional[str] = None) -> torch.Tensor:
    """``x [..., K] @ {"q": int8 [K, N], "scale": f32 [K, 1]}`` with the
    row scales folded into ``x`` before its one dynamic per-row quant."""
    q = qw["q"]
    if q.ndim != 2:
        raise ValueError(f"int8_matmul handles 2-D weights, got "
                         f"{tuple(q.shape)} (attention projections keep the "
                         "dequant path)")
    out_dtype = out_dtype or x.dtype
    K, N = q.shape
    z = x.float() * qw["scale"].float().reshape(K)
    zq, sz = quantize_int8(z, -1, _amax_reduce(reduce))
    y = _sum(int8_mm(zq.reshape(-1, K), q), reduce).reshape(
        *x.shape[:-1], N)
    return (y.float() * sz).to(out_dtype)


def _squeeze_leading_ones(shape):
    out = list(shape)
    while len(out) > 1 and out[0] == 1:
        out.pop(0)
    return tuple(out)


def _check_subscripts(subscripts: str, x_contract_ndim: int):
    """The einsum forms :func:`int8_einsum` takes: ``x``'s trailing
    ``x_contract_ndim`` labels are the weight's leading ones, and the
    output is ``x``'s leading labels then the weight's rest (q/k/v
    ``...e,ehd->...hd``, attention out ``...hd,hde->...e``, a 2-D GEMM
    ``...k,kn->...n``)."""
    ins, out = subscripts.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    c = x_contract_ndim
    if xs[-c:] != ws[:c] or out != xs[:-c] + ws[c:]:
        raise NotImplementedError(not_ported(
            f"int8 einsum {subscripts!r}: only x's trailing labels against "
            f"the weight's leading ones; the batched expert forms (MoE "
            f"layers)", verb="are"))


def int8_einsum(subscripts: str, x: torch.Tensor, qw: dict,
                x_contract_ndim: int, w_out_ndim: int,
                out_dtype, reduce: Optional[str] = None) -> torch.Tensor:
    """w8a8 einsum for an ``{"q", "oscale"}`` leaf: one dynamic per-token
    quant over ``x``'s ``x_contract_ndim`` trailing dims, the int8 product
    as one 2-D GEMM (``x`` as ``[M, K]``, ``q`` as ``[K, N]``), one f32
    rescale of the output by the token and output-channel scales.
    ``w_out_ndim``: output dims the weight contributes."""
    _check_subscripts(subscripts, x_contract_ndim)
    q, s = qw["q"], qw["oscale"]
    c = x_contract_ndim
    xq, sx = quantize_int8(x, tuple(range(x.ndim - c, x.ndim)),
                           _amax_reduce(reduce))
    lead, K = x.shape[:-c], math.prod(x.shape[-c:])
    y = _sum(int8_mm(xq.reshape(-1, K), q.reshape(K, -1)), reduce).reshape(
        *lead, *q.shape[c:])
    s = s.reshape(_squeeze_leading_ones(s.shape))
    sx_out = sx.reshape(lead + (1,) * w_out_ndim)
    return (y.float() * sx_out * s.float()).to(out_dtype)


def maybe_int8_einsum(subscripts: str, x: torch.Tensor, w: Any, dtype,
                      int8_compute: bool, x_contract_ndim: int,
                      w_out_ndim: int,
                      reduce: Optional[str] = None) -> torch.Tensor:
    """Attention projection seam: the int8 einsum for ``oscale`` leaves
    under w8a8; the dequantized einsum otherwise. ``reduce``: the axis a
    row-parallel contraction is split over."""
    if int8_compute and is_quantized(w) and "oscale" in w:
        return int8_einsum(subscripts, x, w, x_contract_ndim, w_out_ndim,
                           dtype, reduce)
    return _sum(torch.einsum(subscripts, x, weight_as(w, dtype)).to(dtype),
                reduce)


def maybe_int8_matmul(x: torch.Tensor, w: Any, dtype,
                      int8_compute: bool,
                      reduce: Optional[str] = None) -> torch.Tensor:
    """2-D GEMM seam: the int8 product when the leaf is quantized and w8a8
    is on; the dequantized matmul otherwise. ``reduce`` as in
    :func:`maybe_int8_einsum`."""
    if int8_compute and is_quantized(w):
        if "oscale" in w:
            return int8_einsum("...k,kn->...n", x, w, 1, 1, dtype, reduce)
        if w["q"].ndim == 2:
            return int8_matmul(x, w, out_dtype=dtype, reduce=reduce)
    return _sum((x @ weight_as(w, dtype)).to(dtype), reduce)


def int8_compute_layout(params):
    """``params`` with the ``q`` of every leaf an int8 GEMM reads stored
    column-major as the GEMM's ``[K, N]`` (the layout ``_int_mm`` is fast
    on): ``oscale`` leaves contract their leading size-1 dims, 2-D
    row-group leaves their first. Values are unchanged."""
    if is_quantized(params):
        q = params["q"]
        if "oscale" in params:
            c = len(params["oscale"].shape) - len(
                _squeeze_leading_ones(params["oscale"].shape))
        elif q.ndim == 2:
            c = 1
        else:
            return params
        K = math.prod(q.shape[:c])
        return {**params, "q": _column_major(q.reshape(K, -1)).view(
            q.shape)}
    if isinstance(params, dict):
        return {k: int8_compute_layout(v) for k, v in params.items()}
    if isinstance(params, list):
        return [int8_compute_layout(v) for v in params]
    return params
