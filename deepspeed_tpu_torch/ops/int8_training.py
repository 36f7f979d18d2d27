"""SwitchBack int8 training linear.

Counterpart of ``deepspeed_tpu/ops/int8_training.py`` (Wortsman et al.,
"Stable and low-precision training for large-scale vision-language
models", 2023), an ``autograd.Function`` where JAX has a ``custom_vjp``:

* forward ``y = (q(x) @ q(w)) * sx * sw``: per-token activation scales,
  per-output-column weight scales, an exact int32 product, one f32
  rescale;
* ``dx = (q(dy) @ q(w^T)) * sdy * swt``: per-token ``dy`` scales and one
  scale for the whole transposed weight (a per-column grid does not
  transpose);
* ``dw = x^T @ dy`` with f32 accumulation (16-bit operands enter the GEMM
  as they are: their products are exact in f32).

Gradients are cast back to the dtypes of ``x`` and ``w``, as JAX casts
them. The quantizer is ``ops/quant_core.py``'s; the int8 products are
``ops/int8_gemm.py``'s ``int8_mm`` (``torch._int_mm`` on the card).
The per-expert batched form (``switchback_batched_matmul``, a ``vmap``
used only by MoE experts) waits for the MoE slice.
"""
from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.int8_gemm import int8_mm
from deepspeed_tpu_torch.ops.quant_core import quantize_int8


def _int8_dot_last(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``[..., K] int8 @ [K, N] int8 -> [..., N] int32``."""
    K, N = qw.shape
    return int8_mm(qx.reshape(-1, K), qw).reshape(*qx.shape[:-1], N)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32, with an f32 result."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _SwitchBack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        qx, sx = quantize_int8(x, -1)
        qw, sw = quantize_int8(w, 0)
        y = _int8_dot_last(qx, qw).float() * sx * sw
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        K, N = w.shape
        qdy, sdy = quantize_int8(dy, -1)
        qwt, swt = quantize_int8(w.float().t(), None)
        dx = _int8_dot_last(qdy, qwt).float() * sdy * swt
        dw = _mm_f32(x.reshape(-1, K).t(), dy.reshape(-1, N))
        return dx.to(x.dtype), dw.to(w.dtype)


def switchback_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with int8 forward and dx and an
    f32-accumulated dw."""
    return _SwitchBack.apply(x, w)


def switchback_logits(x: torch.Tensor, w_vc: torch.Tensor) -> torch.Tensor:
    """``x [..., C] @ w_vc [V, C]^T -> [..., V]``: the vocabulary
    projection through SwitchBack, the weight in embedding layout."""
    return switchback_matmul(x, w_vc.t())


def lm_logits(x: torch.Tensor, w_vc: torch.Tensor, int8: bool
              ) -> torch.Tensor:
    """The vocabulary-projection seam: SwitchBack when int8 training is
    on, the plain product otherwise."""
    if int8:
        return switchback_logits(x, w_vc)
    return x @ w_vc.t()


def maybe_switchback(enabled: bool):
    """The product a Dense layer runs for a model config:
    :func:`switchback_matmul` when int8 training is on, ``torch.matmul``
    otherwise."""
    return switchback_matmul if enabled else torch.matmul
