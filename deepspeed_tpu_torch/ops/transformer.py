"""The BERT-style training transformer layer.

Counterpart of ``deepspeed_tpu/ops/transformer.py`` (the reference's
``DeepSpeedTransformerLayer``, its flagship training kernel): the layer's
contract, meaning its parameter set, the pre-LN and post-LN orderings and
the dropout placement, as a functional layer over a dict of weights. The
work the reference fuses by hand (bias and GELU into the FFN GEMM, the
residual into the projection, the f32 LayerNorm) is plain torch here, as
the JAX package leaves it to XLA; the attention core of the unmasked case
is the flash kernels.

Routing is the JAX layer's: with no mask, no attention dropout and
``T <= 128 or T % 128 == 0`` the attention runs non-causal through
:class:`~deepspeed_tpu_torch.ops.flash_attention.FlashAttentionFunction`
(B1 forward, B2 and B3 backward on the card); otherwise through a plain
einsum with an f32 softmax and the key mask at -1e30.

Dropout is not ported (ROADMAP.md queue C, A9): where it would really be
applied (not deterministic, a rate above 0 and an ``rng`` given) the layer
raises ``NotImplementedError``; with ``rng=None``, as the port's engine
calls a ``loss_fn``, it is never applied, as in the JAX layer.

Under a ``tensor`` mesh axis (the model's ``tp_specs``) a layer holds its
heads of the fused ``attn_qkvw`` / ``attn_qkvb`` (its heads of q, of k and
of v), its columns of ``inter_w`` and its rows of ``attn_ow`` and
``output_w``; the inputs of the column-parallel products are copied to
the group, and the row-parallel products are summed over it before
``attn_ob`` / ``output_b`` are added, once (``parallel/
tensor_parallel.py``). Under a ``seq`` axis the layer holds its block of
the positions and attention gathers q/k/v along T.

Parameter schema (names mirror the reference's attributes)::

    attn_qkvw [E, 3E]  attn_qkvb [3E]
    attn_ow   [E, E]   attn_ob   [E]
    attn_nw/attn_nb    [E]           attention LayerNorm
    inter_w   [E, F]   inter_b   [F]
    output_w  [F, E]   output_b  [E]
    norm_w/norm_b      [E]           FFN LayerNorm
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.flash_attention import FlashAttentionFunction
from deepspeed_tpu_torch.ops.int8_training import switchback_matmul
from deepspeed_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                          reduce_from_group,
                                                          seq_attention)
from deepspeed_tpu_torch.utils.unported import not_ported

_DROPOUT = (not_ported("training dropout", "A9")
            + ": pass rng=None, deterministic=True or dropout ratios of 0")


def layer_norm_fp32(x, scale, bias, eps):
    """LayerNorm with f32 statistics (two-pass variance), output in the
    input's dtype: the training stack's one implementation."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def matmul(x, w):
    """``x @ w`` at the promoted dtype of the two (jnp's ``@``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


@dataclasses.dataclass(frozen=True)
class DeepSpeedTransformerConfig:
    """The reference's config surface (``transformer.py:38``)."""
    batch_size: int = -1                  # API parity; shapes come from x
    hidden_size: int = 768
    intermediate_size: Optional[int] = None
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1                  # API parity
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False    # memory trick subsumed by remat
    gelu_checkpoint: bool = False         # ditto
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False         # no-op: no stochastic kernels
    return_tuple: bool = False
    training: bool = True
    # SwitchBack int8 projections (ops/int8_training.py)
    int8_training: bool = False

    @property
    def ffn(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def dtype(self):
        return torch.bfloat16 if self.fp16 else torch.float32


class DeepSpeedTransformerLayer:
    """Functional encoder layer: ``init(generator) -> params``;
    ``apply(params, x, attention_mask=None, rng=None) -> y``."""

    layer_id = 0

    def __init__(self, config: DeepSpeedTransformerConfig):
        self.config = config
        self.layer_id = DeepSpeedTransformerLayer.layer_id
        DeepSpeedTransformerLayer.layer_id += 1

    # -- params -----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Weights in the layer's dtype on ``generator.device``: normal
        projections (the output ones at ``std / sqrt(2 L)`` when
        ``adjust_init_range``), zero biases, LayerNorms 1 and 0."""
        cfg = self.config
        E, Fh = cfg.hidden_size, cfg.ffn
        std = cfg.initializer_range
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std = std / math.sqrt(2.0 * cfg.num_hidden_layers)
        else:
            out_std = std
        dev, dt = generator.device, cfg.dtype

        def normal(shape, s):
            return (torch.randn(shape, generator=generator, device=dev)
                    * s).to(dt)

        def const(n, value):
            return torch.full((n,), value, dtype=dt, device=dev)
        return {
            "attn_qkvw": normal((E, 3 * E), std),
            "attn_qkvb": const(3 * E, 0.0),
            "attn_ow": normal((E, E), out_std),
            "attn_ob": const(E, 0.0),
            "attn_nw": const(E, 1.0),
            "attn_nb": const(E, 0.0),
            "inter_w": normal((E, Fh), std),
            "inter_b": const(Fh, 0.0),
            "output_w": normal((Fh, E), out_std),
            "output_b": const(E, 0.0),
            "norm_w": const(E, 1.0),
            "norm_b": const(E, 0.0),
        }

    @staticmethod
    def from_torch_layout(qkvw, qkvb, ow, ob, attn_nw, attn_nb, inter_w,
                          inter_b, output_w, output_b, norm_w, norm_b,
                          dtype=torch.float32) -> Dict[str, Any]:
        """Reference/torch ``[out, in]`` tensors (or arrays) → this
        layer's params: contiguous copies in ``dtype``."""
        def t(a, transpose=False):
            a = torch.as_tensor(a).detach()
            a = a.t() if transpose else a
            return torch.empty(a.shape, dtype=dtype,
                               device=a.device).copy_(a)
        return {"attn_qkvw": t(qkvw, True), "attn_qkvb": t(qkvb),
                "attn_ow": t(ow, True), "attn_ob": t(ob),
                "attn_nw": t(attn_nw), "attn_nb": t(attn_nb),
                "inter_w": t(inter_w, True), "inter_b": t(inter_b),
                "output_w": t(output_w, True), "output_b": t(output_b),
                "norm_w": t(norm_w), "norm_b": t(norm_b)}

    # -- forward ----------------------------------------------------------
    def _ln(self, x, w, b):
        return layer_norm_fp32(x, w, b, self.config.layer_norm_eps)

    def _mm(self, x, w):
        """The projection GEMM: SwitchBack when the config opts in."""
        if self.config.int8_training:
            return switchback_matmul(x, w)
        return matmul(x, w)

    @staticmethod
    def _dropout(x, rate, rng, deterministic):
        if deterministic or rate <= 0.0 or rng is None:
            return x
        raise NotImplementedError(_DROPOUT)

    def _split(self, split: bool):
        """Refuses SwitchBack on a split product (its per-token amax
        would be a rank's); whether the product is split."""
        if split and self.config.int8_training:
            raise NotImplementedError(not_ported(
                "int8_training (SwitchBack) with a tensor axis"))
        return split

    def _attention(self, x, params, attention_mask, rng, deterministic):
        cfg = self.config
        B, T, E = x.shape
        D = E // cfg.heads
        # the rank's heads of q, k and v under tensor (E of them whole)
        El = params["attn_qkvw"].shape[1] // 3
        split = self._split(El < E)
        if split:
            x = copy_to_group(x)
        qkv = self._mm(x, params["attn_qkvw"]) + params["attn_qkvb"]
        # views of the fused projection: the kernels read them in place
        q, k, v = (t.reshape(B, T, El // D, D)
                   for t in qkv.split(El, dim=-1))
        if (not deterministic and cfg.attn_dropout_ratio > 0.0
                and rng is not None):
            raise NotImplementedError(_DROPOUT)
        y = seq_attention(self._core, q, k, v, attention_mask)
        out = self._mm(y.reshape(B, T, El), params["attn_ow"])
        if split:
            out = reduce_from_group(out)
        return out + params["attn_ob"]

    @staticmethod
    def _core(q, k, v, attention_mask):
        """Attention over the whole sequence: flash with no mask and a T
        its tiles take, else the plain einsum."""
        T, D = q.shape[1], q.shape[-1]
        need_mask = attention_mask is not None
        if not need_mask and (T <= 128 or T % 128 == 0):
            y = FlashAttentionFunction.apply(q, k, v, False,
                                             1.0 / math.sqrt(D))
        else:
            # the scale rounded to the compute dtype, as jnp's weak float
            scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype,
                                 device=q.device)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            if need_mask:
                m = attention_mask
                if m.dim() == 2:           # [B, T] HF key mask
                    m = m[:, None, None, :]
                att = torch.where(m > 0, att.float(), -1e30)
            att = torch.softmax(att.float(), -1).to(q.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return y

    def _ffn(self, h, params):
        cfg = self.config
        split = self._split(params["inter_w"].shape[1] < cfg.ffn)
        if split:   # the rank's columns of the hidden units
            h = copy_to_group(h)
        ffn = F.gelu((self._mm(h, params["inter_w"]) + params["inter_b"]
                      ).float()).to(cfg.dtype)
        out = self._mm(ffn, params["output_w"])
        if split:
            out = reduce_from_group(out)
        return out + params["output_b"]

    def apply(self, params: Dict[str, Any], x, attention_mask=None,
              rng=None, deterministic: Optional[bool] = None):
        """x ``[B, T, E]`` → ``[B, T, E]``; BERT's orderings per
        ``pre_layer_norm`` (reference ``DeepSpeedTransformerFunction``)."""
        cfg = self.config
        det = (not cfg.training) if deterministic is None else deterministic
        rate = cfg.hidden_dropout_ratio
        x = x.to(cfg.dtype)
        if cfg.pre_layer_norm:
            h = self._ln(x, params["attn_nw"], params["attn_nb"])
            attn = self._attention(h, params, attention_mask, rng, det)
            x = x + self._dropout(attn, rate, rng, det)
            h = self._ln(x, params["norm_w"], params["norm_b"])
            out = x + self._dropout(self._ffn(h, params), rate, rng, det)
        else:  # post-LN (original BERT)
            attn = self._attention(x, params, attention_mask, rng, det)
            x = self._ln(x + self._dropout(attn, rate, rng, det),
                         params["attn_nw"], params["attn_nb"])
            ffn = self._dropout(self._ffn(x, params), rate, rng, det)
            out = self._ln(x + ffn, params["norm_w"], params["norm_b"])
        if cfg.return_tuple:
            return (out,)
        return out

    __call__ = apply
