"""Groupwise int8 weight storage for inference.

Counterpart of ``deepspeed_tpu/module_inject/quantize.py``. A quantized
weight is the node

    {"q": int8 [original shape], "scale": f32 [shape[:-1] + (1,)]}

with symmetric absmax scales, one per group of ``group_size`` rows of the
weight viewed as ``[prod(shape[:-1]), C]`` (repeated to one per row), or,
with per-output-channel scales for w8a8 (:func:`quantize_weight_out`),

    {"q": int8, "oscale": f32 with 1s on the contracted dims}.

The projections of ``model_implementations/transformer.py`` read either
through ``ops/int8_gemm.py``. The values are JAX's bit for bit: the same
f32 division, rounding half to even (``np.rint``, ``torch.round``) and
clip. Quantization runs with torch where the weight lies, so a model on
the card quantizes there.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from deepspeed_tpu_torch.ops.int8_gemm import is_quantized, weight_as


def quantize_weight(w, group_size: int = 64, num_bits: int = 8
                    ) -> Dict[str, Any]:
    """Symmetric groupwise quantization → ``{"q", "scale"}``. For a weight
    of rank 3 or more (attention ``[E, H, D]``, stacked experts) the group
    size is clipped to divide the rows of one dim-0 slice, so no group
    straddles two slices."""
    if is_quantized(w):
        return w
    qmax = float(2 ** (num_bits - 1) - 1)
    w32 = torch.as_tensor(w).float()
    shape = tuple(w32.shape)
    rows = math.prod(shape[:-1])
    slice_rows = math.prod(shape[1:-1]) if w32.ndim >= 3 else rows
    g = max(1, min(group_size, slice_rows))
    while slice_rows % g:
        g -= 1
    flat = w32.reshape(rows // g, g, shape[-1])
    absmax = flat.abs().amax(dim=(1, 2), keepdim=True)
    scale_g = torch.clamp_min(absmax, 1e-12) / qmax          # [G, 1, 1]
    q = torch.clamp(torch.round(flat / scale_g), -qmax - 1, qmax)
    scale = scale_g[:, 0, 0].repeat_interleave(g).reshape(shape[:-1] + (1,))
    return {"q": q.reshape(shape).to(torch.int8), "scale": scale}


def dequantize_weight(qw, dtype=torch.float32):
    """A quantized node as ``q.to(dtype) * scale.to(dtype)``; anything
    else unchanged."""
    return weight_as(qw, dtype) if is_quantized(qw) else qw


def quantize_weight_out(w, contract_dims, num_bits: int = 8
                        ) -> Dict[str, Any]:
    """Per-output-channel symmetric quantization → ``{"q", "oscale"}``:
    ``oscale`` has 1s on ``contract_dims`` (the dims the consuming GEMM
    sums over), so the dequant factors out of the contraction."""
    if is_quantized(w):
        return w
    qmax = float(2 ** (num_bits - 1) - 1)
    w32 = torch.as_tensor(w).float()
    absmax = w32.abs().amax(dim=tuple(contract_dims), keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / qmax
    q = torch.clamp(torch.round(w32 / scale), -qmax - 1, qmax)
    return {"q": q.to(torch.int8), "oscale": scale}


class GroupQuantizer:
    """Quantizes the attention, MLP and expert weight matrices of an
    inference param tree to int8 storage. Embeddings, biases, norms and
    the LM head stay in the activation dtype."""

    def __init__(self, q_int8: bool = True, num_bits: int = 8,
                 group_size: int = 64, out_mode: bool = False):
        """``out_mode``: per-output-channel scales (``{"q", "oscale"}``),
        so every projection, attention included, takes the int8 GEMM —
        used when w8a8 compute is on. Otherwise row-group scales."""
        self.q_int8 = q_int8
        self.num_bits = num_bits
        self.group_size = group_size
        self.out_mode = out_mode

    def quantize(self, w, contract_dims=(0,)):
        if not self.q_int8:
            return w
        if self.out_mode:
            return quantize_weight_out(w, contract_dims, self.num_bits)
        return quantize_weight(w, self.group_size, self.num_bits)

    def quantize_tree(self, params):
        if not self.q_int8:
            return params

        def attn_contract(k, v):
            # wo [H, D, E] contracts heads x head_dim; wq/wk/wv [E, H, D]
            # (or 2-D) the embedding dim
            ndim = getattr(v, "ndim", 0)
            return (0, 1) if (k == "wo" and ndim == 3) else (0,)

        out = dict(params)
        out["layers"] = []
        for layer in params["layers"]:
            new = dict(layer)
            new["attn"] = {
                k: (self.quantize(v, attn_contract(k, v))
                    if k.startswith("w") else v)
                for k, v in layer["attn"].items()}
            if "mlp" in layer:
                new["mlp"] = {
                    k: (self.quantize(v) if k.startswith("w") else v)
                    for k, v in layer["mlp"].items()}
            if "moe" in layer:
                ex = layer["moe"]["experts"]
                new["moe"] = {
                    "gate": layer["moe"]["gate"],
                    "experts": {
                        # stacked experts [X, E, F]: X batches, E contracts
                        k: (self.quantize(v, (1,)) if k.startswith("w")
                            else v)
                        for k, v in ex.items()}}
            out["layers"].append(new)
        return out


def tree_weight_bytes(params) -> int:
    """Total bytes of every tensor leaf."""
    if isinstance(params, dict):
        return sum(tree_weight_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_weight_bytes(v) for v in params)
    t = torch.as_tensor(params)
    return t.numel() * t.element_size()
