"""Load-time weight quantization for inference checkpoints.

Counterpart of ``deepspeed_tpu/runtime/weight_quantizer.py``
(``WeightQuantization``, after the reference's
``deepspeed/runtime/weight_quantizer.py``): the policy of which leaves of a
converted param tree quantize to int8 storage (``{"q", "scale"}``,
``module_inject/quantize.py``) — GEMM weights of rank 2 or more above a
size floor, never norms, biases or embeddings by name — and at what group
size. Paths are ``/``-joined dict keys and list indices, visited in JAX's
pytree order (sorted keys), so ``quantized_paths`` lists the same paths in
the same order as the JAX package's.
"""
from __future__ import annotations

import fnmatch
from typing import Any, Sequence

import torch

from deepspeed_tpu_torch.module_inject.quantize import (dequantize_weight,
                                                        quantize_weight)
from deepspeed_tpu_torch.ops.int8_gemm import is_quantized

_NEVER = ("*norm*", "*ln_*", "*bias*", "*scale*", "*embed*", "*wte*",
          "*wpe*", "*position*")


class WeightQuantization:
    """``WeightQuantization(mlp_extra_grouping=...)``: MLP weights (paths
    matching ``*mlp*``) get twice the group size when
    ``mlp_extra_grouping`` is on."""

    def __init__(self, mlp_extra_grouping: bool = True,
                 quantize_groups: int = 64, num_bits: int = 8,
                 min_size: int = 4096,
                 skip_patterns: Sequence[str] = _NEVER):
        self.mlp_extra_grouping = mlp_extra_grouping
        self.quantize_groups = quantize_groups
        self.num_bits = num_bits
        self.min_size = min_size
        self.skip_patterns = tuple(skip_patterns)
        self.quantized_paths: list = []

    def _should_quantize(self, path: str, leaf) -> bool:
        # an already quantized node is one leaf and stays as it is (the
        # JAX package's pytree walk would descend into it and requantize
        # a large ``q``)
        if is_quantized(leaf):
            return False
        if getattr(leaf, "ndim", 0) < 2 or leaf.numel() < self.min_size:
            return False
        return not any(fnmatch.fnmatch(path, p)
                       for p in self.skip_patterns)

    def model_quantize(self, params: Any) -> Any:
        """Quantize the GEMM weights of a converted param tree."""
        def walk(node, path):
            if isinstance(node, dict) and not is_quantized(node):
                out = {k: walk(node[k], path + (str(k),))
                       for k in sorted(node)}
                return {k: out[k] for k in node}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, path + (str(i),))
                                  for i, v in enumerate(node))
            name = "/".join(path)
            if not self._should_quantize(name, node):
                return node
            groups = self.quantize_groups
            if self.mlp_extra_grouping and fnmatch.fnmatch(name, "*mlp*"):
                groups *= 2
            self.quantized_paths.append(name)
            return quantize_weight(node, group_size=groups,
                                   num_bits=self.num_bits)
        return walk(params, ())

    @staticmethod
    def dequantize(leaf, dtype=None):
        return dequantize_weight(leaf, dtype or torch.float32)
