"""Tiled linear layers: a huge projection as a grid of independent tiles.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (reference
``runtime/zero/tiling.py`` ``TiledLinear``). The weight is a grid of
separate leaves ``w_i_j [in_tile_i, out_tile_j]`` (and ``b_j``), so each
tile gets its own ZeRO-3 shard (``runtime/zero/partition.py``), and each
output tile's products run inside a checkpoint, so the backward pass
recomputes them instead of keeping every tile's activations.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """``num_items`` in ``num_parts`` contiguous ranges, the first
    ``num_items % num_parts`` one longer; returns the ``num_parts + 1``
    bounds (JAX ``parallel/pipe/module.py:64``)."""
    parts = [0] * (num_parts + 1)
    chunk, residual = divmod(num_items, num_parts)
    for p in range(1, num_parts + 1):
        parts[p] = parts[p - 1] + chunk + (1 if p <= residual else 0)
    return parts


def split_tensor_along_last_dim(tensor, num_partitions: int):
    """Even split along the last dim (Megatron helper parity)."""
    bounds = partition_uniform(tensor.shape[-1], num_partitions)
    return tuple(tensor[..., lo:hi]
                 for lo, hi in zip(bounds[:-1], bounds[1:]))


class TiledLinear:
    """``y = x @ W + b`` over an ``in_splits x out_splits`` tile grid.

    ``init(generator)`` builds the tiled param dict; ``apply(params, x)``
    runs the tiled product. ``combine_out_splits=False`` returns the list
    of output tiles; ``input_is_already_split=True`` takes a tuple of
    input tiles."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, in_splits: int = 1, out_splits: int = 1,
                 input_is_already_split: bool = False,
                 combine_out_splits: bool = True,
                 dtype: torch.dtype = torch.float32):
        if in_splits < 1 or out_splits < 1:
            raise ValueError("splits must be >= 1")
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.input_is_already_split = input_is_already_split
        self.combine_out_splits = combine_out_splits
        self.dtype = dtype
        self.in_bounds = partition_uniform(in_features, in_splits)
        self.out_bounds = partition_uniform(out_features, out_splits)

    def _tile_shape(self, i, j):
        return (self.in_bounds[i + 1] - self.in_bounds[i],
                self.out_bounds[j + 1] - self.out_bounds[j])

    # -- params ----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Dict[str, torch.Tensor]:
        """Normal tiles scaled by ``1/sqrt(in_features)``, zero biases."""
        scale = 1.0 / math.sqrt(self.in_features)
        params: Dict[str, torch.Tensor] = {}
        for i in range(self.in_splits):
            for j in range(self.out_splits):
                t = torch.randn(self._tile_shape(i, j), generator=generator,
                                device=device)
                params[f"w_{i}_{j}"] = (t * scale).to(self.dtype)
        if self.use_bias:
            for j in range(self.out_splits):
                params[f"b_{j}"] = torch.zeros(
                    self.out_bounds[j + 1] - self.out_bounds[j],
                    dtype=self.dtype, device=device)
        return params

    def from_dense(self, kernel, bias=None) -> Dict[str, torch.Tensor]:
        """Tile an existing dense ``[in, out]`` kernel (reference
        ``copy_params_from``)."""
        kernel = torch.as_tensor(kernel)
        if tuple(kernel.shape) != (self.in_features, self.out_features):
            raise ValueError(f"kernel {tuple(kernel.shape)} != "
                             f"({self.in_features}, {self.out_features})")
        params: Dict[str, torch.Tensor] = {}
        for i in range(self.in_splits):
            for j in range(self.out_splits):
                params[f"w_{i}_{j}"] = kernel[
                    self.in_bounds[i]:self.in_bounds[i + 1],
                    self.out_bounds[j]:self.out_bounds[j + 1]
                ].to(self.dtype).clone()
        if self.use_bias:
            if bias is None:
                raise ValueError("layer has bias=True but none given")
            bias = torch.as_tensor(bias)
            for j in range(self.out_splits):
                params[f"b_{j}"] = bias[
                    self.out_bounds[j]:self.out_bounds[j + 1]
                ].to(self.dtype).clone()
        return params

    # -- forward ---------------------------------------------------------
    def _out_tiles(self, params, x) -> List[torch.Tensor]:
        if self.input_is_already_split:
            xs: Tuple = tuple(x)
            if len(xs) != self.in_splits:
                raise ValueError(f"expected {self.in_splits} input tiles, "
                                 f"got {len(xs)}")
        else:
            xs = tuple(x[..., self.in_bounds[i]:self.in_bounds[i + 1]]
                       for i in range(self.in_splits))

        def product(*tiles):
            acc = xs[0] @ tiles[0]
            for i in range(1, self.in_splits):
                acc = acc + xs[i] @ tiles[i]
            return acc

        outs = []
        for j in range(self.out_splits):
            tiles = tuple(params[f"w_{i}_{j}"] for i in range(self.in_splits))
            # remat: the backward recomputes the tile's product instead of
            # keeping every tile's activations live
            if torch.is_grad_enabled():
                outs.append(checkpoint(product, *tiles, use_reentrant=False))
            else:
                outs.append(product(*tiles))
        return outs

    def apply(self, params: Dict[str, torch.Tensor], x):
        outs = self._out_tiles(params, x)
        if self.use_bias:
            outs = [o + params[f"b_{j}"] for j, o in enumerate(outs)]
        if self.combine_out_splits:
            return torch.cat(outs, dim=-1)
        return outs

    __call__ = apply


class TiledLinearReturnBias(TiledLinear):
    """Returns ``(y_without_bias, bias)`` so a row-parallel consumer can
    add the bias after its reduction."""

    def apply(self, params, x):
        outs = self._out_tiles(params, x)
        y = torch.cat(outs, dim=-1) if self.combine_out_splits else outs
        if not self.use_bias:
            return y, None
        return y, torch.cat([params[f"b_{j}"]
                             for j in range(self.out_splits)], -1)

    __call__ = apply
