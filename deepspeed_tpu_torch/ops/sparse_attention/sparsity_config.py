"""Sparsity layout family.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (Dense / Fixed / Variable / BigBird / BSLongformer /
LocalSlidingWindow): each config emits a 0/1 block layout
``[num_heads, num_blocks, num_blocks]`` as a numpy array. Parameter names,
layout semantics and validation messages are the JAX package's, and
``Variable`` / ``BigBird`` draw from a ``np.random.RandomState(seed)`` made
in ``__init__`` in the same order, so the N-th layout of a config equals the
JAX package's N-th layout bit for bit. The layouts stay numpy: they are
host data, turned into a device LUT by ``ops.block_sparse_attention.
build_lut``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} must be divisible by "
                             f"block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), np.int64)

    def check_and_propagate_first_head_layout(self,
                                              layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks active (sanity/testing pattern)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (Child et al. 2019): local
    windows of ``num_local_blocks`` + per-window global representative
    blocks (reference ``:94-241``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("uni/bidirectional only")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs "
                             "bidirectional attention")
        if num_different_global_patterns > 1 and \
                not different_layout_per_head:
            raise ValueError("multiple global patterns need "
                             "different_layout_per_head=True")
        if num_different_global_patterns > \
                num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns too large")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, h, layout):
        nb = layout.shape[1]
        for i in range(0, nb, self.num_local_blocks):
            end = min(i + self.num_local_blocks, nb)
            for row in range(i, end):
                stop = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, i:stop] = 1
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        first = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns
        ) * self.num_global_blocks
        end = nb - (nb % self.num_local_blocks)
        for i in range(first, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < nb:   # short last window
            start = min(end + first, nb - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + local(variable windows) + global columns
    (reference ``:243-420``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False, seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.RandomState(seed)

    def _random(self, h, layout):
        nb = layout.shape[1]
        if self.num_random_blocks == 0:
            return layout
        if nb < self.num_random_blocks:
            raise ValueError("num_random_blocks exceeds row blocks")
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            k = min(self.num_random_blocks, hi)
            cols = self.rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout

    def _local(self, h, layout):
        nb = layout.shape[1]
        start = 0
        wi = 0
        while start < nb:
            w = self.local_window_blocks[
                min(wi, len(self.local_window_blocks) - 1)]
            end = min(start + w, nb)
            for row in range(start, end):
                stop = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:stop] = 1
            start = end
            wi += 1
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < nb:
                    first_row = 0 if self.attention == "bidirectional" \
                        else idx
                    layout[h, first_row:, idx] = 1
                    if self.horizontal_global_attention:
                        layout[h, idx, :] = 1
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                if s < nb:
                    e = min(e, nb)
                    first_row = 0 if self.attention == "bidirectional" else s
                    layout[h, first_row:, s:e] = 1
                    if self.horizontal_global_attention:
                        layout[h, s:e, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._random(h, layout)
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global ITC (reference ``:421-557``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError
        self.attention = attention
        self.rng = np.random.RandomState(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < max(self.num_random_blocks,
                    self.num_sliding_window_blocks, self.num_global_blocks):
            raise ValueError("sequence too short for the BigBird pattern")
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(nb):   # random
                hi = nb if self.attention == "bidirectional" else row + 1
                k = min(self.num_random_blocks, hi)
                layout[h, row, self.rng.choice(hi, k, replace=False)] = 1
            for row in range(nb):   # sliding window
                layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
            g = self.num_global_blocks   # global ITC
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """sliding window + global rows/cols at given indices
    (reference ``:559-686``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != \
                    len(self.global_block_indices):
                raise ValueError("global start/end index length mismatch")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError("global start must be < end")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError("sequence too short for the window")
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(nb):
                layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < nb:
                        layout[h, idx, :] = 1
                        layout[h, :, idx] = 1
            else:
                for s, e in zip(self.global_block_indices,
                                self.global_block_end_indices):
                    if s < nb:
                        e = min(e, nb)
                        layout[h, s:e, :] = 1
                        layout[h, :, s:e] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely-local sliding window (reference ``:688-743``)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError("sequence too short for the window")
        w = self.num_sliding_window_blocks // 2
        for row in range(nb):
            start = max(0, row - w)
            end = min(row + w + 1, nb) if self.attention == "bidirectional" \
                else row + 1
            layout[0, row, start:end] = 1
        return self.check_and_propagate_first_head_layout(layout)
