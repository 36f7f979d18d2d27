"""Row-sparse gradients and their exchange.

Counterpart of ``deepspeed_tpu/runtime/sparse_tensor.py`` (reference
``runtime/sparse_tensor.py`` ``SparseTensor`` and the engine's sparse
allreduce, ``runtime/engine.py:2459-2541``). A token batch touches at most
``tokens-per-rank`` rows of an embedding, so its gradient is row-sparse.
The data-parallel mean of such a leaf is

    dense [V, D]  --from_dense-->  (ids [K], rows [K, D])
                  --all_gather over the data group-->  (dp*K ids and rows)
                  --scatter-add / dp-->  dense [V, D] mean

which moves ``2 * dp * K * D`` elements instead of ``V * D``. ``K``
(capacity) is a bound from the batch's shape: the tokens one rank
contributes in one step, clamped below the table height.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from deepspeed_tpu_torch.comm import comm


@dataclasses.dataclass
class SparseRows:
    """Row-sparse view of a 2-D tensor: ``rows[i]`` belongs at
    ``dense[ids[i]]``; duplicate ids accumulate."""
    ids: torch.Tensor     # [K] int64
    rows: torch.Tensor    # [K, D]

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    def to_dense(self, n_rows: int) -> torch.Tensor:
        """Scatter-add into a dense ``[n_rows, D]`` tensor."""
        out = torch.zeros((n_rows, self.rows.shape[1]), dtype=self.rows.dtype,
                          device=self.rows.device)
        return out.index_add_(0, self.ids, self.rows)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, capacity: int) -> "SparseRows":
        """The ``capacity`` rows of largest L1 mass (every nonzero row when
        ``capacity`` bounds the row support). Slots of empty rows point at
        row 0 with zero values, so which empty row ``topk`` picked does not
        matter."""
        if capacity >= dense.shape[0]:
            raise ValueError(
                f"capacity {capacity} >= rows {dense.shape[0]}: sparse "
                "exchange would be larger than the dense one")
        mass = dense.abs().sum(dim=1)
        ids = torch.topk(mass, capacity).indices
        nonzero = mass[ids] > 0
        rows = torch.where(nonzero[:, None], dense[ids],
                           torch.zeros((), dtype=dense.dtype,
                                       device=dense.device))
        return cls(ids=torch.where(nonzero, ids, torch.zeros_like(ids)),
                   rows=rows)


def sparse_all_mean(dense: torch.Tensor, capacity: int,
                    axis_names: Sequence[str] = ("data",)) -> torch.Tensor:
    """The mean of a row-sparse gradient over ``axis_names`` by an
    all-gather of (ids, rows) and a scatter-add (reference
    sparse_allreduce_bucket, engine.py:2459). Exact when each rank's
    gradient has at most ``capacity`` nonzero rows."""
    sp = SparseRows.from_dense(dense, capacity)
    ids, rows = sp.ids, sp.rows
    for a in axis_names:
        ids = comm.all_gather(ids, a).reshape(-1)
        rows = comm.all_gather(rows, a).reshape(-1, rows.shape[-1])
    world = ids.shape[0] // sp.ids.shape[0]
    merged = SparseRows(ids=ids, rows=rows).to_dense(dense.shape[0])
    return (merged / world).to(dense.dtype)


def sparse_capacity(batch, dp_shards: int, n_rows: int) -> int:
    """Row-support bound: the tokens one data-parallel rank contributes in
    one optimizer step (every micro-batch) — the largest element count of
    the batch's tensors over ``dp_shards`` — clamped below the table
    height."""
    tokens = 1
    for leaf in batch.values():
        tokens = max(tokens, int(torch.as_tensor(leaf).numel()) // dp_shards)
    return min(tokens, n_rows - 1)
