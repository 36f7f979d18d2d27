"""Tensor and sequence parallelism over ``torch.distributed``.

The JAX package places its weights and activations with GSPMD
(``tp_param_specs``, ``deepspeed_tpu/model_implementations/
transformer.py:230``; the models' ``tp_specs``; ``_maybe_constrain(x,
P(DATA_AXES, "seq", None))``) and XLA inserts the collectives. Here each
rank is one process holding its shard, and the collectives are stated by
hand, Megatron-style, over the process group of one mesh axis
(``comm/mesh.py``):

* :func:`copy_to_group` — identity forward, all-reduce backward: the input
  of a column-parallel projection, whose gradient is a partial sum on
  each rank;
* :func:`reduce_from_group` — all-reduce forward, identity backward: the
  output of a row-parallel projection (its bias is added after it, once);
* :func:`gather_along` — all-gather along a dim, reduce-scatter backward:
  the sequence blocks of q/k/v under the ``seq`` axis;
* :func:`vocab_parallel_embedding` and :func:`vocab_parallel_nll` — a
  table split by rows over ``tensor``: the masked row lookup summed over
  the group, and the cross entropy of vocab-split logits (max and sum of
  exp by all-reduce, the gold logit from the rank that owns its column);
* :func:`seq_block`, :func:`seq_attention`, :func:`next_token_labels` and
  :func:`seq_mean` — the ``seq`` axis of training: the batch is whole on
  every seq rank, each takes its block of the T positions after the
  embedding, attention gathers q/k/v along T and keeps the rank's rows
  (the simplest correct form: the kernels run on the whole T), and the
  loss is the global masked sum over the global count.

:class:`TensorLayout` says where each leaf of a flat training tree lies
over ``tensor``: the dim a spec names ``"tensor"``, cut into contiguous
blocks, except for a fused leaf (GPT-2's ``c_attn``, BERT's
``attn_qkvw``: q, k and v side by side) whose dim is cut part by part, so
that each rank holds its heads of q, of k and of v; :meth:`TensorLayout.
gather` puts the whole leaf back in JAX's layout. :func:`tp_param_specs`
is the port's copy of the serving tree's specs and :func:`shard_tree`
cuts a serving tree by them.

A split that does not divide evenly is refused: GSPMD pads a ragged
shard, the port does not (ROADMAP.md D, "by design").
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as _mesh

TENSOR = "tensor"
SEQ = "seq"


def axis_world(axis: str) -> int:
    """The size of mesh axis ``axis`` (1 without a process group or a
    mesh)."""
    if not dist.is_initialized() or not _mesh.has_global_mesh():
        return 1
    return _mesh.axis_size(axis)


def axis_rank(axis: str) -> int:
    """This rank's index along ``axis`` (0 without a mesh)."""
    if axis_world(axis) == 1:
        return 0
    return _mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# Autograd collectives
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, comm.SUM, ctx.axis), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x, comm.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return comm.all_gather(x, axis, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), ctx.axis,
                                   axis=ctx.dim), None, None


def copy_to_group(x: torch.Tensor, axis: str = TENSOR) -> torch.Tensor:
    return x if axis_world(axis) == 1 else _CopyToGroup.apply(x, axis)


def reduce_from_group(x: torch.Tensor, axis: str = TENSOR) -> torch.Tensor:
    return x if axis_world(axis) == 1 else _ReduceFromGroup.apply(x, axis)


def gather_along(x: torch.Tensor, dim: int, axis: str = SEQ) -> torch.Tensor:
    return x if axis_world(axis) == 1 else _GatherAlong.apply(x, axis, dim)


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor,
                             axis: str = TENSOR) -> torch.Tensor:
    """``table[ids]`` for a table whose rows are split over ``axis``: each
    rank looks up the rows it owns (zeros for the others) and the group
    sums them, so each row comes from exactly one rank."""
    n = table.shape[0]
    local = ids.long() - axis_rank(axis) * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(own[..., None], rows, rows.new_zeros(()))
    return reduce_from_group(rows, axis)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, axis):
        n = logits.shape[-1]
        M = comm.all_reduce(logits.amax(-1), comm.MAX, axis)
        e = torch.exp(logits - M[..., None])
        S = comm.all_reduce(e.sum(-1), comm.SUM, axis)
        local = labels - axis_rank(axis) * n
        own = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        gold = logits.gather(-1, local[..., None])[..., 0]
        gold = comm.all_reduce(torch.where(own, gold, 0.0), comm.SUM, axis)
        ctx.save_for_backward(e.div_(S[..., None]), local, own)
        return torch.log(S) + M - gold

    @staticmethod
    def backward(ctx, g):
        p, local, own = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, local[..., None],
                       torch.where(own, -g, 0.0)[..., None])
        return d, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       axis: str = TENSOR) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` (f32) for logits whose last
    dim is split over ``axis``; ``labels`` index the whole vocabulary and
    lie in it (the caller clamps and masks)."""
    if axis_world(axis) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, labels[..., None])[..., 0]
    return _VocabParallelNLL.apply(logits, labels, axis)


# ---------------------------------------------------------------------------
# The seq axis of training
# ---------------------------------------------------------------------------

def seq_block(T: int) -> Tuple[int, int]:
    """``(start, n)``: this rank's block of ``T`` positions over ``seq``."""
    sp = axis_world(SEQ)
    if sp == 1:
        return 0, T
    if T % sp:
        raise ValueError(f"a sequence of {T} positions does not split "
                         f"evenly over seq={sp}")
    n = T // sp
    return axis_rank(SEQ) * n, n


def seq_attention(attn, q, k, v, *args):
    """``attn(q, k, v, *args)`` over the whole sequence when q/k/v
    ``[B, n, H, D]`` are this rank's block of positions: gathered along T
    (the backward reduce-scatters), attended, and this rank's rows
    kept."""
    if axis_world(SEQ) == 1:
        return attn(q, k, v, *args)
    start, n = axis_rank(SEQ) * q.shape[1], q.shape[1]
    q, k, v = (gather_along(t, 1, SEQ) for t in (q, k, v))
    return attn(q, k, v, *args)[:, start:start + n]


def next_token_labels(input_ids: torch.Tensor, start: int, n: int):
    """The labels of positions ``start..start+n-1`` for next-token
    prediction (``input_ids[:, 1:]``'s), and how many of the positions
    have one: the sequence's last position has none, so only the last
    seq rank drops a position."""
    m = min(n, input_ids.shape[1] - 1 - start)
    return input_ids[:, start + 1:start + 1 + m], m


def seq_mean(nll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked mean of ``nll`` over every seq rank's positions: the
    global masked sum (all-reduced, identity backward) over the global
    count."""
    total = reduce_from_group((nll * mask).sum(), SEQ)
    count = mask.sum()
    if axis_world(SEQ) > 1:
        count = comm.all_reduce(count, comm.SUM, SEQ)
    return total / torch.clamp(count, min=1)


# ---------------------------------------------------------------------------
# Where the leaves lie
# ---------------------------------------------------------------------------

def spec_dim(spec, axis: str = TENSOR) -> Optional[int]:
    """The dim a partition spec places on ``axis`` (None: none)."""
    for i, e in enumerate(tuple(spec or ())):
        if e == axis or (isinstance(e, (tuple, list)) and axis in e):
            return i
    return None


def _cut(full: torch.Tensor, d: int, parts: int, size: int,
         rank: int) -> torch.Tensor:
    x = full.unflatten(d, (parts, full.shape[d] // parts))
    k = x.shape[d + 1] // size
    return x.narrow(d + 1, rank * k, k).flatten(d, d + 1)


def _check_even(name, shape, d, parts, size) -> None:
    if shape[d] % (parts * size):
        raise ValueError(
            f"param {name!r} dim {d} (size {shape[d]}) does not split "
            f"evenly over tensor={size}" + (f" in {parts} fused parts"
                                            if parts > 1 else "") +
            ": GSPMD pads a ragged shard, the port refuses it")


class TensorLayout:
    """The ``tensor`` placement of a flat tree of leaves: ``dims[name]``
    the dim split over the axis (None: replicated), ``fused[name]`` the
    number of parts (q, k, v) side by side along it, each cut into
    ``size`` blocks. ``size`` and ``rank`` default to the global mesh's
    ``tensor`` axis."""

    def __init__(self, specs: Dict[str, tuple],
                 shapes: Dict[str, Sequence[int]],
                 fused: Optional[Dict[str, int]] = None,
                 size: Optional[int] = None, rank: Optional[int] = None):
        self.size = axis_world(TENSOR) if size is None else size
        self.rank = axis_rank(TENSOR) if rank is None else rank
        self.fused = dict(fused or {})
        self.dims: Dict[str, Optional[int]] = {}
        for n, s in shapes.items():
            d = spec_dim(specs.get(n)) if self.size > 1 else None
            if d is not None:
                _check_even(n, tuple(s), d, self.fused.get(n, 1), self.size)
            self.dims[n] = d

    def sharded(self, name: str) -> bool:
        return self.dims.get(name) is not None

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """The rank's shard of the whole leaf (a view)."""
        d = self.dims.get(name)
        if d is None:
            return full
        return _cut(full, d, self.fused.get(name, 1), self.size, self.rank)

    def local_shape(self, name: str, shape) -> Tuple[int, ...]:
        shape = tuple(shape)
        d = self.dims.get(name)
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.size,) + shape[d + 1:]

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf, in JAX's layout, from every rank's shard (a
        collective over ``tensor``: every rank calls it)."""
        d = self.dims.get(name)
        if d is None:
            return local
        parts = self.fused.get(name, 1)
        x = local.unflatten(d, (parts, local.shape[d] // parts))
        x = comm.all_gather(x.contiguous(), TENSOR, axis=d + 1, tiled=False)
        return x.flatten(d, d + 2)


# ---------------------------------------------------------------------------
# The serving tree
# ---------------------------------------------------------------------------

def tp_param_specs(params) -> dict:
    """Megatron placement of the serving tree over ``tensor``, JAX's
    ``tp_param_specs`` entry for entry: wq/wk/wv and mlp.wi/wg split on
    heads or the FFN dim (column-parallel), attn.wo and mlp.wo on their
    contraction (row-parallel), everything else replicated. An int8
    node's ``q`` follows its weight, a row-group ``scale`` the weight's
    leading dims, an ``oscale`` the weight's output dims (replicated for
    row-parallel weights: the rescale follows the all-reduce)."""
    def spec_for(path: str) -> tuple:
        if path.endswith(".q"):
            return spec_for(path[:-2])
        if path.endswith(".scale"):
            base = spec_for(path[:-len(".scale")])
            return base[:-1] + (None,) if base else ()
        if path.endswith(".oscale"):
            wpath = path[:-len(".oscale")]
            base = spec_for(wpath)
            if wpath.endswith(("attn.wo", "mlp.wo")):
                base = (None,) * len(base)
            return base
        if path.endswith(("attn.wq", "attn.wk", "attn.wv")):
            return (None, TENSOR, None)
        if path.endswith(("attn.bq", "attn.bk", "attn.bv")):
            return (TENSOR, None)
        if path.endswith("attn.wo"):
            return (TENSOR, None, None)
        if path.endswith(("mlp.wi", "mlp.wg")):
            return (None, TENSOR)
        if path.endswith(("mlp.bi", "mlp.bg")):
            return (TENSOR,)
        if path.endswith("mlp.wo"):
            return (TENSOR, None)
        return ()

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return spec_for(path)

    return walk(params)


def gather_tree(params, specs):
    """The whole serving tree from every ``tensor`` rank's shard (a
    collective: every rank calls it)."""
    if isinstance(params, dict):
        return {k: gather_tree(v, specs[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [gather_tree(v, s) for v, s in zip(params, specs)]
    d = spec_dim(specs)
    if d is None or axis_world(TENSOR) == 1:
        return params
    return comm.all_gather(params.contiguous(), TENSOR, axis=d)


def shard_tree(params, specs, size: int, rank: int, path: str = ""):
    """The rank's shard of every leaf of a serving tree (contiguous
    copies; the whole leaves can then be freed)."""
    if isinstance(params, dict):
        return {k: shard_tree(v, specs[k], size, rank, f"{path}.{k}")
                for k, v in params.items()}
    if isinstance(params, list):
        return [shard_tree(v, s, size, rank, path)
                for v, s in zip(params, specs)]
    d = spec_dim(specs)
    if d is None or size == 1:
        return params
    _check_even(path.lstrip("."), tuple(params.shape), d, 1, size)
    return _cut(params, d, 1, size, rank).contiguous()
