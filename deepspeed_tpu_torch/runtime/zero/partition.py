"""ZeRO partitioning: per-leaf specs over the mesh, and each rank's slice.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py``. Every stage
is a placement policy for the three trees of a training step:

===== =================== ====================== =======================
stage params (compute dt)  gradients              optimizer state (f32
                                                  master + moments)
===== =================== ====================== =======================
0     replicated           all-reduced            replicated
1     replicated           all-reduced            sharded over zero axes
2     replicated           reduce-scattered       sharded
3     sharded              reduce-scattered       sharded
===== =================== ====================== =======================

The zero axes are ``("data", "fsdp")``. :func:`shard_leaf_spec` and
:class:`ZeroShardingPolicy` give each leaf the spec JAX's give it, entry
for entry, in the port's own :class:`PartitionSpec`: the largest dimension
that divides by the zero axes' size and is not claimed by tensor
parallelism; leaves smaller than ``param_persistence_threshold`` (or than
the zero size), and leaves with no divisible dimension, stay replicated.

JAX's XLA partitioner then inserts the collectives; here the engine makes
them itself (``runtime/engine.py``) and each rank holds only its
contiguous slice of a sharded leaf (:class:`ZeroPartition`). A spec that
names ``("data", "fsdp")`` is indexed data-major, as JAX orders the
devices.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm.mesh import axis_index, mesh_shape
from deepspeed_tpu_torch.utils.logging import logger

ZERO_AXES = ("data", "fsdp")  # combined ZeRO partitioning axis


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (whole), an axis name, or a tuple
    of axis names (JAX's ``PartitionSpec``, compared entry for entry)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _zero_axis_size(shape: Dict[str, int]) -> int:
    return math.prod(shape[a] for a in ZERO_AXES)


def _spec_entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def shard_dim(shape: Sequence[int], parts: int, min_size: int = 0,
              free: Optional[Sequence[bool]] = None) -> Optional[int]:
    """The dimension ZeRO splits into ``parts``: the largest one that
    divides evenly (the last of equals), among the ``free`` ones; None
    for a leaf smaller than ``max(min_size, parts)`` or with no such
    dimension."""
    size = math.prod(shape) if len(shape) else 1
    if size < max(min_size, parts):
        return None
    cands = [(d, i) for i, d in enumerate(shape)
             if (free is None or free[i]) and d % parts == 0]
    return max(cands)[1] if cands else None


def zero_dim(shape, base_spec: Optional[Sequence], sizes: Dict[str, int],
             min_size: int = 0) -> Tuple[Optional[int], Tuple[str, ...]]:
    """``(dim, axes)``: the dimension ZeRO splits and the zero axes it
    splits over, after ``base_spec`` (TP placement) took its dims and
    axes; ``(None, ...)`` if nothing fits. Over a zero group of one
    (``axes == ()``) the dim is the one the same rule picks for one
    part."""
    base = _normalize_base(base_spec, len(shape))
    used = set()
    for e in base:
        used.update(_spec_entry_axes(e))
    zero_axes = tuple(a for a in ZERO_AXES if sizes[a] > 1 and a not in used)
    zdiv = math.prod(sizes[a] for a in zero_axes)
    idx = shard_dim(tuple(shape), zdiv,
                    max(min_size, _zero_axis_size(sizes)),
                    free=[e is None for e in base])
    return idx, zero_axes


def shard_leaf_spec(shape, base_spec: Optional[Sequence], mesh,
                    min_size: int = 0) -> PartitionSpec:
    """Extend ``base_spec`` (TP placement) with ZeRO sharding of one dim;
    ``base_spec`` unchanged if nothing fits. ``mesh`` is a ``DeviceMesh``
    or a ``{axis: size}`` mapping."""
    base = _normalize_base(base_spec, len(shape))
    idx, zero_axes = zero_dim(shape, base, mesh_shape(mesh), min_size)
    new = list(base)
    if idx is not None and zero_axes:
        new[idx] = zero_axes[0] if len(zero_axes) == 1 else zero_axes
    return P(*new) if any(e is not None for e in new) else P()


def _normalize_base(tp_spec, ndim):
    base = tuple(tp_spec) if tp_spec is not None else ()
    return base + (None,) * (ndim - len(base))


class ZeroShardingPolicy:
    """Per-leaf specs for the param / grad / optimizer-state trees (flat
    dicts of tensors or of shapes). ``tp_specs``: an optional dict of
    specs carrying tensor/seq placement; ZeRO composes on top of the
    dims they leave free."""

    # EP placement rides the data-parallel axes: a model's expert dim must
    # divide them (the dispatch all-to-all needs equal shards)
    _EP_AXES = frozenset(ZERO_AXES)

    def __init__(self, stage: int, mesh, tp_specs=None,
                 param_persistence_threshold: int = 0):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"invalid ZeRO stage {stage}")
        self.stage = stage
        self.mesh = mesh
        self.tp_specs = tp_specs or {}
        self.threshold = param_persistence_threshold
        self._warned_uneven: set = set()

    def _map(self, params_like, fully_shard: bool) -> Dict[str, P]:
        out = {}
        for name, leaf in params_like.items():
            shape = tuple(getattr(leaf, "shape", leaf))
            tp = self.tp_specs.get(name)
            if fully_shard:
                spec = shard_leaf_spec(shape, tp, self.mesh, self.threshold)
            else:
                base = _normalize_base(tp, len(shape))
                spec = P(*base) if any(e is not None for e in base) else P()
            self._check_divisible(name, shape, spec, tp)
            out[name] = spec
        return out

    def _check_divisible(self, name, shape, spec, model_spec=None) -> None:
        """A dim the model placed on the EP axes that does not divide them
        is an error; any other uneven dim (a model's TP spec) warns once."""
        sizes = mesh_shape(self.mesh)
        model_base = _normalize_base(model_spec, len(shape))
        for i, entry in enumerate(tuple(spec)):
            axes = _spec_entry_axes(entry)
            div = math.prod(sizes[a] for a in axes)
            if not axes or div <= 1 or shape[i] % div == 0:
                continue
            if set(_spec_entry_axes(model_base[i])) & self._EP_AXES:
                raise ValueError(
                    f"param {name!r} dim {i} (size {shape[i]}) is not "
                    f"divisible by mesh axes {axes} (product {div}) required "
                    f"by its sharding spec {spec}: the expert dispatch "
                    "all-to-all needs equal shards")
            if (name, i) not in self._warned_uneven:
                self._warned_uneven.add((name, i))
                logger.warning(
                    "param %r dim %d (size %d) is not divisible by mesh "
                    "axes %s (product %d)", name, i, shape[i], axes, div)

    # -- the three placements ------------------------------------------------
    def param_sharding(self, params_like) -> Dict[str, P]:
        """Compute-dtype params: sharded only at stage 3."""
        return self._map(params_like, fully_shard=self.stage >= 3)

    def grad_sharding(self, params_like) -> Dict[str, P]:
        """Gradient accumulators: reduce-scattered at stage >= 2."""
        return self._map(params_like, fully_shard=self.stage >= 2)

    def master_sharding(self, params_like) -> Dict[str, P]:
        """f32 master weights and optimizer moments: sharded at stage >= 1."""
        return self._map(params_like, fully_shard=self.stage >= 1)


class ZeroPartition:
    """Where each leaf's ZeRO shard lies on this rank, by ``policy``:
    ``dims[name]`` the dim :func:`zero_dim` picks (that of the policy's
    spec; None: the rank holds the whole leaf), split into ``parts``
    contiguous blocks (the zero axes' size) of which the rank holds block
    ``index`` (its data-major index on the zero axes, as JAX orders the
    devices). ``sharded`` (default: stage >= 1, the master's placement)
    says whether the tree is split at all; ``zero.Init`` asks for the
    params' (stage 3).

    Over a zero group of one rank (NCCL at world size 1 on one card) a
    leaf is "sharded into one" along the dim the same rule picks, so the
    engine runs its collective path, each collective an identity. Only
    the zero dim is cut: TP placement is not held here."""

    def __init__(self, policy: ZeroShardingPolicy,
                 shapes: Dict[str, Sequence[int]],
                 index: Optional[int] = None,
                 sharded: Optional[bool] = None):
        sizes = mesh_shape(policy.mesh)
        self.parts = _zero_axis_size(sizes)
        self.index = (axis_index(ZERO_AXES, policy.mesh)
                      if index is None else index)
        on = policy.stage >= 1 if sharded is None else sharded
        self.dims: Dict[str, Optional[int]] = {}
        for k, s in shapes.items():
            d, axes = zero_dim(tuple(s), policy.tp_specs.get(k), sizes,
                               policy.threshold)
            self.dims[k] = d if on and (axes or self.parts == 1) else None

    def sharded(self, name: str) -> bool:
        return self.dims[name] is not None

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """The rank's block of the whole leaf (a view)."""
        d = self.dims[name]
        if d is None:
            return full
        k = full.shape[d] // self.parts
        return full.narrow(d, self.index * k, k)

    def shard_shape(self, name: str, shape) -> Tuple[int, ...]:
        d = self.dims[name]
        shape = tuple(shape)
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.parts,) + shape[d + 1:]
