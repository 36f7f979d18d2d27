"""Abstract ("meta-device") initialization and leaf-by-leaf
materialization.

Counterpart of ``deepspeed_tpu/utils/init_on_device.py`` (reference
``deepspeed/utils/init_on_device.py`` ``OnDevice``). Under
``OnDevice(device="meta")`` an init function builds ``meta`` tensors
(shapes and dtypes, no bytes). :func:`materialize` then builds the real
tree one leaf at a time and keeps each rank's block (``partition``, the
engine's ZeRO partition), so at most one whole leaf is live at a time — the
memory contract of the reference's ``device=`` path and of JAX's
``jit(out_shardings=...)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition


class OnDevice:
    """``with OnDevice(dtype=torch.bfloat16, device="meta"): ...`` —
    :meth:`init` returns ``meta`` trees; with ``device="device"`` it
    builds on ``target`` (default: the CUDA device)."""

    _stack: list = []   # class-level: re-entering one instance is safe

    def __init__(self, dtype=None, device: str = "meta",
                 partition: Optional[ZeroPartition] = None, target=None):
        if device not in ("meta", "device"):
            raise ValueError(f"device must be 'meta' or 'device', got "
                             f"{device!r}")
        self.dtype = dtype
        self.device = device
        self.partition = partition
        self.target = target

    def __enter__(self) -> "OnDevice":
        OnDevice._stack.append(self)
        return self

    def __exit__(self, *exc):
        OnDevice._stack.pop()
        return False

    def _cast(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.dtype is None:
            return tree
        return {k: v.to(self.dtype) if v.is_floating_point() else v
                for k, v in tree.items()}

    def init(self, init_fn: Callable, *args, **kwargs) -> Any:
        """``init_fn`` (returning a dict of tensors) on ``meta``, or built
        on the target device (each rank's blocks under ``partition``)."""
        if self.device == "meta":
            with torch.device("meta"):
                return self._cast(init_fn(*args, **kwargs))
        with torch.device(self.target or "cuda"):
            tree = self._cast(init_fn(*args, **kwargs))
        part = self.partition
        if part is None:
            return tree
        return {k: part.shard(k, v).clone() if part.sharded(k) else v
                for k, v in tree.items()}

    @classmethod
    def current(cls) -> Optional["OnDevice"]:
        return cls._stack[-1] if cls._stack else None


def materialize(abstract_tree: Dict[str, torch.Tensor],
                init_fn: Callable[[str, torch.Tensor], torch.Tensor],
                partition: Optional[ZeroPartition] = None, dtype=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Build the tree ``OnDevice("meta")`` described, leaf by leaf:
    ``init_fn(name, abstract_leaf)`` gives the whole leaf, which is cast
    to ``dtype`` and cut to the rank's block under ``partition`` (the
    engine's :class:`ZeroPartition`) before the next leaf is built, on
    ``device`` (default ``cuda``). Every leaf's shape and dtype are first
    checked on ``meta`` (free): a mismatched ``init_fn`` must not build a
    wrong multi-GB tree before it is refused."""
    caster = OnDevice(dtype=dtype)
    with torch.device("meta"):
        probe = caster._cast({k: init_fn(k, a)
                              for k, a in abstract_tree.items()})
    if {k: (tuple(a.shape), a.dtype) for k, a in abstract_tree.items()} != \
            {k: (tuple(a.shape), a.dtype) for k, a in probe.items()}:
        raise ValueError("materialize: init_fn disagrees with the "
                         "abstract tree's shapes/dtypes")
    out = {}
    for k, a in abstract_tree.items():
        with torch.device(device or "cuda"):
            full = caster._cast({k: init_fn(k, a)})[k]
        sharded = partition is not None and partition.sharded(k)
        out[k] = partition.shard(k, full).clone() if sharded else full
        del full
    return out
