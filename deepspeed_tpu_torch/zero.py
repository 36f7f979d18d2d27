"""User-facing ZeRO context APIs: ``zero.Init`` and ``GatheredParameters``.

Counterpart of ``deepspeed_tpu/zero.py`` (reference
``runtime/zero/partition_parameters.py`` ``Init`` :537 and
``GatheredParameters`` :1512). Both are explicit, as in JAX, rather than
constructor hijacks:

* :class:`Init` — ``init.shard(tree)`` places a dict of whole weights by
  the engine's ZeRO partition (``runtime/zero/partition.py``): each rank
  keeps its block of every leaf the policy shards (stage 3: the params),
  a copy of its own, so the whole tree can be dropped.
* :class:`GatheredParameters` — the selected engine params whole (host
  tensors, gathered from the ranks' blocks at stage 3) for surgery; on
  exit the values of ``modifier_rank`` are broadcast to every rank and
  each rank writes its block back into the engine's params
  (``modifier_rank=None``: read only).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm.mesh import get_global_mesh
from deepspeed_tpu_torch.runtime.zero.partition import (ZeroPartition,
                                                        ZeroShardingPolicy)


class Init:
    """``with zero.Init(config_dict_or_stage) as zinit: params =
    zinit.shard(make_params())`` — each rank keeps its blocks."""

    def __init__(self, config_dict_or_path: Any = None, mesh=None,
                 zero_stage: int = 3, **_):
        if isinstance(config_dict_or_path, str):
            with open(config_dict_or_path) as f:
                config_dict_or_path = json.load(f)
        if isinstance(config_dict_or_path, dict):
            zero_stage = config_dict_or_path.get(
                "zero_optimization", {}).get("stage", zero_stage)
        self.mesh = mesh if mesh is not None else get_global_mesh()
        self.policy = ZeroShardingPolicy(zero_stage, self.mesh)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def shard(self, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The rank's block of each leaf where the policy shards the
        params (stage 3; the engine's :class:`ZeroPartition`), else the
        leaf itself."""
        tree = {k: torch.as_tensor(v) for k, v in params.items()}
        part = ZeroPartition(self.policy,
                             {k: t.shape for k, t in tree.items()},
                             sharded=self.policy.stage >= 3)
        return {k: part.shard(k, t).clone() if part.sharded(k) else t
                for k, t in tree.items()}


def _selected(name: str, paths) -> bool:
    """``name`` (the engine's dotted name) is under one of ``paths``
    (dotted or the JAX tree's ``/``-joined)."""
    if paths is None:
        return True
    for p in paths:
        p = p.replace("/", ".")
        if name == p or name.startswith(p + "."):
            return True
    return False


class GatheredParameters:
    """``with GatheredParameters(engine, ["wte", "h_0.attn"]) as g:``
    exposes ``g[name]`` whole as a mutable host tensor; writes by
    ``modifier_rank`` reach every rank's params on exit. ``params=None``
    gathers every leaf (small models only). Every rank enters and leaves
    the context together: gathering and broadcasting are collectives."""

    def __init__(self, engine, params: Optional[Iterable[str]] = None,
                 modifier_rank: Optional[int] = 0, fwd_module=None,
                 enabled: bool = True):
        self.engine = engine
        self.enabled = enabled
        self.modifier_rank = modifier_rank
        self.paths = list(params) if params is not None else None
        self._host: Dict[str, torch.Tensor] = {}

    def __enter__(self):
        if not self.enabled:
            return self
        eng = self.engine
        for name, p in eng.params.items():
            if _selected(name, self.paths):
                self._host[name] = eng._whole(name, p, eng._psh(name)).to(
                    "cpu", copy=True)
        return self

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._host[name]

    def keys(self):
        return self._host.keys()

    def __exit__(self, exc_type, *exc):
        if exc_type is not None or not self.enabled or \
                self.modifier_rank is None:
            return False
        eng = self.engine
        with torch.no_grad():
            for name, val in self._host.items():
                p = eng.params[name].detach()
                val = val.to(eng.device, p.dtype)
                if eng._dist and dist.get_world_size() > 1:
                    dist.broadcast(val, src=self.modifier_rank)
                p.copy_(eng._block(name, val, eng._psh(name)))
        return False
