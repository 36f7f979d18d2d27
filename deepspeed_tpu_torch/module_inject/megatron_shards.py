"""Megatron tensor-parallel checkpoint shards: merge and split.

Counterpart of ``deepspeed_tpu/module_inject/megatron_shards.py`` (the
reference's ``runtime/state_dict_factory.py``, ``MegatronSDLoader``).
Megatron-LM saves one checkpoint file per tensor-parallel rank
(``mp_rank_00/``, ``mp_rank_01/`` …); serving on one device merges the
shards along each parameter's partition axis:

* axis 0 (column-parallel): ``mlp.dense_h_to_4h.{weight,bias}``,
  ``word_embeddings.weight``, and the fused
  ``attention.query_key_value.{weight,bias}`` (the unversioned legacy
  layout re-grouped by role, as ``merge_query_key_value`` does)
* axis 1 (row-parallel): ``attention.dense.weight``,
  ``mlp.dense_4h_to_h.weight``
* everything else is replicated — the shards must agree and the first
  wins.

The same rules split a full state dict into one rank's shard. Here the
math is torch on tensors in their own dtype (the JAX package's is numpy
in float32: the same values); numpy arrays are taken as they are.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Sequence

import torch

from deepspeed_tpu_torch.utils.lenient_pickle import LenientUnpickler

ROW_PARALLEL = ("attention.dense.weight", "self_attention.dense.weight",
                "mlp.dense_4h_to_h.weight")
COL_PARALLEL = ("mlp.dense_h_to_4h.weight", "mlp.dense_h_to_4h.bias",
                "word_embeddings.weight")
QKV = ("attention.query_key_value.weight", "attention.query_key_value.bias",
       "self_attention.query_key_value.weight",
       "self_attention.query_key_value.bias")


def _t(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _split(x: torch.Tensor, n: int, dim: int = 0):
    """``x`` in ``n`` equal parts along ``dim`` (``np.split``'s rule: an
    unequal division raises)."""
    if x.shape[dim] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[dim]} by {n}")
    return torch.chunk(x, n, dim=dim)


def _kind(key: str) -> str:
    if any(key.endswith(p) for p in QKV):
        return "qkv"
    if any(key.endswith(p) for p in ROW_PARALLEL):
        return "row"
    if any(key.endswith(p) for p in COL_PARALLEL):
        return "col"
    return "replicated"


def merge_qkv(parts: Sequence[torch.Tensor],
              checkpoint_version: float) -> torch.Tensor:
    """The reference's ``merge_query_key_value``: only the unversioned
    legacy format (version 0, layout ``[(3*np*hn), h]``) stores each shard
    as stacked q/k/v thirds that must be re-grouped by role; versions 1.0
    and 2.0 fuse per head (``[(np*hn*3), h]`` / ``[(np*3*hn), h]``) and a
    plain axis-0 cat is right."""
    parts = [_t(p) for p in parts]
    if checkpoint_version == 0:
        thirds = [_split(p, 3) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=0)
                          for i in range(3)], dim=0)
    if checkpoint_version in (1.0, 2.0):
        return torch.cat(parts, dim=0)
    raise ValueError(
        f"checkpoint version {checkpoint_version} is not supported")


def split_qkv(param, n: int, offset: int,
              checkpoint_version: float) -> torch.Tensor:
    """The reference's ``split_query_key_value``; the same version rule as
    :func:`merge_qkv`."""
    param = _t(param)
    if checkpoint_version == 0:
        q, k, v = _split(param, 3)
        return torch.cat([_split(x, n)[offset]
                          for x in (q, k, v)], dim=0)
    if checkpoint_version in (1.0, 2.0):
        return _split(param, n)[offset].clone()
    raise ValueError(
        f"checkpoint version {checkpoint_version} is not supported")


def merge_megatron_shards(shards: Sequence[Dict[str, Any]],
                          checkpoint_version: float = 2.0
                          ) -> Dict[str, torch.Tensor]:
    """Merge per-rank flat state dicts into the full model (the
    reference's ``merge_state_dict``)."""
    if not shards:
        raise ValueError("no shards to merge")
    keys = list(shards[0].keys())
    for i, sd in enumerate(shards[1:], 1):
        if list(sd.keys()) != keys:
            raise ValueError(f"shard {i} key set differs from shard 0")
    out: Dict[str, torch.Tensor] = {}
    for key in keys:
        parts = [_t(sd[key]) for sd in shards]
        kind = _kind(key)
        if kind == "row":
            out[key] = torch.cat(parts, dim=1)
        elif kind == "col":
            out[key] = torch.cat(parts, dim=0)
        elif kind == "qkv":
            out[key] = merge_qkv(parts, checkpoint_version)
        else:
            first = parts[0].float()
            for i, p in enumerate(parts[1:], 1):
                if p.shape != parts[0].shape or not torch.allclose(
                        p.float(), first, rtol=1e-5, atol=1e-5):
                    raise ValueError(
                        f"replicated param {key!r} differs between "
                        f"shard 0 and shard {i} — partition rule missing?")
            out[key] = parts[0]
    return out


def split_megatron_state_dict(sd: Dict[str, Any], world: int, rank: int,
                              checkpoint_version: float = 2.0
                              ) -> Dict[str, torch.Tensor]:
    """One rank's shard of a full state dict (the reference's
    ``split_state_dict``)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world {world}")
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        v = _t(value)
        kind = _kind(key)
        if kind == "row":
            if v.shape[1] % world:
                raise ValueError(f"{key}: dim1 {v.shape[1]} not divisible "
                                 f"by {world}")
            out[key] = _split(v, world, 1)[rank].contiguous()
        elif kind == "col":
            if v.shape[0] % world:
                raise ValueError(f"{key}: dim0 {v.shape[0]} not divisible "
                                 f"by {world}")
            out[key] = _split(v, world)[rank].clone()
        elif kind == "qkv":
            out[key] = split_qkv(v, world, rank, checkpoint_version)
        else:
            out[key] = v
    return out


# ---------------------------------------------------------------- loading
_MP_DIR = re.compile(r"mp_rank_(\d+)$")
_MP_FILE = re.compile(r"mp_rank_(\d+)_model_states\.pt$")


def find_megatron_shards(path: str) -> List[str]:
    """A Megatron checkpoint directory's per-rank files, in rank order:
    ``mp_rank_XX/model_optim_rng.pt`` (Megatron-LM) or
    ``mp_rank_XX_model_states.pt`` (DeepSpeed engine saves)."""
    entries = sorted(os.listdir(path))
    dirs = [(int(m.group(1)), os.path.join(path, e))
            for e in entries if (m := _MP_DIR.search(e))
            and os.path.isdir(os.path.join(path, e))]
    if dirs:
        out = []
        for _, d in sorted(dirs):
            inner = [f for f in sorted(os.listdir(d)) if f.endswith(".pt")]
            if not inner:
                raise FileNotFoundError(f"no .pt file under {d}")
            # prefer the MODEL file: --use-distributed-optimizer also
            # writes distrib_optim.pt here, which must not be picked up
            for preferred in ("model_optim_rng.pt", "model_rng.pt"):
                if preferred in inner:
                    pick = preferred
                    break
            else:
                non_optim = [f for f in inner if "optim" not in f]
                pick = (non_optim or inner)[0]
            out.append(os.path.join(d, pick))
        return out
    files = [(int(m.group(1)), os.path.join(path, e))
             for e in entries if (m := _MP_FILE.search(e))]
    if files:
        return [f for _, f in sorted(files)]
    raise FileNotFoundError(
        f"no mp_rank_* checkpoint shards under {path!r}")


def _flat_model_sd(blob: Any) -> Dict[str, Any]:
    """The flat parameter dict of a Megatron checkpoint blob (nested under
    'model'/'module'/'language_model' to any depth); keys get dotted
    paths."""
    if isinstance(blob, dict):
        for k in ("model", "module"):
            if k in blob and isinstance(blob[k], dict):
                return _flat_model_sd(blob[k])
    flat: Dict[str, Any] = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}.{k}" if prefix else str(k))
        elif hasattr(node, "shape"):
            flat[prefix] = node

    rec(blob, "")
    return flat


def load_megatron_checkpoint(path: str,
                             checkpoint_version: float = None
                             ) -> Dict[str, torch.Tensor]:
    """Load and merge a tensor-parallel Megatron checkpoint directory into
    one flat state dict of host tensors (``MegatronSDLoader.load`` at
    ``mp_world_size=1``)."""
    shards = []
    ver = checkpoint_version
    for f in find_megatron_shards(path):
        blob = torch.load(f, map_location="cpu", weights_only=False,
                          pickle_module=LenientUnpickler)
        if ver is None and isinstance(blob, dict):
            ver = blob.get("checkpoint_version")
        shards.append(_flat_model_sd(blob))
    # a MISSING version means the unversioned legacy format (version 0,
    # interleaved QKV): the reference's get_checkpoint_version defaults to
    # 0, never 2.0
    return merge_megatron_shards(
        shards, checkpoint_version=0 if ver is None else float(ver))
