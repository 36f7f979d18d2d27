"""Universal checkpoint: inspect + reshape.

Counterpart of ``deepspeed_tpu/checkpoint/universal.py`` (reference
``deepspeed/checkpoint/``: ``DeepSpeedCheckpoint``, ``reshape_meg_2d.py``,
``universal_checkpoint.py``). The reference stores per-rank shard files,
so changing a parallel degree takes an offline merge/split; the port's
``<tag>/state`` holds whole host tensors, which load onto any layout, so:

* :class:`DeepSpeedCheckpoint` gives the reference's inspection API
  (tags, step, per-tensor shapes and dtypes) over a saved tag;
  :meth:`~DeepSpeedCheckpoint.metadata` reads no tensor data
  (``torch.load(mmap=True)`` maps the files).
* :func:`reshape_checkpoint` materializes a copy for another topology:
  every tensor read to the host and written again, the sidecar files
  beside it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
    TorchCheckpointEngine)
from deepspeed_tpu_torch.utils.logging import logger


def _tags(load_dir: str) -> List[str]:
    """Numeric-aware sort: global_step10 must rank above global_step9."""

    def key(tag: str):
        nums = re.findall(r"\d+", tag)
        return (tag if not nums else re.sub(r"\d+", "", tag),
                [int(n) for n in nums])

    return sorted((d for d in os.listdir(load_dir)
                   if os.path.isdir(os.path.join(load_dir, d))), key=key)


def _describe(node):
    if isinstance(node, dict):
        return {k: _describe(v) for k, v in node.items()}
    if torch.is_tensor(node):
        return {"shape": tuple(node.shape),
                "dtype": str(node.dtype).replace("torch.", "")}
    return node


class DeepSpeedCheckpoint:
    """Inspection API over a saved engine checkpoint directory
    (reference ``deepspeed_checkpoint.py``)."""

    def __init__(self, ckpt_dir: str, tag: Optional[str] = None):
        self.root = ckpt_dir
        if tag is None:
            latest = os.path.join(ckpt_dir, "latest")
            if os.path.isfile(latest):
                with open(latest) as f:
                    tag = f.read().strip()
            else:
                tags = _tags(ckpt_dir)
                if not tags:
                    raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
                tag = tags[-1]
        self.tag = tag
        self.dir = os.path.join(ckpt_dir, tag)
        self.state_path = os.path.join(self.dir, "state")
        meta = os.path.join(self.dir, "client_state.json")
        self.meta: Dict[str, Any] = {}
        if os.path.isfile(meta):
            with open(meta) as f:
                self.meta = json.load(f)

    @property
    def global_steps(self) -> int:
        return int(self.meta.get("global_steps", 0))

    @property
    def zero_stage(self) -> int:
        return int(self.meta.get("zero_stage", 0))

    def tags(self) -> List[str]:
        return [t for t in _tags(self.root) if t != "latest"]

    def metadata(self) -> Dict[str, Any]:
        """Per-tensor ``{"shape", "dtype"}`` of every group (host ints as
        they are), read without the tensors' data — the reference's
        header scan."""
        return _describe(self.load())

    def load(self, abstract_state: Any = None) -> Dict[str, Any]:
        """The state's groups as host tensors (memory-mapped)."""
        return TorchCheckpointEngine().load(self.state_path, abstract_state)


def reshape_checkpoint(src_dir: str, dst_dir: str,
                       tag: Optional[str] = None) -> str:
    """Materialize a topology-independent copy: read every tensor to the
    host and write it again. The result loads onto any layout. (With
    whole-tensor checkpoints this is the whole reshape toolkit —
    reshape_meg_2d/reshape_3d_utils collapse to an identity copy.)"""
    src = DeepSpeedCheckpoint(src_dir, tag)
    state = src.load()
    os.makedirs(os.path.join(dst_dir, src.tag), exist_ok=True)
    TorchCheckpointEngine().save(state, os.path.join(dst_dir, src.tag,
                                                     "state"))
    # sidecar files (host_optimizer.npz, client_state.json, the manifest,
    # user blobs) travel with the checkpoint — dropping host_optimizer.npz
    # would silently reset offloaded Adam moments on restore
    for name in os.listdir(src.dir):
        src_path = os.path.join(src.dir, name)
        if name != "state" and os.path.isfile(src_path):
            shutil.copy2(src_path, os.path.join(dst_dir, src.tag, name))
    with open(os.path.join(dst_dir, "latest"), "w") as f:
        f.write(src.tag)
    logger.info(f"reshaped checkpoint {src.tag}: {src_dir} → {dst_dir}")
    return os.path.join(dst_dir, src.tag)
