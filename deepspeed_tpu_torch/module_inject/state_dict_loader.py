"""Serving an HF checkpoint directory with no model object.

Counterpart of ``deepspeed_tpu/module_inject/state_dict_loader.py``:
``init_inference(path)`` reads the weights from files and converts them
through the policy table without building a ``transformers`` model (the
card's machine has neither ``transformers`` nor ``safetensors``):

* ``model.safetensors`` (one file) or ``model.safetensors.index.json``
  (HF's sharded layout): read lazily by the port's own reader
  (``utils/safetensors_io.py``), one tensor at a time as the policy asks
  for it, so host memory holds one tensor;
* ``pytorch_model.bin`` / ``.bin.index.json``: ``torch.load`` (memory-
  mapped where the file is a zip archive, as ``torch.save`` writes);
* Megatron ``mp_rank_*`` directories: merged by ``megatron_shards.py``.

The flat name → tensor mapping is wrapped in an attribute-path view that
mimics the module tree the policies walk
(``model.transformer.h[3].attn.c_attn.weight`` → key
``"transformer.h.3.attn.c_attn.weight"``), so every architecture of
``policies.py`` converts from files with no code of its own. With a
``device``, each tensor moves there as it is read, and the conversion runs
there.
"""
from __future__ import annotations

import json
import os
import zipfile
from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch

from deepspeed_tpu_torch.utils.safetensors_io import SafetensorsReader

__all__ = ["load_hf_config", "load_state_dict",
           "load_inference_checkpoint", "CheckpointModelView"]


class _LazyStateDict:
    """name → tensor over one or more safetensors files, each tensor read
    from its file when it is asked for."""

    def __init__(self, weight_files: Dict[str, str]):
        self._files = weight_files   # weight name -> file path
        self._readers: Dict[str, SafetensorsReader] = {}

    def keys(self):
        return self._files.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def __getitem__(self, name: str) -> torch.Tensor:
        path = self._files[name]
        reader = self._readers.get(path)
        if reader is None:
            reader = self._readers[path] = SafetensorsReader(path)
        return reader.get_tensor(name)


class _ModuleView:
    """Attribute-path view over a flat state dict: attribute chains walk
    dotted key prefixes; integer indexing and iteration walk numbered
    children (``h.0``, ``h.1``, …). Leaves come out as tensors (a numpy
    array as ``torch.as_tensor`` of it), on ``device`` when one is
    given."""

    def __init__(self, sd, prefix: str = "", device=None):
        object.__setattr__(self, "_sd", sd)
        object.__setattr__(self, "_prefix", prefix)
        object.__setattr__(self, "_device", device)

    def _child(self, name: str):
        sd, prefix = self._sd, self._prefix
        full = prefix + name
        if full in sd:
            v = torch.as_tensor(sd[full])
            return v if self._device is None else v.to(self._device)
        dotted = full + "."
        if any(k.startswith(dotted) for k in sd.keys()):
            return _ModuleView(sd, dotted, self._device)
        # torch modules expose bias=None when the layer was built without
        # one; checkpoints simply omit the key. Policies test
        # ``x.bias is not None``, so a missing bias beside an existing
        # weight reads as None, as on a live module
        if name == "bias" and (prefix + "weight") in sd:
            return None
        raise AttributeError(
            f"no tensor or submodule {full!r} in checkpoint")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._child(name)

    def __getitem__(self, idx: int):
        return self._child(str(idx))

    def __len__(self) -> int:
        dotted = self._prefix
        idx = set()
        for k in self._sd.keys():
            if k.startswith(dotted):
                head = k[len(dotted):].split(".", 1)[0]
                if head.isdigit():
                    idx.add(int(head))
        return len(idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self._child(str(i))


class CheckpointModelView(_ModuleView):
    """Root view: adds ``.config`` so ``convert_hf_model`` can dispatch.
    ``sd`` is any name → tensor mapping (tensors on the card convert on
    the card); ``device`` moves each leaf there as it is read."""

    def __init__(self, sd, config, device=None):
        super().__init__(sd, device=device)
        object.__setattr__(self, "config", config)


def load_hf_config(path: str) -> SimpleNamespace:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no config.json under {path!r} — expected an HF checkpoint "
            f"directory")
    with open(cfg_path) as f:
        return SimpleNamespace(**json.load(f))


def _torch_load(path: str):
    """A ``.bin`` state dict on the host: memory-mapped when the file is
    a zip archive (``torch.save``'s format since torch 1.6), so its
    tensors are paged in as they are read."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))


def load_state_dict(path: str):
    """The checkpoint files under ``path`` as a flat name → tensor mapping
    (lazy for safetensors). Knows the transformers layout
    (``model.safetensors`` / ``pytorch_model.bin``, single or sharded) and
    Megatron's ``mp_rank_*`` shards."""
    if any(n.startswith("mp_rank_") for n in
           (os.listdir(path) if os.path.isdir(path) else ())):
        from deepspeed_tpu_torch.module_inject.megatron_shards import (
            load_megatron_checkpoint)
        return load_megatron_checkpoint(path)

    st = os.path.join(path, "model.safetensors")
    st_index = os.path.join(path, "model.safetensors.index.json")
    bin_ = os.path.join(path, "pytorch_model.bin")
    bin_index = os.path.join(path, "pytorch_model.bin.index.json")

    if os.path.exists(st_index):
        with open(st_index) as f:
            weight_map = json.load(f)["weight_map"]
        return _LazyStateDict(
            {name: os.path.join(path, fname)
             for name, fname in weight_map.items()})
    if os.path.exists(st):
        return _LazyStateDict(
            {name: st for name in SafetensorsReader(st).keys()})
    if os.path.exists(bin_index):
        with open(bin_index) as f:
            weight_map = json.load(f)["weight_map"]
        sd: Dict[str, Any] = {}
        for fname in sorted(set(weight_map.values())):
            sd.update(_torch_load(os.path.join(path, fname)))
        return sd
    if os.path.exists(bin_):
        return _torch_load(bin_)
    raise FileNotFoundError(
        f"no model.safetensors[.index.json] or pytorch_model.bin"
        f"[.index.json] under {path!r}")


def load_inference_checkpoint(path: str, dtype=None, device=None
                              ) -> Tuple[Any, Any]:
    """HF checkpoint directory → ``(InferenceTransformerConfig, params)``
    through the policy table, with no model object; with ``device``, each
    tensor is converted there as it is read."""
    from deepspeed_tpu_torch.module_inject.policies import convert_hf_model
    config = load_hf_config(path)
    view = CheckpointModelView(load_state_dict(path), config, device=device)
    return convert_hf_model(view, dtype=dtype or torch.bfloat16)
