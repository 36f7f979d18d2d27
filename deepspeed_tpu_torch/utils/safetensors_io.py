"""The safetensors file format, written and read without the package.

``deepspeed_tpu`` writes ``save_16bit_model`` and the serving checkpoint
with the ``safetensors`` package, which a machine with the port need not
have. The format is small enough to keep here:

* 8 bytes, little-endian: ``N``, the header's length;
* ``N`` bytes of UTF-8 JSON: for each tensor ``{"dtype": "BF16", "shape":
  [...], "data_offsets": [begin, end]}`` (offsets into the data that
  follows), and an optional ``"__metadata__"`` of strings; padded with
  spaces to a multiple of 8;
* the tensors' raw little-endian bytes, back to back, with no gap.

:func:`save_file` writes that layout (atomically: ``.tmp`` and a rename),
:func:`save_sharded` HF's sharded layout of several such files and an
index; :func:`load_file`, :class:`SafetensorsReader` (one tensor at a
time, by name) and :func:`read_header` read it, bf16 included, so either
package reads the other's files.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flat_bytes(t: torch.Tensor):
    """A contiguous CPU tensor's bytes as a numpy uint8 view (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time)
    as one safetensors file at ``path``."""
    src, header, offset = {}, {}, 0
    for name in sorted(tensors):
        t = tensors[name].detach()
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        src[name] = t
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in sorted(src):
            t = src[name].to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(_flat_bytes(t)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_header(path: str) -> Dict[str, dict]:
    """The JSON header of a safetensors file (``__metadata__`` included)
    and, under ``"__data_start__"``, the byte where the data begins."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode())
    header["__data_start__"] = 8 + n
    return header


class SafetensorsReader:
    """A safetensors file read one tensor at a time, by name: the header
    is read once, each tensor only when asked for, so host memory holds
    one tensor at a time."""

    def __init__(self, path: str):
        self.path = path
        header = read_header(path)
        self._start = header.pop("__data_start__")
        header.pop("__metadata__", None)
        self._meta = header

    def keys(self):
        return self._meta.keys()

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        """One seek and one read of the tensor's bytes straight into a new
        host tensor (a bf16 tensor's raw 16-bit words viewed as
        ``torch.bfloat16``), then onto ``device`` (default: left on the
        host)."""
        meta = self._meta[name]
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise TypeError(f"{name}: unsupported safetensors dtype "
                            f"{meta['dtype']!r} in {self.path}")
        begin, end = meta["data_offsets"]
        raw = torch.empty(end - begin, dtype=torch.uint8)
        if end > begin:
            with open(self.path, "rb") as f:
                f.seek(self._start + begin)
                n = f.readinto(memoryview(raw.numpy()))
            if n != end - begin:
                raise ValueError(f"{self.path}: tensor {name!r} is "
                                 "truncated")
        t = raw.view(dtype).reshape(meta["shape"])
        return t if device is None else t.to(device)


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on ``device`` (default the
    host)."""
    reader = SafetensorsReader(path)
    return {name: reader.get_tensor(name, device) for name in reader.keys()}


def save_sharded(tensors: Dict[str, torch.Tensor], directory: str,
                 max_shard_bytes: int) -> List[str]:
    """Write ``tensors`` as HF's sharded layout under ``directory``:
    ``model-00001-of-0000N.safetensors`` files of at most
    ``max_shard_bytes`` each (a larger tensor gets a file of its own), in
    name order, and ``model.safetensors.index.json`` mapping each name to
    its file. Returns the shard file names."""
    shards: List[Dict[str, torch.Tensor]] = [{}]
    size = 0
    for name in sorted(tensors):
        n = tensors[name].numel() * tensors[name].element_size()
        if shards[-1] and size + n > max_shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = tensors[name]
        size += n
    files = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
             for i in range(len(shards))]
    weight_map = {}
    for fname, shard in zip(files, shards):
        save_file(shard, os.path.join(directory, fname))
        weight_map.update({name: fname for name in shard})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    return files
