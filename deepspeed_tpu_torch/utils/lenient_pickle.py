"""A pickle module for ``torch.load`` of checkpoints written elsewhere.

Megatron and DeepSpeed checkpoint blobs carry argparse Namespaces and
``megatron.*`` / ``deepspeed.*`` objects beside the tensors, so
``weights_only=True`` refuses them, and plain pickle would run whatever
callable a file names. :class:`LenientUnpickler` resolves only the globals
that rebuild tensors, arrays and plain containers (``_ALLOWED``); every
other global, importable or not, loads as an inert stub that takes any
arguments and any state and does nothing, so the tensors still load and a
file cannot run code (``os.system`` becomes a stub).

Use: ``torch.load(path, weights_only=False,
pickle_module=LenientUnpickler)``.
"""
from __future__ import annotations

import argparse
import codecs
import collections
import copyreg
import io
import pickle

import numpy as np
import torch

_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("argparse", "Namespace"): argparse.Namespace,
    ("copyreg", "_reconstructor"): copyreg._reconstructor,
    ("_codecs", "encode"): codecs.encode,
    ("builtins", "object"): object,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "slice"): slice,
    ("torch", "Size"): torch.Size,
    ("torch", "device"): torch.device,
    ("torch", "Tensor"): torch.Tensor,
    ("torch._tensor", "_rebuild_from_type_v2"):
        torch._tensor._rebuild_from_type_v2,
    ("torch.nn.parameter", "Parameter"): torch.nn.Parameter,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}
# numpy's array and scalar rebuilders, under the module path of either
# numpy 1 (numpy.core) or numpy 2 (numpy._core)
_NUMPY_CORE = {"_reconstruct": np.zeros(0).__reduce__()[0],
               "scalar": np.float32(0).__reduce__()[0]}


def _allowed(module: str, name: str):
    """The object a checkpoint may name, or None."""
    if (module, name) in _ALLOWED:
        return _ALLOWED[(module, name)]
    if module == "torch._utils" and name.startswith("_rebuild_"):
        return getattr(torch._utils, name, None)
    if module == "torch" and isinstance(getattr(torch, name, None),
                                        torch.dtype):
        return getattr(torch, name)
    if module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        return _NUMPY_CORE.get(name)
    return None


def _stub(name: str) -> type:
    return type(name, (), {"__init__": lambda s, *a, **k: None,
                           "__setstate__": lambda s, _: None,
                           "__reduce__": lambda s: (dict, ())})


class LenientUnpickler:
    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            obj = _allowed(module, name)
            return _stub(name) if obj is None else obj

    @classmethod
    def loads(cls, data, **kwargs):
        return cls.Unpickler(io.BytesIO(data), **kwargs).load()
