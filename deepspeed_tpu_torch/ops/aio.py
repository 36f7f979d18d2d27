"""Async file IO handle over the C++ aio pool (``ops/csrc/aio.cpp``).

Counterpart of ``deepspeed_tpu/ops/aio.py`` (reference ``deepspeed/ops/
aio``, ``csrc/aio/py_lib/py_ds_aio.cpp``): ``pwrite`` / ``pread`` queue a
request on the pool's threads and return at once; ``wait`` blocks until
every queued request is done and returns how many failed. Buffers are
contiguous CPU tensors (pinned or not) or numpy arrays; the handle keeps
each one alive until ``wait`` returns, so a caller may drop its own
reference right after queuing. A file holds the buffer's raw bytes.

The library is built by g++ on first use (``ops/op_builder.
HostOpBuilder``, beside the host Adam); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import HostOpBuilder

_i64 = ctypes.c_int64


def _bind(lib) -> None:
    lib.dstpu_aio_create.argtypes = [ctypes.c_int]
    lib.dstpu_aio_create.restype = ctypes.c_void_p
    lib.dstpu_aio_destroy.argtypes = [ctypes.c_void_p]
    lib.dstpu_aio_destroy.restype = None
    for fn in (lib.dstpu_aio_pwrite, lib.dstpu_aio_pread):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                       _i64, _i64]
        fn.restype = None
    lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p]
    lib.dstpu_aio_wait.restype = _i64


AIO = HostOpBuilder("aio", _bind)


def _addr(buf, writeable: bool):
    """``(address, nbytes)`` of a contiguous host buffer."""
    if torch.is_tensor(buf):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors, "
                             f"got one on {buf.device} (contiguous="
                             f"{buf.is_contiguous()})")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not isinstance(buf, np.ndarray) or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous numpy arrays "
                         "or CPU tensors")
    if writeable and not buf.flags["WRITEABLE"]:
        raise ValueError("pread needs a writeable buffer")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    def __init__(self, num_threads: int = 4):
        self._lib = AIO.load()
        self._h = self._lib.dstpu_aio_create(num_threads)
        if not self._h:
            raise RuntimeError("failed to create aio handle")
        self._keepalive: List = []

    def pwrite(self, path: str, buf, offset: int = 0) -> None:
        ptr, n = _addr(buf, False)
        self._keepalive.append(buf)   # alive until wait()
        self._lib.dstpu_aio_pwrite(self._h, os.fsencode(path),
                                   ctypes.c_void_p(ptr), n, offset)

    def pread(self, path: str, buf, offset: int = 0) -> None:
        ptr, n = _addr(buf, True)
        self._keepalive.append(buf)
        self._lib.dstpu_aio_pread(self._h, os.fsencode(path),
                                  ctypes.c_void_p(ptr), n, offset)

    def wait(self) -> int:
        """Block until every queued request finished; returns the number
        that failed."""
        errs = int(self._lib.dstpu_aio_wait(self._h))
        self._keepalive = []
        return errs

    def close(self) -> None:
        if getattr(self, "_h", None):
            self.wait()
            self._lib.dstpu_aio_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
