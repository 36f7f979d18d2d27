"""Checkpoint engine abstraction.

Counterpart of ``deepspeed_tpu/checkpoint/checkpoint_engine.py`` (the
reference's ``CheckpointEngine`` with create/save/load/commit, and its
Torch (sync) and Nebula (async) implementations). The JAX package writes
``<tag>/state`` with orbax; here ``<tag>/state`` is a directory too, so the
loader's legacy rung (``os.path.isdir(.../state)``) and the manifest walk
see the same layout. It holds one ``torch.save`` file per group of the
state (``master.pt``, ``optimizer.pt``, ``loss_scale.pt``), each written
atomically (``.tmp``, fsync, rename). :meth:`load` returns the groups on
the host, read with ``weights_only=True`` and ``mmap=True``: no data is
read until the caller copies a tensor into its own, so a load never holds
a second copy of the state on the card.
"""
from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict

import torch

from deepspeed_tpu_torch.utils.logging import logger

State = Dict[str, Dict[str, Any]]


class CheckpointEngine(ABC):
    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str) -> None:
        """Log/prepare for a save under ``tag`` (reference ``create``)."""
        logger.info(f"[ckpt-engine] saving {tag}")

    @abstractmethod
    def save(self, state_dict: State, path: str) -> None: ...

    @abstractmethod
    def load(self, path: str, abstract_state: Any = None,
             map_location=None) -> State: ...

    @abstractmethod
    def commit(self, tag: str) -> bool:
        """Block until ``tag`` is durable (reference ``commit``)."""

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def close(self) -> None:
        """Release background resources (the async writer thread and its
        host buffers). Called from ``engine.destroy()`` after the pending
        finalize joined — idempotent, and a no-op for synchronous
        engines."""


def _map(group, fn):
    """``fn`` on every tensor of a (nested) dict; other leaves as they
    are."""
    if isinstance(group, dict):
        return {k: _map(v, fn) for k, v in group.items()}
    return fn(group) if torch.is_tensor(group) else group


def _write_state(state: State, path: str) -> None:
    """One ``<group>.pt`` per group under ``path``, each atomically."""
    os.makedirs(path, exist_ok=True)
    for name, group in state.items():
        final = os.path.join(path, f"{name}.pt")
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(group, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)


def _read_state(path: str, map_location=None) -> State:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint state under {path!r}")
    return {fname[:-3]: torch.load(os.path.join(path, fname),
                                   map_location=map_location or "cpu",
                                   weights_only=True, mmap=True)
            for fname in sorted(os.listdir(path)) if fname.endswith(".pt")}


class TorchCheckpointEngine(CheckpointEngine):
    """Synchronous save/restore (the reference's TorchCheckpointEngine):
    ``save`` copies each group to the host and writes it before it
    returns."""

    def save(self, state_dict: State, path: str) -> None:
        for name, group in state_dict.items():
            _write_state({name: _map(group, lambda t: t.detach().to(
                "cpu", copy=True))}, path)

    def load(self, path: str, abstract_state: Any = None,
             map_location=None) -> State:
        return _read_state(path, map_location)

    def commit(self, tag: str) -> bool:
        return True


class AsyncCheckpointEngine(CheckpointEngine):
    """Background persistence (the reference's NebulaCheckpointEngine):
    ``save`` copies the state into host buffers (pinned for device
    tensors, kept for the next save of the same shapes) and returns once
    the copy is complete, so a training step that then updates the
    tensors in place cannot reach the snapshot; a writer thread persists
    it and ``commit`` waits for durability."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._writer = None
        self._error = None

    def _snapshot(self, state_dict: State) -> State:
        devices = set()

        def copy(path, t):
            t = t.detach()
            key = (path, tuple(t.shape), t.dtype)
            buf = self._buffers.get(key)
            if buf is None:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self._buffers[key] = buf
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
            return buf

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
            return copy(path, node) if torch.is_tensor(node) else node

        snap = walk(state_dict, "")
        for dev in devices:   # the copies are done before save returns
            torch.cuda.current_stream(dev).synchronize()
        return snap

    def save(self, state_dict: State, path: str) -> None:
        self._join()   # one write in flight: its buffers are reused
        snap = self._snapshot(state_dict)

        def write():
            try:
                _write_state(snap, path)
            except Exception as e:  # noqa: BLE001 — re-raised by commit
                self._error = e

        self._writer = threading.Thread(target=write, daemon=False)
        self._writer.start()

    def _join(self) -> None:
        t, self._writer = self._writer, None
        if t is not None:
            t.join()

    def load(self, path: str, abstract_state: Any = None,
             map_location=None) -> State:
        self._join()
        return _read_state(path, map_location)

    def commit(self, tag: str) -> bool:
        self._join()
        err, self._error = self._error, None
        if err is not None:
            # name the tag, so the finalize error (stashed and re-raised
            # at the next save/load) says WHICH checkpoint is not durable
            raise RuntimeError(
                f"async checkpoint persist for tag {tag!r} failed: "
                f"{err}") from err
        logger.info(f"[ckpt-engine] committed {tag}")
        return True

    def close(self) -> None:
        """Join the writer and release the host buffers."""
        self._join()
        self._buffers = {}


def make_checkpoint_engine(kind: str = "sync",
                           config_params=None) -> CheckpointEngine:
    if kind in ("sync", "torch", "orbax"):
        return TorchCheckpointEngine(config_params)
    if kind in ("async", "nebula"):
        return AsyncCheckpointEngine(config_params)
    raise ValueError(f"unknown checkpoint engine {kind!r}")
