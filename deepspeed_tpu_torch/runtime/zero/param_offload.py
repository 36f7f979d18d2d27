"""ZeRO-3 parameter offload to host memory (``offload_param: cpu``).

Counterpart of the ``device="cpu"`` part of
``deepspeed_tpu/runtime/zero/param_offload.py`` (reference ``offload_param``,
``stage3.py:448,466``). Between steps the 16-bit params live in pinned host
memory (:func:`to_pinned`). For a step they reach the card one of two ways:

* A model that declares ``handles_param_offload`` (GPT-2 with
  ``offload_params=True``) fetches each weight itself where it is used,
  inside its checkpointed block, through the engine's
  :class:`ParamFetcher`: the backward recompute fetches the block again,
  so the card holds only a few layers' weights at a time.
* Any other model gets the whole tree staged to the card before the step
  and dropped after it (:func:`stage`), the JAX engine's path on backends
  without in-program host fetches (JAX ``runtime/engine.py:1173-1180``).

Where the gradients land: a fetched weight's host tensor is not an
autograd input. :class:`_Fetch`'s backward hands the gradient of the
device copy (autograd has already summed a weight's uses, as it would for
a device leaf) to the engine's f32 accumulator on the card, and returns
nothing for the host tensor, so no gradient crosses to the host in the
backward pass; the gradients leave the card once, in the optimizer step.

Over several ranks at stage 3 the same fetch all-gathers the layer's
blocks (the engine's ``gather``) and the engine's sink reduce-scatters the
gradient onto the rank's block.

With ``device="nvme"`` the params' home between steps is a set of swap
files under ``nvme_path`` (:class:`ParamSwapper`, JAX's): the engine swaps
them out after each step, leaving tensors on the ``meta`` device (shapes
only) in ``engine.params``, and back into pinned host memory before the
next, where the ``cpu`` tier keeps them and the fetch above finds them.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.utils.logging import logger


def to_pinned(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies of ``params`` (page-locked when a card is present, so
    the copies to it run asynchronously)."""
    pin = torch.cuda.is_available()
    out = {}
    for k, v in params.items():
        t = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        out[k] = t.copy_(v.detach())
    return out


def stage(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Device copies of the host params for one step, autograd leaves."""
    return {k: v.detach().to(device, non_blocking=True, copy=True)
            .requires_grad_(True) for k, v in params.items()}


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, host, device, name, sink, gather):
        ctx.name, ctx.sink = name, sink
        if gather is not None:
            return gather(name, host.detach().to(device, non_blocking=True))
        return host.detach().to(device, non_blocking=True, copy=True)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink(ctx.name, grad)
        return None, None, None, None, None


class ParamFetcher:
    """The fetch a ``handles_param_offload`` model calls: ``fetch(name,
    host_tensor)`` returns the weight on ``device``; in the backward pass
    the weight's gradient goes to ``sink(name, grad)``. ``gather(name,
    t)``, when given, makes the whole weight from ``t`` on the card (the
    engine's all-gather of a stage-3 block over ranks)."""

    def __init__(self, device, sink: Callable[[str, torch.Tensor], None],
                 gather: Optional[Callable] = None):
        self.device = device
        self.sink = sink
        self.gather = gather

    def __call__(self, name: str, host: torch.Tensor) -> torch.Tensor:
        return _Fetch.apply(host, self.device, name, self.sink, self.gather)


class ParamSwapper:
    """Spills the host-resident params to swap files between steps
    (counterpart of JAX ``runtime/zero/param_offload.py`` ``ParamSwapper``;
    reference ``partitioned_param_swapper.py`` + ``async_swapper.py``).

    :meth:`swap_out` queues every leaf's write on the aio pool, draining
    whenever ``inflight_bytes`` of buffers are queued, and returns tensors
    on the ``meta`` device: shapes and dtypes only. :meth:`swap_in` queues
    every leaf's read into pinned host memory and waits once (JAX reads
    one leaf ahead of its ``device_put``; here the leaves stay on the
    host, so there is nothing to overlap a read with)."""

    def __init__(self, swap_dir: str, num_threads: int = 4,
                 inflight_bytes: int = 256 << 20):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.aio = AsyncIOHandle(num_threads)
        self.inflight_bytes = inflight_bytes
        self.on_disk = False
        self._meta: Optional[dict] = None
        self.last_bytes = 0
        logger.info(f"offload_param: NVMe param swapper at {swap_dir}")

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_").replace(".", "_")
        return os.path.join(self.swap_dir, f"param_{safe}.swp")

    def _drain(self, what: str) -> None:
        if self.aio.wait() != 0:
            raise IOError(f"param {what} failed")

    def swap_out(self, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        if self._meta is None:
            self._meta = {k: (tuple(v.shape), v.dtype)
                          for k, v in params.items()}
        staged = total = 0
        for k, v in params.items():
            buf = v.detach()
            if buf.device.type != "cpu" or not buf.is_contiguous():
                buf = buf.to("cpu").contiguous()
            self.aio.pwrite(self._path(k), buf)
            nbytes = buf.numel() * buf.element_size()
            staged += nbytes
            total += nbytes
            if staged >= self.inflight_bytes:
                # the handle keeps queued buffers alive until wait():
                # drain before queuing another threshold's worth
                self._drain("swap-out")
                staged = 0
        self._drain("swap-out")
        self.on_disk = True
        self.last_bytes = total
        return {k: torch.empty(shape, dtype=dtype, device="meta")
                for k, (shape, dtype) in self._meta.items()}

    def swap_in(self) -> Dict[str, torch.Tensor]:
        if not self.on_disk:
            raise RuntimeError("swap_in with no params on disk")
        pin = torch.cuda.is_available()
        out = {}
        for k, (shape, dtype) in self._meta.items():
            out[k] = torch.empty(shape, dtype=dtype, pin_memory=pin)
            self.aio.pread(self._path(k), out[k])
        # every leaf stays resident: queue them all, the pool's threads
        # share the reads, and wait once
        self._drain("swap-in")
        self.on_disk = False
        return out

    def close(self) -> None:
        self.aio.close()
