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

The NVMe tier (``ParamSwapper``) is ROADMAP.md A6c.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


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
