"""Activation checkpointing: the ``deepspeed.checkpointing`` API.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``
(reference ``runtime/activation_checkpointing/checkpointing.py``:
Megatron-compatible ``checkpoint()`` :372, ``configure()`` from the JSON
``activation_checkpointing`` section). The mapping, field by field:

* recompute in the backward pass → ``torch.utils.checkpoint.checkpoint(
  ..., use_reentrant=False)``: only the region's inputs outlive the forward
  pass, everything else is recomputed.
* ``partition_activations`` (reference :372, shard the stashed input over
  the model-parallel ranks, all-gather it for the backward :259) → each
  saved region input of 2 or more dims keeps only the rank's block of
  dim 1 over the ``seq`` group, and the recompute all-gathers it back (JAX
  ``_constrain_saved``); off a mesh with ``seq`` above 1 it changes
  nothing.
* ``cpu_checkpointing`` → on CUDA the checkpoint runs under
  ``torch.autograd.graph.save_on_cpu(pin_memory=True)``: the region's
  tensor inputs, which are what a non-reentrant checkpoint saves (under
  the caller's saved-tensor hooks; the region's own saved tensors go to
  the checkpoint's inner hooks), go to pinned host memory and come back
  for the recompute (JAX stages them to ``pinned_host`` and fetches them
  back inside the remat region). On the CPU it warns once and keeps them
  where they are, as JAX does off the TPU.
* ``number_checkpoints`` → the segment count of
  :func:`checkpoint_sequential`.
* ``profile`` → each region runs under ``torch.profiler.record_function(
  "act-ckpt")``, so a profiler trace attributes its time.
* ``contiguous_memory_optimization`` / ``synchronize_checkpoint_boundary``
  → refused (``NotImplementedError``).

:func:`model_parallel_seed` stands for the reference's
``model_parallel_cuda_manual_seed`` / ``CudaRNGStatesTracker``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from deepspeed_tpu_torch.utils.logging import logger

_CONFIG = None
_CONFIGURED_BY_ENGINE = False
_WARNED_CPU_FALLBACK = False


def configure(config=None, _by_engine: bool = False, **kwargs) -> None:
    """Install the activation-checkpointing config (reference
    ``configure``; the engine calls it when the JSON section is present).
    Takes an ``ActivationCheckpointingConfig`` or its fields as keywords.
    Process-global, as in the reference; the engine records that it
    installed the config, so a later engine without the section clears an
    engine-installed one and never a user's own ``configure()``."""
    global _CONFIG, _CONFIGURED_BY_ENGINE
    from deepspeed_tpu_torch.config.config import \
        ActivationCheckpointingConfig
    if config is None:
        config = ActivationCheckpointingConfig(**kwargs)
    if config.contiguous_memory_optimization:
        raise NotImplementedError(
            "contiguous_memory_optimization: the port recomputes through "
            "torch.utils.checkpoint, whose saved inputs are the caching "
            "allocator's blocks; there is no contiguous checkpoint buffer "
            "to manage (reference checkpointing.py contiguous buffers)")
    if config.synchronize_checkpoint_boundary:
        raise NotImplementedError(
            "synchronize_checkpoint_boundary: the port's recompute runs on "
            "the caller's stream in order, so there is no boundary to "
            "synchronize; use profile=True and a torch.profiler trace")
    _CONFIG = config
    _CONFIGURED_BY_ENGINE = _by_engine
    logger.info("activation checkpointing configured: "
                f"partition_activations={config.partition_activations} "
                f"cpu_checkpointing={config.cpu_checkpointing} "
                f"number_checkpoints={config.number_checkpoints}")


def is_configured() -> bool:
    return _CONFIG is not None


def reset(only_engine_installed: bool = False) -> None:
    global _CONFIG, _CONFIGURED_BY_ENGINE
    if only_engine_installed and not _CONFIGURED_BY_ENGINE:
        return
    _CONFIG = None
    _CONFIGURED_BY_ENGINE = False


def _axis(name: str):
    """``(index, size)`` of this rank on mesh axis ``name``; ``(0, 1)``
    without a process group and a global mesh."""
    from deepspeed_tpu_torch.comm import mesh as mesh_mod
    if not (dist.is_initialized() and mesh_mod.has_global_mesh()):
        return 0, 1
    return mesh_mod.axis_index(name), mesh_mod.axis_size(name)


def model_parallel_seed(seed: int, device=None) -> torch.Generator:
    """A generator seeded per tensor-parallel rank (reference
    ``model_parallel_cuda_manual_seed``: ``seed + 2718 + tp_rank``), so
    that dropout masks differ across tensor ranks and agree across data
    ranks. A recompute that draws from it must get the generator's state
    back (``torch.utils.checkpoint`` keeps the default generators' state,
    not this one's)."""
    rank, _ = _axis("tensor")
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(int(seed) + 2718 + rank)
    return g


class _PartitionedCheckpoint(torch.autograd.Function):
    """A remat region whose saved tensor inputs keep only the rank's block
    of dim 1 over ``seq`` (JAX ``_constrain_saved``): the forward runs
    without a graph; the backward all-gathers the blocks, recomputes the
    region and backpropagates through it. The input is the same on every
    seq rank (a region that the seq axis does not split), so is its
    gradient. As in a reentrant checkpoint, the weights the region closes
    over get their gradients in ``.grad``."""

    @staticmethod
    def forward(ctx, run, parted, *args):
        ctx.run = run
        ctx.parted = parted
        blocks, keep = [], []
        for a, p in zip(args, parted):
            if p:
                idx, size = _axis("seq")
                n = a.shape[1] // size
                blocks.append(a.narrow(1, idx * n, n).contiguous())
            else:
                keep.append(a)
        ctx.grad_in = [torch.is_tensor(a) and a.requires_grad
                       for a in args]
        ctx.save_for_backward(*blocks,
                              *[a for a in keep if torch.is_tensor(a)])
        ctx.others = [None if torch.is_tensor(a) else a for a in keep]
        with torch.no_grad():
            return run(*args)

    @staticmethod
    def backward(ctx, *grads):
        from deepspeed_tpu_torch.comm import comm
        saved = iter(ctx.saved_tensors)
        blocks = [next(saved) for p in ctx.parted if p]
        kept = list(saved)
        bi, ki, others = iter(blocks), iter(kept), iter(ctx.others)
        args = []
        for p, want in zip(ctx.parted, ctx.grad_in):
            if p:   # the whole input again, from every seq rank's block
                t = comm.all_gather(next(bi), "seq", axis=1)
            else:
                o = next(others)
                t = next(ki) if o is None else o
            if torch.is_tensor(t):
                t = t.detach().requires_grad_(want)
            args.append(t)
        with torch.enable_grad():
            out = ctx.run(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if torch.is_tensor(o) and o.requires_grad and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None, *[a.grad if want else None
                              for a, want in zip(args, ctx.grad_in)])


def _partitioned(args):
    """Which of ``args`` keep only their ``seq`` block when saved."""
    _, size = _axis("seq")
    return [size > 1 and torch.is_tensor(a) and a.dim() >= 2 and
            a.shape[1] % size == 0 for a in args]


def checkpoint(function, *args):
    """Run ``function(*args)`` as a remat region (reference
    ``checkpoint`` :372): only the inputs outlive the forward pass, the
    rest is recomputed in the backward pass, the inputs kept as the
    installed config says."""
    global _WARNED_CPU_FALLBACK
    cfg = _CONFIG
    if cfg is None:
        return torch.utils.checkpoint.checkpoint(function, *args,
                                                 use_reentrant=False)
    region = function
    if cfg.profile:
        def region(*a, _fn=function):
            with torch.profiler.record_function("act-ckpt"):
                return _fn(*a)
    parted = (_partitioned(args) if cfg.partition_activations
              else [False] * len(args))
    if any(parted):
        return _PartitionedCheckpoint.apply(region, parted, *args)
    if cfg.cpu_checkpointing:
        if any(torch.is_tensor(a) and a.is_cuda for a in args):
            with torch.autograd.graph.save_on_cpu(pin_memory=True):
                return torch.utils.checkpoint.checkpoint(
                    region, *args, use_reentrant=False)
        if not _WARNED_CPU_FALLBACK:
            logger.warning("cpu_checkpointing needs CUDA tensors; keeping "
                           "the checkpoints where they are")
            _WARNED_CPU_FALLBACK = True
    return torch.utils.checkpoint.checkpoint(region, *args,
                                             use_reentrant=False)


def checkpoint_sequential(functions: Sequence, x: Any,
                          segments: Optional[int] = None):
    """Apply ``functions`` in order with one remat region a segment;
    ``number_checkpoints`` (else one a function) sets how many, and the
    segment bounds are JAX's (``round(i * n / segments)``)."""
    n = len(functions)
    if segments is None:
        segments = (_CONFIG.number_checkpoints
                    if _CONFIG is not None and _CONFIG.number_checkpoints
                    else n)
    segments = max(1, min(segments, n))
    bounds = [round(i * n / segments) for i in range(segments + 1)]
    for i in range(segments):
        fns = functions[bounds[i]:bounds[i + 1]]
        if not fns:
            continue

        def seg(h, _fns=tuple(fns)):
            for f in _fns:
                h = f(h)
            return h
        x = checkpoint(seg, x)
    return x
