"""Which kernel width the attention kernels run a head dim at.

Every CUDA attention kernel (B1-B8, the int8 B5i-B7i too) is
instantiated at widths ``DK`` = 64, 128 and 256. A head dim ``D <= DK``
runs on the narrowest ``DK`` that holds it, with the true ``D`` passed to
the kernel: every load reads zeros past ``D`` and every store stops there,
and zero columns change neither ``q.k`` nor ``P.V``. That needs each row
of ``D`` elements to be a whole number of 16-byte chunks (the kernels'
copy unit); any other ``D`` is zero-padded to ``DK`` by the wrapper, one
copy per operand. No kernel takes a head dim above 256: fault D1c.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.utils.logging import logger

MAX_HEAD_DIM = 256      # the kernels' widest instantiation


def head_dim_route(D: int, elem_size: int) -> Tuple[int, bool]:
    """``(DK, pad)`` for head dim ``D`` of operands ``elem_size`` bytes an
    element (the narrowest operand's: 1 for an int8 pool): the kernel width
    ``DK`` (64, 128 or 256, the narrowest that holds ``D``) and whether the
    operands must be zero-padded to ``DK`` (a row of ``D`` elements is not
    a whole number of 16-byte chunks). Raises ``ValueError`` above 256,
    naming the fault that logs it."""
    if D < 1:
        raise ValueError(f"head dim must be >= 1, got {D}")
    if D > MAX_HEAD_DIM:
        raise ValueError(
            f"the attention kernels take head dims up to {MAX_HEAD_DIM}, got "
            f"{D} (fault D1c: no kernel takes a head dim above 256); the "
            f"plain version on the CPU takes it")
    DK = 64 if D <= 64 else 128 if D <= 128 else 256
    return DK, (D * elem_size) % 16 != 0


def pad_head_dim(x: torch.Tensor, DK: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``DK``: a contiguous copy.
    Raises while a CUDA graph is being captured: a captured copy of a
    layer's whole cache or pool would live in the graph's private memory
    pool for the graph's life, beside the pool it copies."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the padded head-dim route (head dim {x.shape[-1]} padded to "
            f"{DK}) copies the whole cache or pool on every call, so a "
            f"step that takes it is not captured in a CUDA graph")
    return F.pad(x, (0, DK - x.shape[-1]))


def unpad_head_dim(x: torch.Tensor, D: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first ``D`` columns of a padded route's result: a contiguous
    copy, or written into ``out``."""
    return x[..., :D].contiguous() if out is None else out.copy_(x[..., :D])


def warn_if_padded(what: str, D: int, elem_size: int, device) -> bool:
    """Warn, when a KV cache or pool is built, that its head dim ``D``
    (``elem_size`` bytes an element; 1 for an int8 pool) takes the padded
    route on a CUDA ``device``: every attention call of a layer then copies
    that layer's whole cache or pool. Returns whether it does."""
    if torch.device(device).type != "cuda" or D > MAX_HEAD_DIM:
        return False
    DK, pad = head_dim_route(D, elem_size)
    if pad:
        logger.warning(
            f"{what}: head dim {D} at {elem_size} byte(s) an element is no "
            f"whole number of 16-byte chunks, so each attention call pads "
            f"the layer's whole cache to {DK} columns (one copy a call); "
            f"size the cache with that copy in mind")
    return pad
