"""ZeRO memory-needs estimators (planning API).

Counterpart of ``deepspeed_tpu/runtime/zero/memory_estimators.py``
(reference ``estimate_zero2_model_states_mem_needs*`` /
``estimate_zero3_model_states_mem_needs*``, ``stage_1_and_2.py:2387-2472``,
``stage3.py:2409-2544``), with the same numbers: the port's engine keeps
the JAX engine's memory model, which differs from the reference's
fp16+fp32 layout:

* compute params: bf16, 2 B/param — replicated below stage 3, sharded
  over the ZeRO axis at stage 3 (or resident on the host with
  ``offload_param``, leaving ~the largest layer on the device).
* fp32 master + Adam moments: 12 B/param, sharded over the ZeRO axis
  from stage 1, or in host memory with ``offload_optimizer``.
* gradients: fp32, 4 B/param, transient within the step — sharded from
  stage 2; the accumulator persists across the micro-batches at the
  same size (``data_types.grad_accum_dtype`` halves it).

``num_chips`` counts devices (GPUs here). Estimates are *model states
only*: activations depend on remat and the micro-batch. The ``*_all_live``
variants take a live parameter dict (``{name: tensor}``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

GB = 1 << 30


def _fmt(n: float) -> str:
    return f"{n / GB:.2f}GB"


def estimate_zero_model_states_mem_needs(
        total_params: int,
        largest_layer_params: int = 0,
        stage: int = 2,
        num_chips: int = 1,
        offload_optimizer: bool = False,
        offload_param: bool = False,
        grad_accum_bytes: int = 4,
        additional_buffer_factor: float = 1.5) -> Dict[str, int]:
    """Per-chip HBM and per-host RAM bytes for the model states."""
    shard = num_chips if stage >= 1 else 1
    grad_shard = num_chips if stage >= 2 else 1
    param_shard = num_chips if stage >= 3 else 1

    hbm = 0
    host = 0
    # compute params (bf16)
    if offload_param and stage >= 3:
        host += 2 * total_params
        hbm += 2 * largest_layer_params
    else:
        hbm += 2 * total_params // param_shard
    # master + moments (fp32 x3)
    if offload_optimizer:
        host += 12 * total_params
    else:
        hbm += 12 * total_params // shard
    # transient grads + GAS accumulator
    hbm += (4 + grad_accum_bytes) * total_params // grad_shard
    return {"hbm_per_chip": int(hbm),
            "host_ram": int(host * additional_buffer_factor)}


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _count(params: Any) -> (int, int):
    sizes = [int(np.prod(tuple(x.shape))) for x in _leaves(params)]
    return sum(sizes), max(sizes, default=0)


def estimate_zero2_model_states_mem_needs_all_live(
        params: Any, num_chips: int = 1, num_nodes: int = 1,
        additional_buffer_factor: float = 1.5) -> None:
    """Print the stage-1/2 option table for a live param tree
    (reference ``*_all_live`` shape — prints, returns None)."""
    total, _ = _count(params)
    _print_table(total, 0, (1, 2), num_chips * num_nodes,
                 additional_buffer_factor)


def estimate_zero3_model_states_mem_needs_all_live(
        params: Any, num_chips: int = 1, num_nodes: int = 1,
        additional_buffer_factor: float = 1.5) -> None:
    total, largest = _count(params)
    _print_table(total, largest, (3,), num_chips * num_nodes,
                 additional_buffer_factor)


def estimate_zero2_model_states_mem_needs_all_cold(
        total_params: int, num_chips: int = 1, num_nodes: int = 1,
        additional_buffer_factor: float = 1.5) -> None:
    """Cold variant: param count only, no tree needed."""
    _print_table(total_params, 0, (1, 2), num_chips * num_nodes,
                 additional_buffer_factor)


def estimate_zero3_model_states_mem_needs_all_cold(
        total_params: int, largest_layer_params: int,
        num_chips: int = 1, num_nodes: int = 1,
        additional_buffer_factor: float = 1.5) -> None:
    _print_table(total_params, largest_layer_params, (3,),
                 num_chips * num_nodes, additional_buffer_factor)


def _print_table(total, largest, stages, chips, buf) -> None:
    print(f"Estimated memory needed for params, optim states and "
          f"gradients for a:\n"
          f"chips={chips} total_params={total / 1e6:.0f}M "
          f"largest_layer={largest / 1e6:.0f}M")
    print(f"{'per-chip HBM':>14} | {'host RAM':>10} | options")
    for stage in stages:
        for off_opt in (False, True):
            offs = ((False, True) if stage >= 3 else (False,))
            for off_par in offs:
                est = estimate_zero_model_states_mem_needs(
                    total, largest, stage=stage, num_chips=chips,
                    offload_optimizer=off_opt, offload_param=off_par,
                    additional_buffer_factor=buf)
                opts = (f"stage={stage} offload_optimizer={off_opt}"
                        + (f" offload_param={off_par}"
                           if stage >= 3 else ""))
                print(f"{_fmt(est['hbm_per_chip']):>14} | "
                      f"{_fmt(est['host_ram']):>10} | {opts}")
