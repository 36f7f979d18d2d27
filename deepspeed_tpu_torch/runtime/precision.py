"""Mixed precision: dtypes and dynamic fp16 loss scaling.

Counterpart of ``deepspeed_tpu/runtime/precision.py`` (reference
``deepspeed/runtime/fp16/loss_scaler.py``). The loss-scale state holds
device tensors and :func:`update_loss_scale` is branch-free
(``torch.where``), so a step never has to read it on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch


@dataclasses.dataclass
class LossScaleState:
    scale: torch.Tensor            # f32 scalar
    growth_tracker: torch.Tensor   # i32: consecutive non-overflow steps
    hysteresis: torch.Tensor       # i32: overflows still tolerated before a cut
    # static config
    min_scale: float = 1.0
    growth_interval: int = 1000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    init_hysteresis: int = 2
    dynamic: bool = True


def make_loss_scale(fp16_config=None, device=None) -> LossScaleState:
    """From an ``FP16Config`` section: static when ``loss_scale != 0``,
    as in ``fp16/loss_scaler.py``; 1.0 and static without fp16."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    if fp16_config is None or not fp16_config.enabled:
        return LossScaleState(scale=f32(1.0), growth_tracker=i32(0),
                              hysteresis=i32(1), dynamic=False)
    dynamic = fp16_config.loss_scale == 0.0
    init = (2.0 ** fp16_config.initial_scale_power if dynamic
            else fp16_config.loss_scale)
    return LossScaleState(
        scale=f32(init), growth_tracker=i32(0),
        hysteresis=i32(fp16_config.hysteresis),
        min_scale=float(fp16_config.min_loss_scale),
        growth_interval=int(fp16_config.loss_scale_window),
        init_hysteresis=int(fp16_config.hysteresis), dynamic=dynamic)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Device bool: every element of every gradient is finite."""
    grads = list(grads)
    if not grads:
        return torch.tensor(True)
    flags = torch.stack([torch.isfinite(g).all() for g in grads])
    return flags.all()


def update_loss_scale(state: LossScaleState,
                      finite: torch.Tensor) -> LossScaleState:
    """``DynamicLossScaler.update_scale``: on overflow spend one unit of
    hysteresis, and when none is left cut the scale (not below
    ``min_scale``) and restore the hysteresis; after ``growth_interval``
    good steps in a row, grow the scale."""
    if not state.dynamic:
        return state
    hyst = state.hysteresis - 1
    cut = hyst <= 0
    over_scale = torch.where(
        cut, torch.clamp(state.scale * state.backoff_factor,
                         min=state.min_scale), state.scale)
    over_hyst = torch.where(cut, torch.full_like(hyst, state.init_hysteresis),
                            hyst)
    tracker = state.growth_tracker + 1
    grow = tracker >= state.growth_interval
    good_scale = torch.where(grow, state.scale * state.growth_factor,
                             state.scale)
    good_tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
    return dataclasses.replace(
        state,
        scale=torch.where(finite, good_scale, over_scale),
        growth_tracker=torch.where(finite, good_tracker,
                                   torch.zeros_like(tracker)),
        hysteresis=torch.where(finite, state.hysteresis, over_hyst))


def cast_tree(tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Floating leaves of a flat dict cast to ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


PRECISION_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
