"""Optimizers on flat dicts of f32 tensors.

Counterpart of ``deepspeed_tpu/ops/adam.py`` (reference ``FusedAdam``,
``FusedLamb``, ``DeepSpeedCPUAdam``/``Adagrad``): each optimizer is an
``(init, update)`` pair with ``update(grads, state, params, lr) ->
(updates, state)``, the engine adding ``updates`` to the f32 master. The
math is the JAX package's, leaf by leaf. Unlike the JAX version, ``update``
advances the moment buffers of ``state`` in place (and returns the same
state object, its ``count`` one higher): that saves two f32 copies of the
model per step. The per-leaf arithmetic runs as ``torch._foreach_*`` ops,
one launch per op over all leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
from deepspeed_tpu_torch.utils.unported import not_ported

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    count: int   # steps taken (a host int: no device read per step)
    mu: Tree     # first moment
    nu: Tree     # second moment


@dataclasses.dataclass
class SGDState:
    count: int
    mu: Optional[Tree]


@dataclasses.dataclass
class AdagradState:
    count: int
    accum: Tree


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params, lr) -> (updates, state)


def _zeros_like(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _lists(names, *trees):
    return [[t[n] for n in names] for t in trees]


def _bias_corrections(b1, b2, count, bias_correction):
    """``1 - b ** count`` in f32, as JAX computes it (``count`` cast to
    f32): near 1 the power's f32 rounding moves the correction by ~1e-5
    relative at the first steps, and the update with it."""
    if not bias_correction:
        return 1.0, 1.0
    cf = torch.tensor(float(count), dtype=torch.float32)
    return tuple(float(1.0 - torch.tensor(b, dtype=torch.float32) ** cf)
                 for b in (b1, b2))


def adam(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
         adamw_mode: bool = True, bias_correction: bool = True,
         **_) -> Optimizer:
    """AdamW, or Adam with L2 when ``adamw_mode`` is False (reference
    default optimizer, FusedAdam)."""
    b1, b2 = betas

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params),
                         nu=_zeros_like(params))

    def update(grads, state, params, lr):
        names = list(grads)
        g, m, v, p = _lists(names, grads, state.mu, state.nu, params)
        state.count += 1
        bc1, bc2 = _bias_corrections(b1, b2, state.count, bias_correction)
        g = [x.float() for x in g]
        if not adamw_mode and weight_decay > 0.0:
            g = torch._foreach_add(g, p, alpha=weight_decay)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_mul_(upd, -lr)
        if adamw_mode and weight_decay > 0.0:
            torch._foreach_add_(upd, p, alpha=-lr * weight_decay)
        return dict(zip(names, upd)), state

    return Optimizer(init, update)


def lamb(betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0,
         max_coeff: float = 10.0, min_coeff: float = 0.01,
         bias_correction: bool = True, **_) -> Optimizer:
    """LAMB (reference FusedLamb): the Adam direction scaled per leaf by
    the trust ratio ``||p|| / ||direction||`` clamped to ``[min_coeff,
    max_coeff]``."""
    b1, b2 = betas

    def init(params):
        return AdamState(count=0, mu=_zeros_like(params),
                         nu=_zeros_like(params))

    def update(grads, state, params, lr):
        names = list(grads)
        g, m, v, p = _lists(names, grads, state.mu, state.nu, params)
        state.count += 1
        bc1, bc2 = _bias_corrections(b1, b2, state.count, bias_correction)
        g = [x.float() for x in g]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        updates = {}
        for n, m_, v_, p_ in zip(names, m, v, p):
            direction = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay > 0.0:
                direction = direction + weight_decay * p_
            p_norm = torch.linalg.vector_norm(p_.float())
            d_norm = torch.linalg.vector_norm(direction)
            trust = torch.where((p_norm > 0.0) & (d_norm > 0.0),
                                torch.clamp(p_norm / d_norm, min_coeff,
                                            max_coeff),
                                torch.ones_like(p_norm))
            updates[n] = -lr * trust * direction
        return updates, state

    return Optimizer(init, update)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, **_) -> Optimizer:
    def init(params):
        return SGDState(count=0,
                        mu=_zeros_like(params) if momentum else None)

    def update(grads, state, params, lr):
        names = list(grads)
        g = [grads[n].float() for n in names]
        if weight_decay > 0.0:
            g = torch._foreach_add(g, [params[n] for n in names],
                                   alpha=weight_decay)
        state.count += 1
        if momentum:
            m = [state.mu[n] for n in names]
            torch._foreach_mul_(m, momentum)
            torch._foreach_add_(m, g)
            g = m
        return dict(zip(names, torch._foreach_mul(g, -lr))), state

    return Optimizer(init, update)


def adagrad(eps: float = 1e-8, weight_decay: float = 0.0, **_) -> Optimizer:
    """Adagrad (reference DeepSpeedCPUAdagrad)."""
    def init(params):
        return AdagradState(count=0, accum=_zeros_like(params))

    def update(grads, state, params, lr):
        names = list(grads)
        g = [grads[n].float() for n in names]
        if weight_decay > 0.0:
            g = torch._foreach_add(g, [params[n] for n in names],
                                   alpha=weight_decay)
        acc = [state.accum[n] for n in names]
        torch._foreach_addcmul_(acc, g, g)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(g, -lr)
        torch._foreach_div_(upd, denom)
        state.count += 1
        return dict(zip(names, upd)), state

    return Optimizer(init, update)


def _normalize_params(params: dict) -> dict:
    """Torch-style optimizer params to this module's keyword names."""
    p = dict(params)
    if "betas" in p:
        p["betas"] = tuple(p["betas"])
    p.pop("lr", None)   # the learning rate comes from the schedule
    p.pop("torch_adam", None)
    return p


def _onebit(name: str, p):
    raise NotImplementedError(not_ported(
        f"the 1-bit optimizer family ({name})", "A9"))


OPTIMIZER_REGISTRY = {
    "adam": lambda p: adam(adamw_mode=bool(p.pop("adam_w_mode", True)), **p),
    "adamw": lambda p: adam(adamw_mode=True, **p),
    "fusedadam": lambda p: adam(adamw_mode=bool(p.pop("adam_w_mode", True)),
                                **p),
    "cpuadam": lambda p: adam(adamw_mode=bool(p.pop("adam_w_mode", True)),
                              **p),
    "lamb": lambda p: lamb(**p),
    "fusedlamb": lambda p: lamb(**p),
    "sgd": lambda p: sgd(**p),
    "adagrad": lambda p: adagrad(**p),
    "cpuadagrad": lambda p: adagrad(**p),
    "onebitadam": lambda p: _onebit("onebit_adam", p),
    "zerooneadam": lambda p: _onebit("zero_one_adam", p),
    "onebitlamb": lambda p: _onebit("onebit_lamb", p),
}


def normalize_optimizer_key(name: str) -> str:
    """Registry key of a JSON optimizer ``type``."""
    return name.lower().replace("_", "").replace("deepspeed", "")


ONEBIT_OPTIMIZER_KEYS = frozenset(
    {"onebitadam", "zerooneadam", "onebitlamb"})


def build_optimizer(name: str, params: Optional[dict] = None) -> Optimizer:
    """From the JSON ``optimizer`` section."""
    key = normalize_optimizer_key(name)
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"supported: {sorted(OPTIMIZER_REGISTRY)}")
    return OPTIMIZER_REGISTRY[key](_normalize_params(params or {}))
