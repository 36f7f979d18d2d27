"""DeepSpeedCPUAdam / DeepSpeedCPUAdagrad — the host optimizers of
ZeRO-Offload.

Counterpart of ``deepspeed_tpu/ops/cpu_adam.py`` (reference
``deepspeed/ops/adam/cpu_adam.py:13`` and ``adagrad/cpu_adagrad.py``): the
fp32 master weights and moments live in host memory; the fused SIMD step
of ``ops/csrc/cpu_adam.cpp`` updates them in place and writes the bf16
copy that goes back to the card in the same pass.

Buffers are CPU torch tensors or numpy arrays (either shares its memory
with the other); each is checked to be a contiguous float32 buffer (the
bf16 copy: any contiguous 2-byte buffer) and passed to the library by
address. The library is built with g++ on first use
(``ops/op_builder.HostOpBuilder``); a failed build raises. The plain
version (``_numpy_step`` and :func:`_f32_to_bf16_np`, round to nearest
even) runs only when the caller asks for it with ``use_native=False``.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import HostOpBuilder

_f32p = ctypes.POINTER(ctypes.c_float)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i64 = ctypes.c_int64
_f32 = ctypes.c_float


def _bind(lib) -> None:
    lib.dstpu_adam_update.argtypes = [
        _f32p, _f32p, _f32p, _f32p, _i64, _i64, _f32, _f32, _f32, _f32,
        _f32, ctypes.c_int, _u16p]
    lib.dstpu_adam_update.restype = None
    lib.dstpu_adagrad_update.argtypes = [
        _f32p, _f32p, _f32p, _i64, _f32, _f32, _f32, _u16p]
    lib.dstpu_adagrad_update.restype = None
    lib.dstpu_simd_width.restype = ctypes.c_int
    lib.dstpu_num_threads.restype = ctypes.c_int


CPU_ADAM = HostOpBuilder("cpu_adam", _bind)


def _tensor(buf) -> torch.Tensor:
    return buf if torch.is_tensor(buf) else torch.from_numpy(buf)


def _f32_ptr(buf, n: Optional[int] = None):
    t = _tensor(buf)
    if t.device.type != "cpu" or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"host Adam buffers must be contiguous float32 CPU "
                         f"buffers, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if n is not None and t.numel() != n:
        raise ValueError(f"host Adam buffer of {t.numel()} elements, "
                         f"expected {n}")
    return ctypes.cast(t.data_ptr(), _f32p)


def _u16_ptr(buf, n: int):
    if buf is None:
        return _u16p()
    t = _tensor(buf)
    if t.device.type != "cpu" or t.element_size() != 2 or \
            not t.is_contiguous() or t.numel() != n:
        raise ValueError("the bf16 copy must be a contiguous 2-byte CPU "
                         f"buffer of {n} elements")
    return ctypes.cast(t.data_ptr(), _u16p)


def _zeros(w):
    """A zero buffer like ``w`` (torch or numpy, as ``w`` is). Torch's
    allocator, not numpy's ``calloc``: its large blocks get huge pages,
    and the step runs slower over 4 KB pages; ``calloc`` would only skip
    the zeroing at init."""
    return torch.zeros_like(w) if torch.is_tensor(w) else np.zeros_like(w)


def _np(buf) -> np.ndarray:
    """A numpy view of a host buffer (bf16 tensors as uint16)."""
    if not torch.is_tensor(buf):
        return buf
    if buf.element_size() == 2:
        return buf.view(torch.int16).numpy().view(np.uint16)
    return buf.numpy()


class DeepSpeedCPUAdam:
    """Per-leaf host Adam over a dict of flat fp32 buffers."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, use_native=True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self._lib = CPU_ADAM.load() if use_native else None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def init_state(self, master: Dict[str, Any]):
        """Zero moments beside each master buffer (torch or numpy, as the
        master is)."""
        return {k: {"m": _zeros(v), "v": _zeros(v)}
                for k, v in master.items()}

    def step(self, master: Dict[str, Any], grads: Dict[str, Any],
             state: Dict[str, Any], lr: Optional[float] = None,
             bf16_out: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None) -> None:
        """In-place update of every leaf. ``bf16_out[k]`` receives the
        bf16 copy in the same pass when given. ``step`` pins the
        bias-correction step for leaf-at-a-time callers; by default each
        call advances it by one."""
        if step is None:
            self.step_count += 1
        else:
            self.step_count = int(step)
        lr = self.lr if lr is None else float(lr)
        for k, w in master.items():
            g, st = grads[k], state[k]
            out = None if bf16_out is None else bf16_out.get(k)
            if self._lib is not None:
                n = _tensor(w).numel()
                self._lib.dstpu_adam_update(
                    _f32_ptr(w), _f32_ptr(g, n), _f32_ptr(st["m"], n),
                    _f32_ptr(st["v"], n), n, self.step_count, lr,
                    self.beta1, self.beta2, self.eps, self.weight_decay,
                    1 if self.adamw_mode else 0, _u16_ptr(out, n))
            else:
                self._numpy_step(_np(w), _np(g),
                                 {p: _np(a) for p, a in st.items()}, lr,
                                 None if out is None else _np(out))

    def _numpy_step(self, w, g, st, lr, out):
        if not self.adamw_mode and self.weight_decay > 0:
            g = g + self.weight_decay * w
        st["m"][:] = self.beta1 * st["m"] + (1 - self.beta1) * g
        st["v"][:] = self.beta2 * st["v"] + (1 - self.beta2) * g * g
        bc1 = 1 - self.beta1 ** self.step_count
        bc2 = 1 - self.beta2 ** self.step_count
        denom = np.sqrt(st["v"]) / np.sqrt(bc2) + self.eps
        if self.adamw_mode and self.weight_decay > 0:
            w *= 1 - lr * self.weight_decay
        w -= (lr / bc1) * st["m"] / denom
        if out is not None:
            out[:] = _f32_to_bf16_np(w)


class DeepSpeedCPUAdagrad:
    """Host Adagrad (reference ops/adagrad/cpu_adagrad.py)."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 use_native=True):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = CPU_ADAM.load() if use_native else None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def init_state(self, master):
        return {k: {"h": _zeros(v)} for k, v in master.items()}

    def step(self, master, grads, state, lr=None, bf16_out=None):
        lr = self.lr if lr is None else float(lr)
        for k, w in master.items():
            g, st = grads[k], state[k]
            out = None if bf16_out is None else bf16_out.get(k)
            if self._lib is not None:
                n = _tensor(w).numel()
                self._lib.dstpu_adagrad_update(
                    _f32_ptr(w), _f32_ptr(g, n), _f32_ptr(st["h"], n), n, lr,
                    self.eps, self.weight_decay, _u16_ptr(out, n))
            else:
                w, g, h = _np(w), _np(g), _np(st["h"])
                gg = g + self.weight_decay * w if self.weight_decay else g
                h += gg * gg
                w -= lr * gg / (np.sqrt(h) + self.eps)
                if out is not None:
                    _np(out)[:] = _f32_to_bf16_np(w)


def _f32_to_bf16_np(w: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even fp32→bf16 (uint16 payload); NaN stays NaN
    (the RNE carry would overflow a NaN mantissa into the Inf pattern)."""
    x = w.view(np.uint32)
    lsb = (x >> 16) & 1
    rounded = ((x + 0x7FFF + lsb) >> 16).astype(np.uint16)
    nan = (x & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, ((x >> 16) | 0x0040).astype(np.uint16), rounded)
