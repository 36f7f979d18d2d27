"""The training engine, on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``
:93, ``initialize`` :2213) with its single-device semantics:

* ``train_batch(batch)`` — one optimizer step over ``micro * gas`` rows:
  for each micro-batch the gradient of ``loss * scale / gas`` (f32) with
  respect to the compute-dtype params, accumulated in f32; then unscale,
  the fp16 overflow check, the global-norm clip, ``lr = schedule(step)``
  (before the step counter moves), the optimizer update on the f32 master,
  the compute params cast from it, and the loss-scale update.
* ``forward`` / ``backward`` / ``step`` — the same step split per
  micro-batch (``backward`` takes the micro-batch, as the JAX engine's
  does).

The JAX engine compiles that step into one XLA program; here it is eager
PyTorch around the flash kernels. No bf16 or fp32 step reads a device
value on the host: the batch goes up through pinned memory and the
learning rate is a host float. An fp16 step reads one bool, whether the
gradients are finite, to skip the update (the JAX engine reads the same
flag per step). Gradients, moments and the master are updated in place.

Not in this slice (ROADMAP.md queue C; checkpoints are A3b): meshes and
ZeRO stages > 0, offload, the 1-bit and sparse gradient exchanges, MoQ,
eigenvalue, curriculum learning, the flops profiler, checkpoints and the
training telemetry planes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.adam import Optimizer, build_optimizer
from deepspeed_tpu_torch.runtime.lr_schedules import Schedule, build_schedule
from deepspeed_tpu_torch.runtime.precision import (PRECISION_DTYPES,
                                                   cast_tree, grads_finite,
                                                   make_loss_scale,
                                                   update_loss_scale)
from deepspeed_tpu_torch.runtime.utils import clip_coef, global_norm
from deepspeed_tpu_torch.utils.logging import logger

_LATER = "is not ported to deepspeed_tpu_torch yet (ROADMAP.md queue C)"


def _refuse_unported(config: DeepSpeedConfig) -> None:
    zc = config.zero_config
    mesh = config.mesh
    checks = (
        (zc.stage > 0, f"ZeRO stage {zc.stage}"),
        (zc.offload_optimizer is not None
         and zc.offload_optimizer.device != "none", "offload_optimizer"),
        (zc.offload_param is not None and zc.offload_param.device != "none",
         "offload_param"),
        (config.sparse_gradients, "sparse_gradients"),
        (mesh.data not in (-1, 1) or max(mesh.fsdp, mesh.tensor, mesh.seq,
                                         mesh.pipe) > 1,
         f"a mesh of more than one device ({mesh})"),
        (config.curriculum_learning.get("enabled", False),
         "curriculum_learning"),
        (bool(config.compression_config), "compression_training (MoQ)"),
        (config.eigenvalue.enabled, "eigenvalue"),
        (config.flops_profiler.enabled, "flops_profiler"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} {_LATER}")


def _loss(out):
    if isinstance(out, tuple):
        raise NotImplementedError(f"a loss_fn returning (loss, aux) {_LATER}")
    return out


class DeepSpeedEngine:
    def __init__(self, loss_fn: Callable, params: Dict[str, torch.Tensor],
                 config: DeepSpeedConfig,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler: Optional[Schedule] = None,
                 training_data=None, collate_fn=None, device=None):
        self.device = resolve_device(device)
        _refuse_unported(config)
        config.resolve_batch_config(1)
        self.config = config
        self.loss_fn = loss_fn
        self.compute_dtype = PRECISION_DTYPES[config.precision_dtype]
        self.mixed_precision = config.precision_dtype != "float32"
        self.fp16 = config.fp16.enabled
        self.gas = config.gradient_accumulation_steps
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        opt_cfg = config.optimizer
        if optimizer is None:
            optimizer = build_optimizer(opt_cfg.type if opt_cfg else "AdamW",
                                        dict(opt_cfg.params) if opt_cfg
                                        else {})
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler or build_schedule(
            config.scheduler, opt_cfg.params if opt_cfg else None)
        self._init_state(params)
        self.training_dataloader = None
        if training_data is not None:
            from deepspeed_tpu_torch.runtime.dataloader import \
                DeepSpeedDataLoader
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=self.train_batch_size,
                collate_fn=collate_fn, seed=config.seed)
        self.global_steps = 0
        self.skipped_steps = 0
        self._micro_steps = 0
        self._false = torch.zeros((), dtype=torch.bool, device=self.device)
        tc = config.telemetry
        if tc.enabled and (tc.numerics_enabled or tc.goodput
                           or tc.trace_sample_rate > 0
                           or tc.http_port is not None):
            logger.info(
                "DeepSpeedEngine: the training telemetry planes (numerics, "
                "goodput, tracing, the HTTP endpoint) are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md queue C) and are not "
                "built; training does not depend on them")
        n = sum(p.numel() for p in self.params.values())
        logger.info(f"engine ready: {n} parameters on {self.device}, "
                    f"dtype={config.precision_dtype} "
                    f"micro={self.micro_batch_size} gas={self.gas}")

    # ------------------------------------------------------------ state
    def _init_state(self, params) -> None:
        """f32 master (a copy of ``params``), compute params cast from it
        (the master itself in fp32), optimizer state and loss scale."""
        master = {k: torch.as_tensor(v).to(self.device, torch.float32,
                                           copy=True)
                  for k, v in params.items()}
        if self.mixed_precision:
            self.master = master
            self.params = cast_tree(master, self.compute_dtype)
        else:
            self.master = None
            self.params = master
        for p in self.params.values():
            p.requires_grad_(True)
        self.opt_state = self.optimizer.init(
            {k: v.detach() for k, v in self._master().items()})
        self.loss_scale = make_loss_scale(self.config.fp16 if self.fp16
                                          else None, self.device)
        self._acc = None   # f32 gradient accumulators, made on first use
        self._acc_losses = []   # the loss of each micro-batch in _acc

    def _master(self):
        return self.master if self.mixed_precision else self.params

    def _upload(self, batch):
        """Host arrays → device tensors through pinned memory, without a
        stream sync."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    # ------------------------------------------------------ the gradient
    def _micro_grads(self, mb, scale):
        """``(loss, grads)``: the gradient of ``loss * scale / gas`` (f32)
        w.r.t. the compute params, in their dtype."""
        loss = _loss(self.loss_fn(self.params, mb, None))
        scaled = (loss * scale / self.gas).float()
        return loss.detach(), torch.autograd.grad(
            scaled, list(self.params.values()))

    def _apply(self, grads, mean_loss):
        """Unscale, overflow check (fp16), clip, update or skip, loss-scale
        update; the step's metrics. ``grads`` (f32, a list in param order)
        are modified in place."""
        scale = self.loss_scale.scale
        if self.fp16:
            torch._foreach_mul_(grads, 1.0 / scale)
            finite = grads_finite(grads)
        gnorm = global_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0.0:
            torch._foreach_mul_(grads, clip_coef(clip, gnorm))
        lr = self.lr_scheduler(self.global_steps)
        # the one host read of a step, fp16 only (the overflow skip)
        skip = self.fp16 and not bool(finite)
        if not skip:
            with torch.no_grad():
                master = self._master()
                names = list(master)
                updates, self.opt_state = self.optimizer.update(
                    dict(zip(names, grads)), self.opt_state,
                    {k: v.detach() for k, v in master.items()}, lr)
                torch._foreach_add_([master[n].detach() for n in names],
                                    [updates[n] for n in names])
                del updates
                if self.mixed_precision:
                    torch._foreach_copy_(
                        [self.params[n].detach() for n in names],
                        [master[n] for n in names])
        if self.fp16:
            self.loss_scale = update_loss_scale(self.loss_scale, finite)
            self.skipped_steps += int(skip)
        self.global_steps += 1
        return {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": scale,
                "skipped": ~finite if self.fp16 else self._false}

    # ----------------------------------------------------------- public
    def train_batch(self, batch=None) -> Dict[str, Any]:
        """One optimizer step over ``micro * gas`` rows; returns ``loss``
        (the mean over micro-batches), ``grad_norm``, ``lr``,
        ``loss_scale`` and ``skipped``."""
        if batch is None:
            batch = next(self.training_dataloader)
        batch = self._upload(batch)
        leading = next(iter(batch.values())).shape[0]
        expected = self.micro_batch_size * self.gas
        if leading != expected:
            raise ValueError(f"global batch leading dim {leading} != "
                             f"micro*gas*dp = {expected}")
        if self._acc_losses:
            raise RuntimeError("train_batch() called with micro-batches from "
                               "backward() not yet applied by step()")
        rows = self.micro_batch_size
        for i in range(self.gas):
            self.backward({k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()})
        return self.step()

    def forward(self, batch):
        """Loss of one micro-batch, without gradients."""
        with torch.no_grad():
            return _loss(self.loss_fn(self.params, self._upload(batch), None))

    def backward(self, batch):
        """Accumulate the f32 gradients of one micro-batch; returns its
        loss."""
        loss, grads = self._micro_grads(self._upload(batch),
                                        self.loss_scale.scale)
        if self._acc is None:
            self._acc = [torch.empty(p.shape, dtype=torch.float32,
                                     device=self.device)
                         for p in self.params.values()]
        if self._acc_losses:
            torch._foreach_add_(self._acc, grads)
        else:
            torch._foreach_copy_(self._acc, grads)
        del grads
        self._acc_losses.append(loss)
        self._micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_steps % self.gas == 0

    def step(self):
        """Apply the gradients accumulated by ``backward``; a no-op (None)
        off the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return None
        if not self._acc_losses:
            raise RuntimeError("step() called with no accumulated gradients")
        losses, self._acc_losses = self._acc_losses, []
        return self._apply(self._acc, sum(losses) / len(losses))

    # --------------------------------------------------------- accessors
    def get_lr(self):
        return [self.lr_scheduler(self.global_steps)]

    def get_loss_scale(self) -> float:
        return float(self.loss_scale.scale) if self.fp16 else 1.0

    def fp32_master_params(self) -> Dict[str, torch.Tensor]:
        """The f32 master weights, copied to the host."""
        return {k: v.detach().float().cpu()
                for k, v in self._master().items()}

    def gradient_accumulation_steps(self) -> int:
        return self.gas

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size

    def zero_optimization_stage(self) -> int:
        return 0

    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        raise NotImplementedError(
            "save_checkpoint is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP.md A3b)")

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        raise NotImplementedError(
            "load_checkpoint is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP.md A3b)")


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, loss_fn=None, collate_fn=None,
               device=None):
    """``deepspeed.initialize`` on one device: returns ``(engine,
    optimizer, training_dataloader, lr_scheduler)``. ``model`` exposes
    ``loss_fn(params, batch, rng)`` (or pass ``loss_fn``);
    ``model_parameters`` is the initial dict of weights; ``config`` a
    ``DeepSpeedConfig``, a dict or a JSON path. ``device`` defaults to
    ``cuda``, which needs a card."""
    cfg = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(
        config if config is not None else (config_params or {}))
    if getattr(model, "num_stages", 1) > 1:
        raise NotImplementedError(f"a pipeline model {_LATER}")
    if loss_fn is None:
        if model is None or not hasattr(model, "loss_fn"):
            raise ValueError("provide loss_fn or a model exposing "
                             ".loss_fn(params, batch, rng)")
        loss_fn = model.loss_fn
    if model_parameters is None:
        raise ValueError("model_parameters (the initial weights) are "
                         "required")
    engine = DeepSpeedEngine(loss_fn, dict(model_parameters), cfg,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             training_data=training_data,
                             collate_fn=collate_fn, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
