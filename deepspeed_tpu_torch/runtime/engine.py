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
* ``save_checkpoint`` / ``load_checkpoint`` — the verified checkpoints of
  ``runtime/checkpointing.py`` (sync or async); ``save_16bit_model``,
  ``module_state_dict`` / ``load_module_state_dict`` and ``destroy``.

A ``loss_fn`` may return ``(loss, aux)``: ``aux`` is a dict of scalars,
averaged over the micro-batches into the step's metrics (JAX
``_split_loss_out``).

ZeRO on one device (JAX ``runtime/engine.py:247-329``): stages 1-3 are
accepted, and at world size 1 every placement of JAX's
``runtime/zero/partition.py`` is the one device, so they give stage 0's
numbers. ``offload_optimizer: {device: cpu}`` moves the optimizer state to
the host (``runtime/zero/offload.py``); its ``implementation`` resolves as
in JAX, with the TPU backend read as "the engine's device is CUDA":
``auto`` gives ``stream`` on CUDA without fp16, else ``host``.

* ``host``: the f32 master and the Adam moments in host memory, the C++
  Adam of ``ops/cpu_adam.py`` (Adam family only); the gradients leave the
  card in the step's chunk pipeline (``HostOffloadOptimizer.
  step_streamed``) and the new params come back. With
  ``data_types.grad_accum_dtype: bf16`` (and no fp16) the gradients are
  accumulated and leave in bf16, unscaled and clipped in f32 and rounded
  back (JAX ``native_acc_out``). ``offload_step_times`` holds the last
  step's seconds: ``device_s`` (forward and backward until the gradients
  are final) and the pipeline's ``d2h_s``, ``adam_s``, ``h2d_s``, ...
* ``stream`` (CUDA only): master and moments in pinned host memory, each
  leaf updated on the card by the engine's optimizer between two copies;
  the in-HBM path's numbers.

``offload_param: {device: cpu}`` (stage 3 only) keeps the 16-bit params
in pinned host memory between steps (``runtime/zero/param_offload.py``):
a model that declares ``handles_param_offload`` fetches each layer itself
through the engine's fetch, and its gradients go straight to the engine's
accumulators on the card; any other model gets the whole tree staged to
the card for the step and dropped after it. ``device: nvme`` is
ROADMAP.md A6c.

The JAX engine compiles that step into one XLA program; here it is eager
PyTorch around the flash kernels. No bf16 or fp32 step reads a device
value on the host: the batch goes up through pinned memory and the
learning rate is a host float. An fp16 step reads one bool, whether the
gradients are finite, to skip the update (the JAX engine reads the same
flag per step). Gradients, moments and the master are updated in place.

Not in this slice (ROADMAP.md queue C): meshes of several devices, the
NVMe tier, the 1-bit and sparse gradient exchanges, MoQ, eigenvalue,
curriculum learning, the flops profiler and the training telemetry
planes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.adam import (Optimizer, build_optimizer,
                                          normalize_optimizer_key)
from deepspeed_tpu_torch.runtime.lr_schedules import Schedule, build_schedule
from deepspeed_tpu_torch.runtime.precision import (PRECISION_DTYPES,
                                                   cast_tree, grads_finite,
                                                   make_loss_scale,
                                                   update_loss_scale)
from deepspeed_tpu_torch.runtime.utils import clip_coef, global_norm
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer,
                                                      StreamedOffloadOptimizer,
                                                      refuse_nvme)
from deepspeed_tpu_torch.runtime.zero.param_offload import (ParamFetcher,
                                                            stage, to_pinned)
from deepspeed_tpu_torch.telemetry import MetricRegistry, get_registry
from deepspeed_tpu_torch.utils.logging import logger

_LATER = "is not ported to deepspeed_tpu_torch yet (ROADMAP.md queue C)"


def _refuse_unported(config: DeepSpeedConfig) -> None:
    mesh = config.mesh
    checks = (
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


_RESERVED_METRICS = {"loss", "grad_norm", "lr", "loss_scale", "skipped",
                     "finite", "_numerics"}


def _split_loss_out(out):
    """loss_fn may return a bare scalar or ``(loss, aux_dict)`` (the
    reference's multi-output models: extra per-step scalars ride into the
    step metrics). Reserved metric names stay the engine's."""
    if not isinstance(out, tuple):
        return out, {}
    loss, aux = out
    if not isinstance(aux, dict):
        raise TypeError(
            "loss_fn returning a tuple must be (loss, aux_dict); "
            f"got aux of type {type(aux).__name__}")
    bad = _RESERVED_METRICS & set(aux)
    if bad:
        raise ValueError(
            f"aux metric names {sorted(bad)} collide with engine "
            "metrics — rename them")
    aux = {k: torch.as_tensor(v).detach().to(torch.float32)
           for k, v in aux.items()}
    nonscalar = [k for k, v in aux.items() if v.dim() != 0]
    if nonscalar:
        raise ValueError(
            f"aux metrics must be scalars, got non-scalar "
            f"{sorted(nonscalar)} (reduce them in loss_fn)")
    return loss, aux


class DeepSpeedEngine:
    def __init__(self, loss_fn: Callable, params: Dict[str, torch.Tensor],
                 config: DeepSpeedConfig,
                 optimizer: Optional[Optimizer] = None,
                 lr_scheduler: Optional[Schedule] = None,
                 training_data=None, collate_fn=None, device=None,
                 model_handles_param_offload: bool = False):
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
        self._resolve_zero(config, model_handles_param_offload)
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
        self._train_mode = True
        self._last_skipped = None
        self._last_grad_norm = None
        # checkpointing (runtime/checkpointing.py): the checkpoint engine,
        # an async finalize in flight and its stashed error, and the
        # chaos hook a caller may set (``check_ckpt_write(tag)``)
        self._ckpt_engine = None
        self._ckpt_finalize_thread = None
        self._ckpt_finalize_error = None
        self.fault_injector = None
        tc = config.telemetry
        # process-wide registry; telemetry.enabled=false records into a
        # private one, so nothing reaches the process scrape surface
        self.telemetry = get_registry() if tc.enabled else MetricRegistry()
        if tc.enabled and (tc.numerics_enabled or tc.goodput
                           or tc.trace_sample_rate > 0
                           or tc.http_port is not None):
            logger.info(
                "DeepSpeedEngine: the training telemetry planes (numerics, "
                "goodput, tracing, the HTTP endpoint) are not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md queue C) and are not "
                "built; training does not depend on them")
        n = sum(p.numel() for p in self.params.values())
        tiers = [t for t, on in (
            ("host", self.host_opt is not None),
            ("stream", self._stream_opt is not None),
            ("param", self._param_offload_cfg is not None)) if on]
        logger.info(f"engine ready: {n} parameters on {self.device}, "
                    f"dtype={config.precision_dtype} "
                    f"micro={self.micro_batch_size} gas={self.gas} "
                    f"zero_stage={self.zero_stage} offload={tiers or None}")

    # ------------------------------------------------------------- ZeRO
    def _resolve_zero(self, config, model_handles_param_offload) -> None:
        """The ZeRO stage, the offload tiers and their refusals, in JAX's
        order and words (JAX ``runtime/engine.py:247-329``)."""
        zc = config.zero_config
        self.zero_stage = zc.stage
        oc = zc.offload_optimizer
        self._offload_cfg = oc if (oc is not None and
                                   oc.device != "none") else None
        self._offload_stream = False
        if self._offload_cfg is not None:
            impl = self._offload_cfg.implementation
            if impl == "auto":
                # fp16 stays on the host path (its overflow skip reads the
                # flag before any update); explicit 'stream' + fp16 is
                # refused below
                impl = ("stream" if (self.device.type == "cuda" and
                                     self._offload_cfg.device == "cpu" and
                                     not config.fp16.enabled)
                        else "host")
            if impl == "stream":
                if self._offload_cfg.device == "nvme":
                    raise ValueError(
                        "offload_optimizer.implementation='stream' holds "
                        "state in pinned host memory; the nvme tier needs "
                        "implementation='host' (aio swap files)")
                if config.fp16.enabled:
                    raise ValueError(
                        "streamed offload supports bf16/fp32 training; "
                        "fp16's overflow skip is decided before any update "
                        "— use implementation='host' for fp16")
                if self.device.type != "cuda":
                    raise ValueError(
                        "offload_optimizer.implementation='stream' needs a "
                        f"CUDA device (the engine's device is "
                        f"{self.device}: no card to stream the state "
                        "through); use 'host' or 'auto'")
            self._offload_stream = impl == "stream"
            refuse_nvme(self._offload_cfg.device, "offload_optimizer")
            if not self._offload_stream:
                opt_cfg = config.optimizer
                opt_type = normalize_optimizer_key(
                    opt_cfg.type if opt_cfg else "AdamW")
                if opt_type not in ("adam", "adamw", "fusedadam", "cpuadam"):
                    raise ValueError(
                        f"offload_optimizer supports Adam-family only, got "
                        f"{opt_type} (reference pairs cpu_offload with "
                        "DeepSpeedCPUAdam, engine.py:1314)")
        pc = zc.offload_param
        self._param_offload_cfg = pc if (pc is not None and
                                         pc.device != "none") else None
        if self._param_offload_cfg is not None and self.zero_stage < 3:
            raise ValueError(
                "offload_param requires ZeRO stage 3 (reference "
                "stage3.py:448 — parameter offload is a stage-3 feature)")
        if self._param_offload_cfg is not None:
            refuse_nvme(self._param_offload_cfg.device, "offload_param")
        self._model_fetches_params = bool(
            model_handles_param_offload and
            self._param_offload_cfg is not None)
        # bf16 gradients leave the card in bf16 (host path only; JAX
        # native_acc_out): not with fp16, whose unscale is defined on f32
        self._native_out = (
            self._offload_cfg is not None and not self._offload_stream
            and not config.fp16.enabled and
            (config.data_types.grad_accum_dtype or
             config.communication_data_type) == "bf16")
        self.host_opt = None
        self._stream_opt = None
        self._fetcher = None
        self._staged = None
        self.offload_step_times: Dict[str, float] = {}

    # ------------------------------------------------------------ state
    def _init_state(self, params) -> None:
        """f32 master (a copy of ``params``), compute params cast from it
        (the master itself in fp32), optimizer state and loss scale. With
        ``offload_optimizer`` the master and the optimizer state go to the
        host (``host_opt`` or ``_stream_opt``); with ``offload_param`` the
        compute params live in pinned host memory."""
        if self._offload_cfg is not None and not self._offload_stream:
            # the f32 master straight to the host, and no f32 copy on the
            # card: the compute params are cast from the caller's weights
            opt_cfg = self.config.optimizer
            self.host_opt = HostOffloadOptimizer(
                params, opt_cfg.params if opt_cfg else {},
                device=self._offload_cfg.device,
                nvme_path=self._offload_cfg.nvme_path)
            self.params = {k: torch.as_tensor(v).to(
                self.device, torch.float32, copy=not self.mixed_precision
            ).to(self.compute_dtype) for k, v in params.items()}
            self.master = self.opt_state = None
        else:
            master = {k: torch.as_tensor(v).to(self.device, torch.float32,
                                               copy=True)
                      for k, v in params.items()}
            self.params = (cast_tree(master, self.compute_dtype)
                           if self.mixed_precision else master)
            if self._offload_stream:
                self._stream_opt = StreamedOffloadOptimizer(
                    self.optimizer, master, self.mixed_precision)
                self.master = self._stream_opt.master
                self.opt_state = self._stream_opt.opt_state
            else:
                # with offload_param the params leave the card: the master
                # stays there, even in fp32
                self.master = master if (self.mixed_precision or
                                         self._param_offload_cfg) else None
                self.opt_state = self.optimizer.init(
                    {k: v.detach() for k, v in self._master().items()})
            del master
        if self._param_offload_cfg is not None:
            self.params = to_pinned(self.params)
        for p in self.params.values():
            p.requires_grad_(True)
        self._loss_scale = make_loss_scale(self.config.fp16 if self.fp16
                                           else None, self.device)
        self._acc = None   # gradient accumulators, made on first use
        self._acc_losses = []   # the loss of each micro-batch in _acc
        self._acc_aux = []      # and its aux metrics
        self._index = {n: i for i, n in enumerate(self.params)}
        self._sink_first = True

    def install_param_fetch(self, model) -> None:
        """Give a ``handles_param_offload`` model the engine's fetch; its
        weights' gradients then go to the accumulators (``_deposit``)."""
        if self._model_fetches_params:
            self._fetcher = ParamFetcher(self.device, self._deposit)
            model.set_param_fetch(self._fetcher)

    def _deposit(self, name: str, grad: torch.Tensor) -> None:
        acc = self._acc[self._index[name]]
        if self._sink_first:
            acc.copy_(grad)
        else:
            acc.add_(grad)
        self._deposited.add(name)

    def _step_params(self):
        """The params a micro-batch runs on: the whole tree staged to the
        card for this step (``offload_param`` with a model that does not
        fetch its own layers), else the engine's own."""
        if self._param_offload_cfg is None or self._fetcher is not None:
            return self.params
        if self._staged is None:
            self._staged = stage(self.params, self.device)
        return self._staged

    def _cast_params_from(self, master) -> None:
        """The compute params cast from ``master`` by the step's own cast
        (``_foreach_copy_``; one copy a leaf across devices)."""
        names = list(master)
        dst = [self.params[n].detach() for n in names]
        src = [master[n] for n in names]
        if all(d.device == m.device for d, m in zip(dst, src)):
            torch._foreach_copy_(dst, src)
        else:
            for d, m in zip(dst, src):
                d.copy_(m)

    def _master(self):
        return self.params if self.master is None else self.master

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
        """``(loss, aux, grads)``: the gradient of ``loss * scale / gas``
        (f32) w.r.t. the compute params, in their dtype. A model that
        fetches its own weights hands them to the accumulators in the
        backward pass instead (``grads`` is None)."""
        if self._fetcher is not None:
            loss, aux = _split_loss_out(self.loss_fn(self.params, mb, None))
            self._deposited = set()
            torch.autograd.backward((loss * scale / self.gas).float())
            missing = set(self.params) - self._deposited
            if missing:
                raise RuntimeError(
                    "offload_param: the model fetched no gradient for "
                    f"{sorted(missing)[:5]} (every weight must go through "
                    "the engine's fetch)")
            return loss.detach(), aux, None
        params = self._step_params()
        loss, aux = _split_loss_out(self.loss_fn(params, mb, None))
        scaled = (loss * scale / self.gas).float()
        return loss.detach(), aux, torch.autograd.grad(
            scaled, list(params.values()))

    def _apply(self, grads, mean_loss):
        """Unscale, overflow check (fp16), clip, update or skip, loss-scale
        update; the step's metrics. ``grads`` (a list in param order, f32,
        or bf16 with ``_native_out``) are modified in place."""
        scale = self._loss_scale.scale
        if self.fp16:
            torch._foreach_mul_(grads, 1.0 / scale)
            finite = grads_finite(grads)
        # bf16 grads (``_native_out``, never with fp16): the norm and the
        # clip in f32, each gradient rounded back to bf16 (JAX
        # native_acc_out)
        gnorm = global_norm(grads)
        clip = self.config.gradient_clipping
        if clip > 0.0:
            torch._foreach_mul_(grads, clip_coef(clip, gnorm))
        lr = self.lr_scheduler(self.global_steps)
        # the one host read of a step, fp16 only (the overflow skip)
        skip = self.fp16 and not bool(finite)
        if self.host_opt is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the gradients are final
            self.offload_step_times = {
                "device_s": time.perf_counter() - self._step_t0}
        if not skip:
            with torch.no_grad():
                self._update(grads, lr)
        if self.host_opt is not None:
            self.offload_step_times.update(self.host_opt.last_times)
        self._staged = None   # offload_param: the staged tree is dropped
        if self.fp16:
            self._loss_scale = update_loss_scale(self._loss_scale, finite)
            self.skipped_steps += int(skip)
        self.global_steps += 1
        self._last_skipped = ~finite if self.fp16 else self._false
        self._last_grad_norm = gnorm
        return {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": scale, "skipped": self._last_skipped}

    def _update(self, grads, lr) -> None:
        """The optimizer step on the master, wherever it lives, and the
        compute params refreshed from it."""
        names = list(self.params)
        if self.host_opt is not None:
            self.host_opt.step_streamed(dict(zip(names, grads)), lr,
                                        self.params)
            return
        if self._stream_opt is not None:
            self._stream_opt.step(dict(zip(names, grads)), lr, self.params)
            return
        master = self._master()
        updates, self.opt_state = self.optimizer.update(
            dict(zip(names, grads)), self.opt_state,
            {k: v.detach() for k, v in master.items()}, lr)
        torch._foreach_add_([master[n].detach() for n in names],
                            [updates[n] for n in names])
        del updates
        if master is not self.params:
            self._cast_params_from(master)

    # ----------------------------------------------------------- public
    def train_batch(self, batch=None) -> Dict[str, Any]:
        """One optimizer step over ``micro * gas`` rows; returns ``loss``
        (the mean over micro-batches), ``grad_norm``, ``lr``,
        ``loss_scale``, ``skipped`` and the mean of each aux metric."""
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
            params = self._step_params()
            if params is self._staged and not self._acc_losses:
                self._staged = None   # no step will drop it
            return _split_loss_out(
                self.loss_fn(params, self._upload(batch), None))[0]

    def backward(self, batch):
        """Accumulate the gradients of one micro-batch (f32; bf16 with
        ``_native_out``); returns its loss."""
        if not self._acc_losses:
            self._step_t0 = time.perf_counter()
        if self._acc is None:
            dtype = torch.bfloat16 if self._native_out else torch.float32
            self._acc = [torch.empty(p.shape, dtype=dtype,
                                     device=self.device)
                         for p in self.params.values()]
        self._sink_first = not self._acc_losses
        loss, aux, grads = self._micro_grads(self._upload(batch),
                                             self._loss_scale.scale)
        if grads is not None:
            if self._acc_losses:
                torch._foreach_add_(self._acc, grads)
            else:
                torch._foreach_copy_(self._acc, grads)
        del grads
        self._acc_losses.append(loss)
        self._acc_aux.append(aux)
        self._micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_steps % self.gas == 0

    def step(self):
        """Apply the gradients accumulated by ``backward``; a no-op (None)
        off the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            self._last_skipped = True   # a no-op step: nothing applied
            return None
        if not self._acc_losses:
            raise RuntimeError("step() called with no accumulated gradients")
        losses, self._acc_losses = self._acc_losses, []
        auxes, self._acc_aux = self._acc_aux, []
        metrics = self._apply(self._acc, sum(losses) / len(losses))
        if auxes and auxes[0]:
            for k in auxes[0]:
                metrics[k] = sum(a[k] for a in auxes) / len(auxes)
        return metrics

    # --------------------------------------------------------- accessors
    def get_lr(self):
        return [self.lr_scheduler(self.global_steps)]

    def get_loss_scale(self) -> float:
        """The current dynamic loss scale (fp16) or 1.0."""
        return float(self._loss_scale.scale) if self.fp16 else 1.0

    def loss_scale(self) -> float:
        return self.get_loss_scale()

    @property
    def global_samples(self) -> int:
        """Samples consumed so far (reference engine.global_samples)."""
        return self.global_steps * self.train_batch_size

    def get_global_grad_norm(self):
        """The global gradient norm of the latest step as a host float, or
        None before the first one."""
        g = self._last_grad_norm
        return None if g is None else float(g)

    def was_step_applied(self) -> bool:
        """True if the latest step updated the parameters; False after an
        fp16 overflow skip or a step() off the accumulation boundary. The
        flag stays on the device until asked for."""
        skipped = self._last_skipped
        if skipped is None:
            return False
        return not bool(skipped)

    def fp32_master_params(self) -> Dict[str, torch.Tensor]:
        """The f32 master weights, copied to the host."""
        if self.host_opt is not None:
            return {k: v.reshape(self.host_opt.shapes[k]).clone()
                    for k, v in self.host_opt.master.items()}
        self._sync_host_state()
        return {k: v.detach().float().to("cpu", copy=True)
                for k, v in self._master().items()}

    def _sync_host_state(self) -> None:
        """Wait for the streamed optimizer's copies back to the host."""
        if self._stream_opt is not None:
            self._stream_opt.synchronize()

    def gradient_accumulation_steps(self) -> int:
        return self.gas

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def zero_cpu_offload(self) -> bool:
        return self._offload_cfg is not None

    def zero_offload_optimizer(self):
        return self._offload_cfg

    def zero_offload_param(self):
        return self._param_offload_cfg

    def sparse_gradients_enabled(self) -> bool:
        return self.config.sparse_gradients

    def curriculum_enabled(self) -> bool:
        return False

    # config accessors of the reference engine (engine.py:428-1030)
    def get_batch_info(self):
        """(train_batch_size, micro_batch_size, gas)."""
        return self.train_batch_size, self.micro_batch_size, self.gas

    def optimizer_name(self):
        return self.config.optimizer.type if self.config.optimizer else None

    def optimizer_params(self):
        return dict(self.config.optimizer.params) \
            if self.config.optimizer else None

    def scheduler_name(self):
        return self.config.scheduler.type if self.config.scheduler else None

    def scheduler_params(self):
        return dict(self.config.scheduler.params) \
            if self.config.scheduler else None

    def get_mom(self):
        """Momentum (SGD/RMSprop) or betas (the Adam family)."""
        params = self.optimizer_params() or {}
        if (self.optimizer_name() or "").lower() in ("sgd", "rmsprop"):
            return [params.get("momentum", 0.0)]
        return [tuple(params.get("betas", (0.9, 0.999)))]

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def dynamic_loss_scale(self) -> bool:
        return self.fp16 and self.config.fp16.dynamic_loss_scale

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def wall_clock_breakdown(self) -> bool:
        return self.config.wall_clock_breakdown

    def memory_breakdown(self) -> bool:
        return self.config.memory_breakdown

    def communication_data_type(self):
        return self.config.communication_data_type

    def train(self, mode: bool = True):
        """Training/eval mode toggle. The port's ``loss_fn`` gets no rng
        in either mode (no dropout), so the mode changes nothing yet."""
        self._train_mode = bool(mode)

    def eval(self):
        self.train(False)

    def zero_grad(self) -> None:
        """Drop the gradients accumulated by ``backward`` and roll the
        micro-step counter back to the last boundary."""
        self._acc_losses = []
        self._acc_aux = []
        self._micro_steps -= self._micro_steps % self.gas

    # ------------------------------------------------------- module state
    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The compute-dtype weights, copied to the host, by the engine's
        names."""
        return {k: v.detach().cpu() for k, v in self.params.items()}

    def load_module_state_dict(self, state_dict) -> None:
        """Load the module weights only: each is cast to its param's
        dtype, the optimizer state is untouched and the f32 master is
        cast from the loaded params (as ``load_checkpoint(
        load_module_only=True)`` keeps the optimizer). Names may be the
        engine's or the JAX package's ``/``-joined ones."""
        sd = {k.replace("/", "."): v for k, v in state_dict.items()}
        missing = set(self.params) - set(sd)
        if missing:
            raise KeyError(f"state_dict missing params: {sorted(missing)[:5]}")
        with torch.no_grad():
            for n, p in self.params.items():
                v = sd[n] if torch.is_tensor(sd[n]) else torch.tensor(sd[n])
                p.detach().copy_(v.reshape(p.shape))
            if self.host_opt is not None:
                self.host_opt.sync_master_from(self.params)
            elif self.master is not None:
                self._sync_host_state()
                for n, m in self.master.items():
                    m.copy_(self.params[n].detach())

    def save_16bit_model(self, save_dir,
                         save_filename: str = "model.safetensors") -> str:
        """The compute-precision weights as ONE safetensors file with the
        engine's dotted names (reference ``save_16bit_model``)."""
        import os

        from deepspeed_tpu_torch.utils.safetensors_io import save_file
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, save_filename)
        save_file({k: v.detach() for k, v in self.params.items()}, out)
        logger.info(f"saved 16-bit model: {out} ({len(self.params)} "
                    "tensors)")
        return out

    # ------------------------------------------------------- checkpoints
    def _checkpoint_state(self) -> Dict[str, Dict[str, Any]]:
        """The groups a checkpoint holds: the f32 master, the optimizer
        state (its dataclass fields: ``count`` a host int, the moment
        dicts) and the loss scale's dynamic fields. Device tensors, not
        copies: the checkpoint engine copies them to the host. With the
        ``host`` offload the master and the moments are not here: they go
        to ``host_optimizer.npz`` beside the state
        (``runtime/checkpointing.py``), and the state holds the compute
        params (the JAX engine's state there: params, no master)."""
        ls = self._loss_scale
        loss_scale = {"scale": ls.scale, "growth_tracker": ls.growth_tracker,
                      "hysteresis": ls.hysteresis}
        if self.host_opt is not None:
            return {"params": {k: v.detach() for k, v in self.params.items()},
                    "loss_scale": loss_scale}
        self._sync_host_state()
        opt = {"type": type(self.opt_state).__name__}
        for f in dataclasses.fields(self.opt_state):
            v = getattr(self.opt_state, f.name)
            if v is not None:
                opt[f.name] = ({k: t.detach() for k, t in v.items()}
                               if isinstance(v, dict) else v)
        return {"master": {k: v.detach() for k, v in self._master().items()},
                "optimizer": opt, "loss_scale": loss_scale}

    @staticmethod
    def _copy_into(dst: Dict[str, torch.Tensor], src, what: str) -> None:
        if set(dst) != set(src):
            raise ValueError(
                f"checkpoint {what} does not match the engine: missing "
                f"{sorted(set(dst) - set(src))[:5]}, unexpected "
                f"{sorted(set(src) - set(dst))[:5]}")
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {what} {k!r} has shape "
                                 f"{tuple(src[k].shape)}, the engine "
                                 f"{tuple(t.shape)}")
            t.detach().copy_(src[k])

    def _load_checkpoint_state(self, state, load_optimizer_states=True):
        """Copy a checkpoint's groups (host tensors) into the engine's own
        tensors, then cast the compute params from the master by the
        step's own cast (``_foreach_copy_``), so their bits are the
        saved step's."""
        with torch.no_grad():
            if self.host_opt is not None:
                if "params" not in state:
                    raise ValueError(
                        "checkpoint holds no 'params' group: it was not "
                        "saved by an engine with offload_optimizer "
                        "implementation='host'")
                self._copy_into(self.params, state["params"], "params")
            else:
                if "master" not in state:
                    raise ValueError(
                        "checkpoint holds no 'master' group: it was saved "
                        "by an engine with offload_optimizer "
                        "implementation='host'")
                self._sync_host_state()
                master = self._master()
                self._copy_into(master, state["master"], "master")
                if master is not self.params:
                    self._cast_params_from(master)
            ls = state["loss_scale"]
            self._loss_scale = dataclasses.replace(
                self._loss_scale, **{k: ls[k].to(self.device, copy=True)
                                     for k in ("scale", "growth_tracker",
                                               "hysteresis")})
            if not load_optimizer_states or self.host_opt is not None:
                return
            opt = state["optimizer"]
            if opt.get("type") != type(self.opt_state).__name__:
                raise ValueError(
                    f"checkpoint optimizer state is {opt.get('type')!r}, "
                    f"the engine's {type(self.opt_state).__name__!r}")
            for f in dataclasses.fields(self.opt_state):
                cur = getattr(self.opt_state, f.name)
                if isinstance(cur, dict):
                    self._copy_into(cur, opt[f.name], f"optimizer {f.name}")
                elif cur is not None:
                    setattr(self.opt_state, f.name, int(opt[f.name]))

    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        """A verified checkpoint under ``save_dir/<tag>`` (default
        ``global_step<N>``); returns the tag dir. See
        ``runtime/checkpointing.py``."""
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint
        from deepspeed_tpu_torch.telemetry import events as _ev
        out = save_checkpoint(self, save_dir, tag=tag,
                              client_state=client_state or {})
        _ev.record_event(_ev.CHECKPOINT, dir=str(save_dir), tag=str(tag),
                         step=self.global_steps)
        return out

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        """``(tag dir, client_state)`` of the restored checkpoint; keyword
        arguments ``load_optimizer_states``, ``load_lr_scheduler_states``
        and ``load_module_only`` as in the reference."""
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint
        return load_checkpoint(self, load_dir, tag=tag, **kwargs)

    def destroy(self) -> None:
        """Join an in-flight async checkpoint finalize FIRST — a teardown
        must never abandon a checkpoint mid-publication, and a finalize
        that failed surfaces here, after the rest of the teardown — then
        release the checkpoint engine and the gradient accumulators."""
        from deepspeed_tpu_torch.runtime.checkpointing import (
            _join_pending_finalize)
        ckpt_err = None
        try:
            _join_pending_finalize(self)
        except RuntimeError as e:
            ckpt_err = e
        finally:
            ce, self._ckpt_engine = self._ckpt_engine, None
            if ce is not None:
                try:
                    ce.close()
                except Exception as e:  # noqa: BLE001
                    if ckpt_err is None:
                        ckpt_err = RuntimeError(
                            f"checkpoint engine close failed: {e!r}")
        self.zero_grad()
        self._acc = None
        self._staged = None
        if ckpt_err is not None:
            raise ckpt_err


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
                             collate_fn=collate_fn, device=device,
                             model_handles_param_offload=bool(getattr(
                                 model, "handles_param_offload", False)))
    engine.install_param_fetch(model)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
