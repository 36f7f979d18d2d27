"""The training engine, on one device or over data-parallel ranks.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``
:93, ``initialize`` :2213):

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

**Several ranks.** With a process group (``comm.init_distributed``) the
engine builds the mesh of ``config.mesh`` over it (``comm/mesh.py``; one
process a rank, its device ``cuda:LOCAL_RANK`` or the CPU with
``device="cpu"``) and makes the collectives of JAX's
``runtime/zero/partition.py`` placements itself, eagerly, over the
``("data", "fsdp")`` group (:class:`~deepspeed_tpu_torch.runtime.zero.
partition.ZeroPartition`: each rank holds the contiguous block of a
sharded leaf):

* each rank's ``train_batch`` takes its own ``micro * gas`` rows (JAX's
  multi-process convention); the reported loss and aux metrics are the
  means over every rank;
* stages 0-1 all-reduce (mean) the f32 accumulators once a step; stages
  2-3 reduce-scatter each micro-batch's gradient onto the rank's block
  (a leaf that stays whole is all-reduced at the step);
* stage >= 1 keeps the f32 master and the moments of the rank's block
  only, and the optimizer updates that block; stages 1-2 then all-gather
  the 16-bit params, stage 3 keeps them sharded;
* stage 3 gathers the params for the forward: a model that declares
  ``handles_param_offload`` (GPT-2 with ``offload_params``) layer by layer
  through the engine's fetch, an all-gather whose backward
  reduce-scatters the gradient into the rank's accumulator (the remat
  recompute gathers again); any other model gets the whole tree gathered
  for the step;
* the clip's global norm sums each sharded leaf's block over the group
  and counts each whole leaf once; the fp16 finite flag is the minimum
  over every rank, so every rank skips together;
* ``sparse_gradients`` (stage 0, declared 2-D leaves): the row-sparse
  exchange of ``runtime/sparse_tensor.py`` instead of the dense mean.

Over a group of one rank (NCCL on the one card) every collective is an
identity and the numbers are the single-process engine's bit for bit.
Without a process group nothing of this runs.

The ``tensor`` and ``seq`` axes of ``config.mesh`` (the model's
``tp_specs``, JAX's entries; ``tp_fused`` names the leaves whose split dim
holds q, k and v side by side):

* each rank holds its ``tensor`` shard of each leaf
  (:class:`~deepspeed_tpu_torch.parallel.tensor_parallel.TensorLayout`),
  and ZeRO cuts its blocks on the dims tensor leaves free (the policy
  gets the specs); the model states the Megatron collectives, so the
  gradient of every leaf on a rank is that of its shard, and it is
  reduced over ``data``/``fsdp`` only;
* under ``seq`` each rank takes the whole batch of its data index and
  its block of the positions (the model's forward); the gradients are
  summed over ``seq`` before the ZeRO reduction, and the loss is the
  model's global one;
* the clip's norm sums a leaf's squares over the axes its blocks are
  spread over (``data``/``fsdp`` for a ZeRO block, ``tensor`` for a
  tensor shard) and counts it once along the others; the fp16 finite
  flag is the minimum over every rank;
* checkpoints, ``module_state_dict`` and ``fp32_master_params`` hold
  whole leaves in JAX's layout (the fused leaves put back together), so a
  tag saved at one tensor size resumes at another.

The pipe axis is ROADMAP.md A8.

ZeRO-Offload: ``offload_optimizer: {device: cpu}`` moves the optimizer
state (the rank's block) to the host (``runtime/zero/offload.py``); its
``implementation`` resolves as in JAX, with the TPU backend read as "the
engine's device is CUDA": ``auto`` gives ``stream`` on CUDA without fp16,
else ``host``.

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
the card for the step and dropped after it.

The NVMe tier (JAX ``runtime/engine.py:268-327``): ``offload_optimizer:
{device: nvme, nvme_path}`` (the host path) keeps the Adam moments in swap
files and streams them through the aio pool around each leaf's host Adam
(``HostOffloadOptimizer.step_swapped``); ``offload_param: {device: nvme,
nvme_path}`` at stage 3 swaps the params out to files after each step
(``engine.params`` then holds ``meta`` tensors, shapes only) and back into
pinned host memory before the next, or before anything else reads them.
Over ranks each rank swaps its own blocks under ``nvme_path/rank<r>``.
Checkpoints read and write the swapped moments through
``host_optimizer.npz`` under JAX's keys, so a tag moves between the
``cpu`` and ``nvme`` tiers bit for bit. ``destroy()`` closes the aio
handles.

Telemetry (``telemetry`` section, JAX ``runtime/engine.py:399-427``): the
flight recorder (event ring size and fault dump, the hang watchdog, the
memory monitor's ``params`` and ``optimizer_state`` components), the
numerics observatory (``numerics_enabled``: each block's grad, param and
update norms and non-finite gradient counts, JAX's block names; over
ranks one all-reduce of the ranks' shares; off, the step does no numerics
work) and goodput (``goodput``: each ``train_batch``'s wall split into
data wait, device and host; the device bucket ends at a
``torch.cuda.synchronize()``, the one sync a step it costs, and on the
offload paths at the final gradients, so the host Adam and the swaps
fall in host). ``set_numerics_enabled`` / ``set_goodput_enabled`` toggle
them; activation checkpointing's section is installed for
``deepspeed_tpu_torch.checkpointing``.

The JAX engine compiles that step into one XLA program; here it is eager
PyTorch around the flash kernels. No bf16 or fp32 step reads a device
value on the host: the batch goes up through pinned memory and the
learning rate is a host float. An fp16 step reads one bool, whether the
gradients are finite, to skip the update (the JAX engine reads the same
flag per step). The exception is every ``steps_per_print``-th step (10
by default): its monitor events read the loss and the gradient norm on
the host, a sync at the step's end, as the JAX engine's do
(``scripts/observe_cost.py`` times it). Gradients, moments and the
master are updated in place.

Telemetry as JAX's engine arms it: the flight recorder, numerics and
goodput (``_init_telemetry``), a trace per sampled train step whose
children come from goodput's splits (``telemetry.trace_sample_rate``), the
HTTP endpoint on ``telemetry.http_port`` (rank 0; a port already taken is
a warning, never a failed init), the compile watch over the step's
program, and every ``steps_per_print`` steps the monitor events, to the
registry sink and to ``MonitorMaster`` (CSV, TensorBoard, WandB).

Not in this slice (ROADMAP.md queue C): the pipe axis (A8), the 1-bit
optimizers, MoQ, eigenvalue, curriculum learning and the flops profiler
(A9).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import (DATA_AXES, MESH_AXES,
                                           axis_group,
                                           get_data_parallel_world_size,
                                           mesh_for, mesh_shape,
                                           set_global_mesh)
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.adam import (ONEBIT_OPTIMIZER_KEYS, Optimizer,
                                          build_optimizer,
                                          normalize_optimizer_key)
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorLayout
from deepspeed_tpu_torch.runtime.lr_schedules import Schedule, build_schedule
from deepspeed_tpu_torch.runtime.precision import (PRECISION_DTYPES,
                                                   cast_tree, grads_finite,
                                                   make_loss_scale,
                                                   update_loss_scale)
from deepspeed_tpu_torch.runtime.sparse_tensor import sparse_all_mean
from deepspeed_tpu_torch.runtime.utils import clip_coef, global_norm
from deepspeed_tpu_torch.runtime.zero.offload import (PARTS,
                                                      HostOffloadOptimizer,
                                                      StreamedOffloadOptimizer)
from deepspeed_tpu_torch.runtime.zero.param_offload import (ParamFetcher,
                                                            ParamSwapper,
                                                            stage, to_pinned)
from deepspeed_tpu_torch.runtime.zero.partition import (ZeroPartition,
                                                        ZeroShardingPolicy)
from deepspeed_tpu_torch.monitor.monitor import (MonitorMaster,
                                                 RegistryMonitor)
from deepspeed_tpu_torch.telemetry import (MetricRegistry, Tracer,
                                           get_registry, start_http_server)
from deepspeed_tpu_torch.telemetry.compile_watch import watched
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.unported import not_ported



def _refuse_unported(config: DeepSpeedConfig) -> None:
    mesh = config.mesh
    checks = (
        (mesh.pipe > 1, f"a mesh with pipe={mesh.pipe}", "A8"),
        (config.curriculum_learning.get("enabled", False),
         "curriculum_learning", "A9"),
        (bool(config.compression_config), "compression_training (MoQ)",
         "A9"),
        (config.eigenvalue.enabled, "eigenvalue", "A9"),
        (config.flops_profiler.enabled, "flops_profiler", "A9"),
    )
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(not_ported(what, item))


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
                 model_handles_param_offload: bool = False, mesh=None,
                 sparse_grad_paths=None, tp_specs=None, tp_fused=None):
        _refuse_unported(config)
        # several ranks: a process group exists (or a mesh is given)
        self._dist = mesh is not None or dist.is_initialized()
        if device is None and self._dist and dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = resolve_device(device)
        if self._dist:
            self.mesh = mesh if mesh is not None else mesh_for(config.mesh)
            set_global_mesh(self.mesh)
            self.dp = get_data_parallel_world_size(self.mesh)
            group, ranks = axis_group(DATA_AXES, self.mesh)
            self._dp_index = ranks.index(dist.get_rank())
        else:
            m = config.mesh
            n = max(m.data, 1) * m.fsdp * m.tensor * m.seq
            if n > 1:
                raise ValueError(
                    f"a mesh of {n} devices ({config.mesh}) needs {n} ranks: "
                    "start them with torchrun (or the launcher's "
                    "variables) and call deepspeed_tpu_torch."
                    "init_distributed()")
            self.mesh, self.dp, self._dp_index = None, 1, 0
        self._sp = mesh_shape(self.mesh)["seq"]
        config.resolve_batch_config(self.dp)
        comm.configure(deepspeed_config=config)
        self.config = config
        self.loss_fn = loss_fn
        self.compute_dtype = PRECISION_DTYPES[config.precision_dtype]
        self.mixed_precision = config.precision_dtype != "float32"
        self.fp16 = config.fp16.enabled
        self.gas = config.gradient_accumulation_steps
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        opt_cfg = config.optimizer
        self._resolve_sparse(config, opt_cfg, sparse_grad_paths)
        if optimizer is None:
            optimizer = build_optimizer(opt_cfg.type if opt_cfg else "AdamW",
                                        dict(opt_cfg.params) if opt_cfg
                                        else {})
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler or build_schedule(
            config.scheduler, opt_cfg.params if opt_cfg else None)
        # activation checkpointing (JAX engine.py:227-238): install the
        # JSON section for models that call deepspeed_tpu_torch.
        # checkpointing.checkpoint(); without it, clear what an earlier
        # engine installed and keep a user's own configure()
        from deepspeed_tpu_torch.runtime import activation_checkpointing
        ac = config.activation_checkpointing
        if ac != type(ac)():
            activation_checkpointing.configure(ac, _by_engine=True)
        else:
            activation_checkpointing.reset(only_engine_installed=True)
        self._resolve_zero(config, model_handles_param_offload, params,
                           tp_specs, tp_fused)
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
        # step metrics go to the registry sink first; MonitorMaster (tb /
        # wandb / csv) is one sink of several (JAX :358-363)
        self.monitor = self._build_monitor()
        self._registry_sink = RegistryMonitor(self.telemetry)
        # request-scoped tracing: every sampled train step becomes a root
        # span with data-wait / device / host children from goodput's
        # splits
        self.tracer = None
        if tc.enabled and tc.trace_sample_rate > 0:
            self.tracer = Tracer(
                sample_rate=tc.trace_sample_rate,
                ring_capacity=tc.trace_ring_capacity,
                seed=tc.trace_seed,
                slow_threshold_s=tc.trace_slow_threshold_s,
                registry=self.telemetry)
        self._telemetry_http = None
        if tc.enabled and tc.http_port is not None and \
                comm.get_rank() == 0:
            try:
                self._telemetry_http = start_http_server(
                    tc.http_port, host=tc.http_host,
                    registry=self.telemetry, tracer=self.tracer)
            except OSError as e:   # port taken must not kill training
                logger.warning(f"telemetry endpoint unavailable: {e}")
        # the compile watch over the step's program: each new micro-batch
        # signature (shapes, dtypes) is one
        self._micro_grads_w = watched(self._micro_grads, "train_step",
                                      registry=self.telemetry)
        self._init_telemetry(tc)
        n = sum(p.numel() for p in self.params.values())
        tiers = [t for t, on in (
            ("host", self.host_opt is not None),
            ("stream", self._stream_opt is not None),
            ("param", self._param_offload_cfg is not None)) if on]
        logger.info(f"engine ready: {n} parameters on {self.device} "
                    f"(rank {self._dp_index} of {self.dp}), "
                    f"dtype={config.precision_dtype} "
                    f"micro={self.micro_batch_size} gas={self.gas} "
                    f"zero_stage={self.zero_stage} offload={tiers or None}")

    # -------------------------------------------------------- telemetry
    def _init_telemetry(self, tc) -> None:
        """The flight recorder, the numerics observatory and goodput
        accounting, armed as the JAX engine arms them (JAX
        ``runtime/engine.py:399-427``). The block spec is built once from
        the param names (JAX's block names, ``telemetry/numerics.py``)."""
        from deepspeed_tpu_torch.telemetry.goodput import GoodputMeter
        from deepspeed_tpu_torch.telemetry.numerics import (
            NumericsWatch, block_spec, register_numerics_watch)
        self._init_flight_recorder(tc)
        self._telemetry_on = tc.enabled
        self._numerics_spec = block_spec(self.params,
                                         depth=tc.numerics_block_depth)
        self._numerics_on = bool(tc.enabled and tc.numerics_enabled)
        self.numerics = NumericsWatch(
            self._numerics_spec.names, registry=self.telemetry,
            window=tc.numerics_spike_window,
            threshold=tc.numerics_spike_threshold, source="train",
            dump_path=tc.events_dump_path)
        if tc.enabled:
            register_numerics_watch("train", self.numerics)
        self.goodput = GoodputMeter(registry=self.telemetry,
                                    enabled=bool(tc.enabled and tc.goodput),
                                    source="train")
        if self._numerics_on and self._sparse_axes:
            logger.warning(
                "telemetry.numerics_enabled is not supported with the "
                "sparse-gradient exchange (JAX's explicit-DP step) — "
                "numerics disabled for this engine")
            self._numerics_on = False

    def _init_flight_recorder(self, tc) -> None:
        """The config-gated flight-recorder surfaces (JAX
        ``_init_flight_recorder``): the event ring's size and fault dump,
        the hang watchdog, and the memory monitor's ``params`` and
        ``optimizer_state`` components (the f32 master and the moments,
        on the card or the host, included) through weak references, so a
        dropped engine never stays alive through the monitor."""
        import weakref

        from deepspeed_tpu_torch.telemetry.flight import arm_flight_recorder
        ref = weakref.ref(self)

        def _params():
            eng = ref()
            return None if eng is None else eng.params

        def _opt_state():
            eng = ref()
            if eng is None:
                return None
            host = eng.host_opt
            return (eng.opt_state, eng.master,
                    None if host is None else (host.master, host.state))

        self._flight = arm_flight_recorder(
            tc, self.telemetry, "train_watchdog",
            [("params", _params), ("optimizer_state", _opt_state)])
        self.watchdog = self._flight.watchdog

    def _numerics_weight(self, split: Callable[[str], tuple]):
        """Which leaves this rank counts in the block sums: a leaf whose
        part here is the same on other ranks (replicated along an axis it
        is not split across) counts on the rank at index 0 of those axes
        only, so the all-reduce over every axis counts it once."""
        if not self._dist:
            return None
        from deepspeed_tpu_torch.comm.mesh import mesh_coordinate
        coord = mesh_coordinate(self.mesh)
        shape = mesh_shape(self.mesh)
        axes = [a for a in MESH_AXES if shape[a] > 1]
        return lambda n: all(coord[a] == 0 for a in axes
                             if a not in split(n))

    def _split_master(self, n: str) -> tuple:
        """The axes the rank's master (and update) of ``n`` is a block
        over."""
        return ((DATA_AXES if self._msh(n) else ()) +
                (("tensor",) if self.tpl.sharded(n) else ()))

    def _split_params(self, n: str) -> tuple:
        return ((DATA_AXES if self._psh(n) else ()) +
                (("tensor",) if self.tpl.sharded(n) else ()))

    def _numerics_pre(self, grads) -> list:
        """The step's block statistics before the clip and the update
        (JAX ``grad_core`` with ``want_numerics``): the squared norms of
        the unscaled gradients, their non-finite counts and the squared
        norms of the params (the f32 master on the in-HBM path; the
        compute params on the offload paths, as in JAX)."""
        from deepspeed_tpu_torch.telemetry.numerics import (
            block_nonfinite_counts, block_sq_norms)
        spec = self._numerics_spec
        g = dict(zip(self.params, grads))
        gw = self._numerics_weight(self._split_axes)
        if self.host_opt is not None or self._stream_opt is not None or \
                self.master is None:
            src, pw = self.params, self._numerics_weight(self._split_params)
        else:
            src, pw = self.master, self._numerics_weight(self._split_master)
        return [block_sq_norms(g, spec, gw),
                block_nonfinite_counts(g, spec, gw).float(),
                block_sq_norms(src, spec, pw).to(self.device)]

    def _observe_numerics(self, pre, upd_sq, loss) -> None:
        """One read of the step's ``[n_blocks, 4]`` statistics (over ranks
        after one all-reduce of the ranks' shares) into the numerics
        watch (JAX ``_observe_numerics``). Guarded: observability never
        kills a training step."""
        try:
            have_upd = upd_sq is not None
            if upd_sq is None:
                upd_sq = torch.zeros_like(pre[0])
            stats = torch.stack([pre[0], pre[2], upd_sq.to(pre[0].device),
                                 pre[1]], 1)
            if self._dist:
                stats = comm.all_reduce(stats, comm.SUM, MESH_AXES)
            stats = stats.cpu().double().numpy()
            self.numerics.observe(
                step=self.global_steps, loss=float(loss),
                grad_norms=stats[:, 0] ** 0.5,
                param_norms=stats[:, 1] ** 0.5,
                update_norms=stats[:, 2] ** 0.5 if have_upd else None,
                nonfinite=stats[:, 3].astype("int64"))
        except Exception as e:  # noqa: BLE001
            logger.warning(f"numerics observe failed: {e}")

    def _record_step_progress(self) -> None:
        """The flight recorder's step event and the watchdog heartbeat,
        once an optimizer step (JAX ``_record_step_progress``)."""
        from deepspeed_tpu_torch.telemetry import events as _ev
        _ev.record_event(_ev.STEP_END, source="train",
                         step=self.global_steps)
        if self.watchdog is not None:
            self.watchdog.notify_progress()

    def set_numerics_enabled(self, enabled: bool) -> None:
        """Turn the numerics observatory on or off between steps
        (``telemetry.numerics_enabled`` sets the first state). Off, the
        step runs no numerics work and reads nothing back."""
        enabled = bool(enabled)
        if enabled and not self._telemetry_on:
            logger.warning("numerics requires telemetry.enabled — ignoring")
            return
        if enabled and self._sparse_axes:
            logger.warning("numerics is not supported with the "
                           "sparse-gradient exchange — ignoring")
            return
        self._numerics_on = enabled

    def set_goodput_enabled(self, enabled: bool) -> None:
        """Turn goodput accounting on or off (host timers; on CUDA one
        ``torch.cuda.synchronize()`` a step while on)."""
        self.goodput.enabled = bool(enabled)

    # ------------------------------------------------------------- ZeRO
    def _resolve_sparse(self, config, opt_cfg, sparse_grad_paths) -> None:
        """``sparse_gradients`` and JAX's refusals (JAX
        ``runtime/engine.py:176-223``): only declared 2-D leaves (fnmatch
        patterns over the JAX tree's ``/``-joined paths) ride the sparse
        exchange, over pure data parallelism at stage 0."""
        self._sparse_patterns = tuple(sparse_grad_paths or ())
        self._sparse_axes = ()
        self._sparse_grad_caps: Dict[str, Optional[int]] = {}
        if not config.sparse_gradients:
            return
        opt_type = normalize_optimizer_key(opt_cfg.type if opt_cfg
                                           else "AdamW")
        if opt_type in ONEBIT_OPTIMIZER_KEYS and self.dp > 1:
            raise NotImplementedError(
                "sparse_gradients cannot combine with the 1-bit optimizer "
                "family (its error-feedback compression assumes dense "
                "tensors — same as the reference)")
        if config.fp16.enabled:
            raise NotImplementedError(
                "sparse_gradients + fp16 loss scaling is not wired into the "
                "explicit-exchange step; use bf16")
        if not self._sparse_patterns:
            logger.warning(
                "sparse_gradients enabled but no sparse_grad_paths declared "
                "(model attribute or initialize kwarg) — falling back to "
                "the dense exchange. NOTE: tied input/output embeddings "
                "must NOT be declared (their gradient is dense through the "
                "logits)")
        elif self.dp > 1:
            if config.zero_config.stage != 0:
                raise ValueError(
                    "sparse_gradients requires replicated parameters "
                    "(zero_optimization.stage=0); the reference ZeRO "
                    "optimizer rejects sparse gradients too")
            shape = mesh_shape(self.mesh)
            self._sparse_axes = tuple(a for a in DATA_AXES if shape[a] > 1)
        else:
            logger.info("sparse_gradients: no data-parallel extent, "
                        "nothing to exchange")

    def _resolve_zero(self, config, model_handles_param_offload,
                      params, tp_specs=None, tp_fused=None) -> None:
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
        self._param_swapper = None
        if self._param_offload_cfg is not None and \
                self._param_offload_cfg.device == "nvme":
            if not self._param_offload_cfg.nvme_path:
                raise ValueError("offload_param.device=nvme requires "
                                 "nvme_path")
            self._param_swapper = ParamSwapper(
                self._swap_dir(self._param_offload_cfg.nvme_path))
        # the ZeRO blocks of each leaf (several ranks): params at stage 3,
        # gradients at 2-3, the master and the moments at 1-3
        self._p_shard = self._dist and self.zero_stage >= 3
        self._g_shard = self._dist and self.zero_stage >= 2
        self._m_shard = self._dist and self.zero_stage >= 1
        # the whole leaves' shapes, and the rank's tensor shards' (the
        # leaves the ZeRO blocks are cut from)
        self._full_shapes = {k: tuple(v.shape) for k, v in params.items()}
        self.tpl = TensorLayout(tp_specs or {}, self._full_shapes, tp_fused,
                                size=mesh_shape(self.mesh)["tensor"])
        self._shapes = {k: self.tpl.local_shape(k, s)
                        for k, s in self._full_shapes.items()}
        self.part = None
        if self._dist:
            threshold = (zc.stage3_param_persistence_threshold
                         if self.zero_stage >= 3 else 0)
            self.part = ZeroPartition(
                ZeroShardingPolicy(self.zero_stage, self.mesh,
                                   tp_specs=tp_specs,
                                   param_persistence_threshold=threshold),
                self._full_shapes)
        # a model that fetches its own layers: with offload_param, or to
        # gather its stage-3 blocks layer by layer
        self._model_fetches_params = bool(
            model_handles_param_offload and
            (self._param_offload_cfg is not None or self._p_shard))
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

    def _swap_dir(self, path: str) -> str:
        """The rank's swap directory: ``path`` itself in one process,
        ``path/rank<r>`` over ranks (each rank swaps its own blocks, and
        two ranks on one machine never share a file)."""
        if not self._dist:
            return path
        import os
        return os.path.join(path, f"rank{dist.get_rank()}")

    # ------------------------------------------------------------ state
    def _psh(self, n: str) -> bool:
        """The rank holds a block of param ``n`` (stage 3)."""
        return self._p_shard and self.part.sharded(n)

    def _gsh(self, n: str) -> bool:
        """The rank accumulates a block of the gradient of ``n``."""
        return self._g_shard and self.part.sharded(n)

    def _msh(self, n: str) -> bool:
        """The rank holds a block of the master and moments of ``n``."""
        return self._m_shard and self.part.sharded(n)

    def _block(self, n: str, t, sharded: bool) -> torch.Tensor:
        """The rank's part of whole leaf ``n``: its tensor shard, then its
        ZeRO block where ``sharded``."""
        t = torch.as_tensor(t)
        if self.tpl.sharded(n):
            t = self.tpl.shard(n, t).contiguous()
        return self.part.shard(n, t).contiguous() if sharded else t

    def _init_state(self, params) -> None:
        """f32 master (a copy of ``params``, the rank's blocks at stage >=
        1), compute params cast from the caller's weights (the rank's
        blocks at stage 3; the master itself in fp32 where the layouts
        agree), optimizer state and loss scale. With ``offload_optimizer``
        the master and the optimizer state go to the host (``host_opt`` or
        ``_stream_opt``); with ``offload_param`` the compute params live
        in pinned host memory."""
        def compute(k, v):
            return self._block(k, v, self._psh(k)).to(
                self.device, torch.float32, copy=not self.mixed_precision
            ).to(self.compute_dtype)

        if self._offload_cfg is not None and not self._offload_stream:
            # the f32 master straight to the host, and no f32 copy on the
            # card: the compute params are cast from the caller's weights
            opt_cfg = self.config.optimizer
            self.host_opt = HostOffloadOptimizer(
                {k: self._block(k, v, self._msh(k))
                 for k, v in params.items()},
                opt_cfg.params if opt_cfg else {},
                device=self._offload_cfg.device,
                nvme_path=(self._swap_dir(self._offload_cfg.nvme_path)
                           if self._offload_cfg.nvme_path else None))
            self.params = {k: compute(k, v) for k, v in params.items()}
            self.master = self.opt_state = None
        else:
            master = {k: self._block(k, v, self._msh(k)).to(
                self.device, torch.float32, copy=True)
                for k, v in params.items()}
            # the params are the master in fp32 unless the layouts differ
            # (stages 1-2 over ranks) or the params leave the card
            own = (self.mixed_precision or self._param_offload_cfg is not
                   None or self.zero_stage in (1, 2) and self._dist)
            if not own:
                self.params = master
            elif self._p_shard or not self._m_shard:
                self.params = cast_tree(master, self.compute_dtype)
            else:
                self.params = {k: compute(k, v) for k, v in params.items()}
            if self._offload_stream:
                self._stream_opt = StreamedOffloadOptimizer(
                    self.optimizer, master, self.mixed_precision)
                self.master = self._stream_opt.master
                self.opt_state = self._stream_opt.opt_state
            else:
                self.master = master if own else None
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
        self._step_tokens = 0   # the step's tokens (sparse capacities)
        self._index = {n: i for i, n in enumerate(self.params)}
        self._sink_first = True

    def install_param_fetch(self, model) -> None:
        """Give a ``handles_param_offload`` model the engine's fetch; its
        weights' gradients then go to the accumulators (``_deposit``).
        At stage 3 over ranks the fetch all-gathers the layer's blocks."""
        if self._model_fetches_params:
            self._fetcher = ParamFetcher(
                self.device, self._deposit,
                gather=self._fetch_whole if self._p_shard else None)
            model.set_param_fetch(self._fetcher)

    def _fetch_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the rank's block on the card (a new
        tensor)."""
        if self._psh(name):
            return comm.all_gather(t, DATA_AXES, axis=self.part.dims[name])
        return t.clone()

    def _to_acc(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """A micro-batch's whole gradient in the accumulator's layout: the
        group's mean on the rank's block (f32) where the rank accumulates
        a block, else as it is. Under ``seq`` the micro-batch's gradient
        is first summed over the seq ranks (each saw its positions)."""
        if self._sp > 1:
            grad = comm.all_reduce(grad.float(), comm.SUM, "seq")
        if not self._gsh(name) or tuple(grad.shape) != self._shapes[name]:
            return grad
        g = comm.reduce_scatter(grad.float(), DATA_AXES,
                                axis=self.part.dims[name])
        return g.div_(self.dp) if self.dp > 1 else g

    def _deposit(self, name: str, grad: torch.Tensor) -> None:
        acc = self._acc[self._index[name]]
        grad = self._to_acc(name, grad)
        if self._sink_first:
            acc.copy_(grad)
        else:
            acc.add_(grad)
        self._deposited.add(name)

    def _step_params(self):
        """The params a micro-batch runs on: the whole tree on the card
        for this step (``offload_param`` or stage-3 blocks, with a model
        that does not fetch its own layers), else the engine's own."""
        if self._fetcher is not None or (self._param_offload_cfg is None
                                         and not self._p_shard):
            return self.params
        if self._staged is None:
            self._staged = (self._gather_tree() if self._p_shard
                            else stage(self.params, self.device))
        return self._staged

    def _gather_tree(self) -> Dict[str, torch.Tensor]:
        """Every param whole on the card for one step, autograd leaves:
        gathered from the ranks' blocks (staged from the host first with
        ``offload_param``); a whole param on the card is itself."""
        out = {}
        for n, p in self.params.items():
            t = p.detach()
            if self._psh(n):
                t = comm.all_gather(t.to(self.device, non_blocking=True),
                                    DATA_AXES, axis=self.part.dims[n])
            elif t.device == self.device:
                out[n] = p
                continue
            else:
                t = t.to(self.device, non_blocking=True, copy=True)
            out[n] = t.requires_grad_(True)
        return out

    def _gathers(self, n: str) -> bool:
        """Param ``n`` is whole while its master is a block (stages
        1-2): the updated block is all-gathered."""
        return self._msh(n) and not self._psh(n)

    def _cast_params_from(self, master) -> None:
        """The compute params cast from ``master`` by the step's own cast
        (``_foreach_copy_``; one copy a leaf across devices); a block of a
        whole param is cast, then all-gathered into it."""
        names = [n for n in master if not self._gathers(n)]
        dst = [self.params[n].detach() for n in names]
        src = [master[n] for n in names]
        if not names:
            pass
        elif all(d.device == m.device for d, m in zip(dst, src)):
            torch._foreach_copy_(dst, src)
        else:
            for d, m in zip(dst, src):
                d.copy_(m)
        for n in master:
            if self._gathers(n):
                self._gather_into(n, master[n])

    def _gather_into(self, n: str, block: torch.Tensor) -> None:
        """All-gather the new blocks of param ``n`` (in its dtype) into
        it."""
        p = self.params[n].detach()
        p.copy_(comm.all_gather(block.to(self.device, p.dtype), DATA_AXES,
                                axis=self.part.dims[n]))

    def _param_dest(self):
        """Where an offloaded optimizer writes the new params: the param
        itself, or a block buffer to all-gather (stages 1-2 over ranks)."""
        return {n: (torch.empty(self.part.shard_shape(n, p.shape),
                                dtype=p.dtype, device=p.device)
                    if self._gathers(n) else p)
                for n, p in self.params.items()}

    def _gather_dest(self, dest) -> None:
        for n, t in dest.items():
            if self._gathers(n):
                self._gather_into(n, t)

    def _master(self):
        return self.params if self.master is None else self.master

    def _swap_params_out(self) -> None:
        """NVMe param tier: after the step, the params go to their swap
        files and ``self.params`` keeps their shapes only (``meta``
        tensors); host memory between steps holds none of them."""
        sw = self._param_swapper
        if sw is None:
            return
        t = time.perf_counter()
        self.params = sw.swap_out(self.params)
        if self.device.type == "cuda" and hasattr(torch._C,
                                                  "_host_emptyCache"):
            torch._C._host_emptyCache()   # give the pinned pages back
        self.offload_step_times["param_out_s"] = time.perf_counter() - t
        self.offload_step_times["param_bytes"] = sw.last_bytes

    def _resident(self) -> None:
        """Read NVMe-swapped params back into pinned host memory before
        anything reads ``self.params`` (a step, ``forward``, checkpoints,
        the module state)."""
        sw = self._param_swapper
        if sw is None or not sw.on_disk:
            return
        t = time.perf_counter()
        self.params = sw.swap_in()
        for p in self.params.values():
            p.requires_grad_(True)
        self._param_in_s = time.perf_counter() - t

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
            if self._dist:   # every rank skips together
                finite = comm.all_reduce(finite.float(), comm.MIN,
                                         MESH_AXES) > 0
        # the numerics' block statistics: pre-clip, as in JAX (the clip
        # would carry one block's NaN into every block)
        numer = self._numerics_pre(grads) if self._numerics_on else None
        self._upd_sq = None
        # bf16 grads (``_native_out``, never with fp16): the norm and the
        # clip in f32, each gradient rounded back to bf16 (JAX
        # native_acc_out). Over ranks a block's squares are summed over
        # the axes it is spread over and counted once along the others.
        gnorm = (global_norm(grads, sharded=[self._split_axes(n)
                                             for n in self.params],
                             axis_name=DATA_AXES + (
                                 ("tensor",) if self.tpl.size > 1 else ()))
                 if self._dist else global_norm(grads))
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
        self._grads_ready_t = time.perf_counter()
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
        if numer is not None:
            self._observe_numerics(numer, None if (
                self.host_opt is not None or self._stream_opt is not None)
                else self._upd_sq if self._upd_sq is not None
                else torch.zeros_like(numer[0]), mean_loss)
        return {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": scale, "skipped": self._last_skipped}

    def _split_axes(self, n: str) -> tuple:
        """The axes the rank's gradient of ``n`` is a block over."""
        return ((DATA_AXES if self._gsh(n) else ()) +
                (("tensor",) if self.tpl.sharded(n) else ()))

    def _update(self, grads, lr) -> None:
        """The optimizer step on the master (the rank's blocks), wherever
        it lives, and the compute params refreshed from it."""
        names = list(self.params)
        grads = {n: self._to_master(n, g) for n, g in zip(names, grads)}
        if self.host_opt is not None or self._stream_opt is not None:
            dest = self._param_dest()
            if self._stream_opt is not None:
                self._stream_opt.step(grads, lr, dest)
            elif self.host_opt.swapper is not None:
                self.host_opt.step_swapped(grads, lr, dest)
            else:
                self.host_opt.step_streamed(grads, lr, dest)
            self._gather_dest(dest)
            return
        master = self._master()
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state,
            {k: v.detach() for k, v in master.items()}, lr)
        if self._numerics_on:
            from deepspeed_tpu_torch.telemetry.numerics import block_sq_norms
            self._upd_sq = block_sq_norms(
                updates, self._numerics_spec,
                self._numerics_weight(self._split_master))
        torch._foreach_add_([master[n].detach() for n in names],
                            [updates[n] for n in names])
        del updates
        if master is not self.params:
            self._cast_params_from(master)

    def _to_master(self, n: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient in its master's layout: the rank's block of a whole
        gradient where the master is a block (stage 1)."""
        if self._msh(n) and tuple(g.shape) == self._shapes[n]:
            g = self.part.shard(n, g)
            if not g.is_contiguous():
                g = g.contiguous()
        return g

    def _reduce_grads(self) -> None:
        """The group's mean of every accumulator the rank holds whole (all
        of them at stages 0-1): a dense all-reduce, or the row-sparse
        exchange of a declared leaf."""
        for i, n in enumerate(self.params):
            if self._gsh(n):
                continue   # reduce-scattered micro-batch by micro-batch
            g = self._acc[i]
            cap = self._sparse_grad_caps.get(n)
            if cap is not None:
                r = sparse_all_mean(g, cap, self._sparse_axes)
            else:
                r = comm.all_reduce(g.float(), comm.SUM, DATA_AXES)
                if self.dp > 1:
                    r.div_(self.dp)
            g.copy_(r)

    def _sparse_caps(self) -> None:
        """Each declared leaf's capacity from this step's tokens (JAX
        ``_make_sparse_step_fn``), None where the sparse exchange would
        not move fewer bytes than the dense one."""
        self._sparse_grad_caps = {}
        for n, shape in self._shapes.items():
            cap = None
            if len(shape) == 2 and any(
                    fnmatch.fnmatch(n.replace(".", "/"), p)
                    for p in self._sparse_patterns):
                c = min(self._step_tokens, shape[0] - 1)
                if 2 * c * self.dp < shape[0]:
                    cap = c
            self._sparse_grad_caps[n] = cap

    # ----------------------------------------------------------- public
    def train_batch(self, batch=None) -> Dict[str, Any]:
        """One optimizer step over ``micro * gas`` rows; returns ``loss``
        (the mean over micro-batches), ``grad_norm``, ``lr``,
        ``loss_scale``, ``skipped`` and the mean of each aux metric. Over
        ranks ``batch`` is this rank's ``micro * gas`` rows and the loss
        and aux metrics are the means over every rank."""
        t_wall = time.perf_counter()   # goodput: the step's wall interval
        data_wait = 0.0
        rows = self.micro_batch_size * self.gas
        if batch is None:
            # the loader yields global batches, the same on every rank
            # (one seed): each rank takes its own rows
            batch = {k: v[self._dp_index * rows:(self._dp_index + 1) * rows]
                     for k, v in next(self.training_dataloader).items()}
            data_wait = time.perf_counter() - t_wall
        self._resident()   # an NVMe param swap-in falls in host
        t_disp = time.perf_counter()
        batch = self._upload(batch)
        leading = next(iter(batch.values())).shape[0]
        if leading != rows:
            raise ValueError(f"batch leading dim {leading} != micro*gas = "
                             f"{rows} (each rank's rows)")
        if self._acc_losses:
            raise RuntimeError("train_batch() called with micro-batches from "
                               "backward() not yet applied by step()")
        rows = self.micro_batch_size
        for i in range(self.gas):
            self.backward({k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()})
        metrics = self.step()
        device_s = 0.0
        if self.goodput.enabled:
            # the device bucket: dispatch to the step's results on the
            # card (the one sync goodput costs); on the offload paths to
            # the final gradients, so the host Adam and the swaps fall in
            # host, as in JAX (offload_step_times' device_s is the same
            # interval from the first backward)
            if self.host_opt is not None:
                device_s = self._grads_ready_t - t_disp
            else:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                device_s = time.perf_counter() - t_disp
            self.goodput.record_step(time.perf_counter() - t_wall,
                                     data_wait, device_s)
        self._record_step_trace(time.perf_counter() - t_wall, data_wait,
                                device_s)
        return metrics

    def forward(self, batch):
        """Loss of one micro-batch, without gradients (over ranks the mean
        over every rank's micro-batch: every rank calls it)."""
        self._resident()
        with torch.no_grad():
            params = self._step_params()
            if params is self._staged and not self._acc_losses:
                self._staged = None   # no step will drop it
            loss = _split_loss_out(
                self.loss_fn(params, self._upload(batch), None))[0]
            if self._dist:   # the mean over every rank's micro-batch
                loss = comm.all_reduce(loss.float(), comm.AVG, DATA_AXES)
            return loss

    def backward(self, batch):
        """Accumulate the gradients of one micro-batch (f32; bf16 with
        ``_native_out``); returns its loss (this rank's)."""
        if not self._acc_losses:
            self._resident()
            self._step_t0 = time.perf_counter()
            self._step_tokens = 0
        if self._acc is None:
            dtype = torch.bfloat16 if self._native_out else torch.float32
            self._acc = [torch.empty(self.part.shard_shape(n, shape)
                                     if self._gsh(n) else shape,
                                     dtype=dtype, device=self.device)
                         for n, shape in self._shapes.items()]
        self._sink_first = not self._acc_losses
        mb = self._upload(batch)
        self._step_tokens += max(v.numel() for v in mb.values())
        loss, aux, grads = self._micro_grads_w(mb, self._loss_scale.scale)
        if grads is not None:
            grads = [self._to_acc(n, g) for n, g in zip(self.params, grads)]
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
        mean_loss = sum(losses) / len(losses)
        keys = list(auxes[0]) if auxes and auxes[0] else []
        aux = {k: sum(a[k] for a in auxes) / len(auxes) for k in keys}
        if self._dist:
            if self._sparse_axes:
                self._sparse_caps()
            self._reduce_grads()
            # the loss and aux metrics: means over every rank, in one call
            vals = comm.all_reduce(torch.stack(
                [mean_loss.float()] + [aux[k] for k in keys]), comm.AVG,
                DATA_AXES)
            mean_loss, aux = vals[0], dict(zip(keys, vals[1:]))
        metrics = self._apply(self._acc, mean_loss)
        metrics.update(aux)
        self._swap_params_out()
        self._record_step_progress()
        if self.global_steps % self.config.steps_per_print == 0:
            self._write_monitor_events(metrics)
        return metrics

    def _build_monitor(self):
        try:
            return MonitorMaster(self.config)
        except Exception:  # noqa: BLE001 — a monitor never stops training
            return None

    def _write_monitor_events(self, metrics) -> None:
        """JAX's events (loss, lr and, when present, the fp16 loss scale
        and the global grad norm) to every live sink: the registry sink
        and MonitorMaster (JAX :2192-2210). Runs every
        ``steps_per_print`` steps: it reads the metrics on the host."""
        samples = self.global_steps * self.train_batch_size
        events = [("Train/Samples/train_loss", float(metrics["loss"]),
                   samples),
                  ("Train/Samples/lr", float(metrics["lr"]), samples)]
        if self.config.fp16.enabled and "loss_scale" in metrics:
            events.append(("Train/Samples/loss_scale",
                           float(metrics["loss_scale"]), samples))
        if "grad_norm" in metrics and metrics["grad_norm"] is not None:
            events.append(("Train/Samples/grad_norm",
                           float(metrics["grad_norm"]), samples))
        for sink in (self._registry_sink, self.monitor):
            if sink is not None and sink.enabled:
                sink.write_events(events)

    def _record_step_trace(self, wall: float, data_wait: float,
                           device_s: float) -> None:
        """One trace per train step (head-sampled): a root ``train_step``
        span whose data-wait / device / host children are laid out from
        goodput's splits, summing to the root. With ``telemetry.goodput``
        off the device interval is unmeasured (tracing adds no sync), so
        the host child absorbs it."""
        if self.tracer is None:
            return
        now = self.tracer.clock()
        wall = max(float(wall), 0.0)
        data = min(max(float(data_wait), 0.0), wall)
        device = min(max(float(device_s), 0.0), wall - data)
        t0 = now - wall
        tr = self.tracer.start_trace(
            "train_step", trace_id=self.global_steps, start=t0,
            step=self.global_steps,
            goodput_measured=self.goodput.enabled)
        if data:
            tr.add_span("data_wait", t0, t0 + data)
        if device:
            tr.add_span("device", t0 + data, t0 + data + device)
        tr.add_span("host", t0 + data + device, now)
        self.tracer.finish(tr, end=now)

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
        """The f32 master weights, whole, copied to the host (over ranks a
        collective: every rank calls it)."""
        self._resident()
        if self.host_opt is not None:
            return {k: self._whole(k, v.reshape(self.host_opt.shapes[k]),
                                   self._msh(k)).to("cpu", copy=True)
                    for k, v in self.host_opt.master.items()}
        self._sync_host_state()
        return {k: self._whole(k, v, self._msh(k)).float().to(
            "cpu", copy=True) for k, v in self._master().items()}

    def _whole(self, n: str, t: torch.Tensor, sharded: bool) -> torch.Tensor:
        """Leaf ``n`` whole: all-gathered from the ranks' ZeRO blocks
        (where ``sharded``) and tensor shards (every rank calls it), or
        ``t`` itself."""
        t = t.detach()
        if sharded:
            t = comm.all_gather(t.to(self.device), DATA_AXES,
                                axis=self.part.dims[n])
        if self.tpl.sharded(n):
            t = self.tpl.gather(n, t.to(self.device))
        return t

    def _params_as_master(self) -> Dict[str, torch.Tensor]:
        """The compute params in the master's layout (the rank's blocks
        of whole params at stages 1-2)."""
        return {n: self.part.shard(n, p.detach()) if self._gathers(n)
                else p for n, p in self.params.items()}

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
        """The compute-dtype weights, whole, copied to the host, by the
        engine's names (over ranks a collective)."""
        self._resident()
        return {k: self._whole(k, v, self._psh(k)).to("cpu", copy=True)
                for k, v in self.params.items()}

    def load_module_state_dict(self, state_dict) -> None:
        """Load the module weights only: each is cast to its param's
        dtype, the optimizer state is untouched and the f32 master is
        cast from the loaded params (as ``load_checkpoint(
        load_module_only=True)`` keeps the optimizer). Names may be the
        engine's or the JAX package's ``/``-joined ones."""
        self._resident()
        sd = {k.replace("/", "."): v for k, v in state_dict.items()}
        missing = set(self.params) - set(sd)
        if missing:
            raise KeyError(f"state_dict missing params: {sorted(missing)[:5]}")
        with torch.no_grad():
            for n, p in self.params.items():
                v = sd[n] if torch.is_tensor(sd[n]) else torch.tensor(sd[n])
                v = v.reshape(self._full_shapes[n])
                p.detach().copy_(self._block(n, v, self._psh(n)))
            if self.host_opt is not None:
                self.host_opt.sync_master_from(self._params_as_master())
            elif self.master is not None:
                self._sync_host_state()
                src = self._params_as_master()
                for n, m in self.master.items():
                    m.copy_(src[n].detach())

    def save_16bit_model(self, save_dir,
                         save_filename: str = "model.safetensors") -> str:
        """The compute-precision weights as ONE safetensors file with the
        engine's dotted names (reference ``save_16bit_model``)."""
        import os

        from deepspeed_tpu_torch.utils.safetensors_io import save_file
        out = os.path.join(save_dir, save_filename)
        sd = self.module_state_dict()   # over ranks: every rank gathers
        if comm.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            save_file(sd, out)
            logger.info(f"saved 16-bit model: {out} ({len(self.params)} "
                        "tensors)")
        comm.barrier()
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
        params (the JAX engine's state there: params, no master).

        Over ranks the layout is the same logical one: each sharded leaf
        is all-gathered leaf by leaf (at most one whole leaf on the card
        at a time) and copied to the host on rank 0, which writes; the
        other ranks get empty groups."""
        self._resident()
        ls = self._loss_scale
        loss_scale = {"scale": ls.scale, "growth_tracker": ls.growth_tracker,
                      "hysteresis": ls.hysteresis}
        host = (self._whole_on_root if self._dist
                else lambda group, sharded: group)
        if self.host_opt is not None:
            return {"params": host({k: v.detach() for k, v in
                                    self.params.items()}, self._psh),
                    "loss_scale": loss_scale}
        self._sync_host_state()
        opt = {"type": type(self.opt_state).__name__}
        for f in dataclasses.fields(self.opt_state):
            v = getattr(self.opt_state, f.name)
            if v is not None:
                opt[f.name] = (host({k: t.detach() for k, t in v.items()},
                                    self._msh)
                               if isinstance(v, dict) else v)
        return {"master": host({k: v.detach() for k, v in
                                self._master().items()}, self._msh),
                "optimizer": opt, "loss_scale": loss_scale}

    def _whole_on_root(self, group, sharded) -> Dict[str, torch.Tensor]:
        """``group``'s leaves whole on the host of rank 0, gathered one at
        a time; empty on the other ranks."""
        out = {}
        for k, t in group.items():
            w = self._whole(k, t, sharded(k))
            if comm.get_rank() == 0:
                out[k] = w.to("cpu", copy=True)
            del w
        return out

    def _host_state_leaves(self):
        """The host optimizer's leaves whole and flat, one at a time, for
        ``host_optimizer.npz``: ``((group, name, part), leaf)`` with
        ``group`` "master" (``part`` None) or "state". Over ranks each
        sharded leaf is all-gathered (every rank iterates: collectives)
        and kept on rank 0's host only (``None`` on the others), so at
        most one whole leaf is live."""
        host = self.host_opt
        root = comm.get_rank() == 0

        def whole(k, flat):
            if not self._dist:
                return flat
            shape = (self.part.shard_shape(k, self._shapes[k])
                     if self._msh(k) else self._shapes[k])
            w = self._whole(k, flat.reshape(shape), self._msh(k))
            return w.to("cpu").reshape(-1) if root else None
        for k in host.keys:
            yield ("master", k, None), whole(k, host.master[k])
        for k in host.keys:
            for p, a in host.moments(k).items():   # read from disk (nvme)
                yield ("state", k, p), whole(k, a)

    def _load_host_state(self, step: int, leaves) -> None:
        """Copy a ``host_optimizer.npz``'s whole flat leaves (``leaves``
        as :meth:`_host_state_leaves` yields them, read one at a time)
        into the host optimizer, each cut to the rank's block before the
        next is read."""
        host = self.host_opt
        want = {("master", k, None) for k in host.keys} | {
            ("state", k, p) for k in host.keys for p in PARTS}
        seen = set()
        for key, leaf in leaves:
            if key not in want:
                raise ValueError(f"host_optimizer.npz holds {key}, which "
                                 "the engine's host optimizer lacks")
            group, k, p = key
            full = torch.as_tensor(leaf).reshape(self._full_shapes[k])
            block = self._block(k, full, self._msh(k)).reshape(-1)
            if group == "master":
                host.master[k].copy_(block)
            else:   # written to its swap file on the nvme tier
                host.set_moment(k, p, block)
            seen.add(key)
            del leaf, full
        if seen != want:
            raise ValueError("host_optimizer.npz lacks "
                             f"{sorted(want - seen, key=str)[:5]}")
        host.adam.step_count = int(step)

    def _copy_into(self, dst: Dict[str, torch.Tensor], src, what: str,
                   sharded=lambda n: False) -> None:
        """Copy a checkpoint's whole leaves into the engine's tensors (the
        rank's blocks where ``sharded``)."""
        if set(dst) != set(src):
            raise ValueError(
                f"checkpoint {what} does not match the engine: missing "
                f"{sorted(set(dst) - set(src))[:5]}, unexpected "
                f"{sorted(set(src) - set(dst))[:5]}")
        for k, t in dst.items():
            full = tuple(self._full_shapes[k]) if k in self._full_shapes \
                else tuple(t.shape)
            if tuple(src[k].shape) != full:
                raise ValueError(f"checkpoint {what} {k!r} has shape "
                                 f"{tuple(src[k].shape)}, the engine "
                                 f"{full}")
            t.detach().copy_(self._block(k, src[k], sharded(k))
                             if k in self._full_shapes else src[k])

    def _load_checkpoint_state(self, state, load_optimizer_states=True):
        """Copy a checkpoint's groups (host tensors, whole leaves) into the
        engine's own tensors (the rank's blocks), then cast the compute
        params from the master by the step's own cast (``_foreach_copy_``),
        so their bits are the saved step's."""
        self._resident()
        with torch.no_grad():
            if self.host_opt is not None:
                if "params" not in state:
                    raise ValueError(
                        "checkpoint holds no 'params' group: it was not "
                        "saved by an engine with offload_optimizer "
                        "implementation='host'")
                self._copy_into(self.params, state["params"], "params",
                                self._psh)
            else:
                if "master" not in state:
                    raise ValueError(
                        "checkpoint holds no 'master' group: it was saved "
                        "by an engine with offload_optimizer "
                        "implementation='host'")
                self._sync_host_state()
                master = self._master()
                self._copy_into(master, state["master"], "master",
                                self._msh)
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
                    self._copy_into(cur, opt[f.name], f"optimizer {f.name}",
                                    self._msh)
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
        if self.host_opt is not None:
            self.host_opt.close()
        if self._param_swapper is not None:
            self._param_swapper.close()
        if self._flight is not None:
            self._flight.close()
            self.watchdog = None
        if self.monitor is not None:
            self.monitor.close()
        if self._telemetry_http is not None:
            self._telemetry_http.close()
            self._telemetry_http = None
        from deepspeed_tpu_torch.telemetry.numerics import \
            unregister_numerics_watch
        unregister_numerics_watch("train", self.numerics)
        if ckpt_err is not None:
            raise ckpt_err


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, loss_fn=None, collate_fn=None,
               device=None, mesh=None, sparse_grad_paths=None):
    """``deepspeed.initialize``: returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``. ``model`` exposes
    ``loss_fn(params, batch, rng)`` (or pass ``loss_fn``);
    ``model_parameters`` is the initial dict of weights, whole, the same
    on every rank; ``config`` a ``DeepSpeedConfig``, a dict or a JSON
    path. With a process group (``init_distributed``) the engine trains
    over its ranks on the mesh of ``config.mesh`` (or ``mesh``).
    ``device`` defaults to ``cuda`` (``cuda:LOCAL_RANK`` over ranks),
    which needs a card. ``sparse_grad_paths`` (or the model's attribute)
    declares the row-sparse leaves of ``sparse_gradients``."""
    cfg = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(
        config if config is not None else (config_params or {}))
    if getattr(model, "num_stages", 1) > 1:
        raise NotImplementedError(not_ported("a pipeline model", "A8"))
    if loss_fn is None:
        if model is None or not hasattr(model, "loss_fn"):
            raise ValueError("provide loss_fn or a model exposing "
                             ".loss_fn(params, batch, rng)")
        loss_fn = model.loss_fn
    if model_parameters is None:
        raise ValueError("model_parameters (the initial weights) are "
                         "required")
    tp_specs = getattr(model, "tp_specs", None)
    tp_fused = getattr(model, "tp_fused", None)
    engine = DeepSpeedEngine(loss_fn, dict(model_parameters), cfg,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             training_data=training_data,
                             collate_fn=collate_fn, device=device,
                             model_handles_param_offload=bool(getattr(
                                 model, "handles_param_offload", False)),
                             mesh=mesh,
                             sparse_grad_paths=(
                                 sparse_grad_paths if sparse_grad_paths
                                 else getattr(model, "sparse_grad_paths",
                                              None)),
                             tp_specs=tp_specs() if callable(tp_specs)
                             else tp_specs,
                             tp_fused=tp_fused() if callable(tp_fused)
                             else tp_fused)
    engine.install_param_fetch(model)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
