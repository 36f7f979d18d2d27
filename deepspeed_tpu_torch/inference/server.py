"""Continuous-batching server over the paged KV cache — in PyTorch.

Counterpart of ``deepspeed_tpu/inference/server.py``
(``ContinuousBatchingServer`` :138): requests arrive asynchronously
(``submit``), the host scheduler admits them into freed slots between
decode steps (``step``), and an EOS'd sequence's blocks return to the pool
at once. Every step runs over all ``num_slots`` resident sequences and the
:class:`~deepspeed_tpu_torch.inference.kv_cache.PagedKVCache`; its
attention runs the hand-written paged kernels (decode, chunked prefill,
verify) and the flash kernel for a monolithic prefill.

The serving core is ported: submit / step / drain; admission through the
block allocator with prefix caching; monolithic and chunked prefill (with
``prefill_chain``); plain decode under the async (lag-N) loop or the
synchronous one; speculation, by prompt lookup or by a draft model
(``draft_engine`` / ``speculation_draft``: the draft keeps a paged pool of
its own over the target's block tables); deadlines, cancel and priority
preemption; int8 pools (``kv_cache_dtype="int8"``) and the host
KV tier (``kv_host_offload``, ``kv_host_blocks``) with its swap-thrash
detector. Every request ends in exactly one finish reason:
``eos`` / ``length``, ``cancelled``, ``deadline`` or ``failed``
(preemption retries exhausted).

Where JAX threads a donated cache, the port writes the pool in place and
edits ``lengths`` and ``block_tables`` with stream-ordered device writes:
host arrays go up through pinned memory without a sync, and nothing on the
decode path reads a device value on the host except the lagged token fetch
(:class:`~deepspeed_tpu_torch.inference.async_loop.TokenFetch`).

Where JAX runs its decode, verify and draft decode steps as jitted programs
(``_decode_jit`` / ``_verify_jit`` / ``_draft_decode_jit``), the port on
CUDA runs each as a CUDA graph (:class:`~deepspeed_tpu_torch.inference.cuda_graph.GraphedStep`),
captured at the step's second call and replayed from then on; greedy
``argmax`` and the lengths advance are inside the graph, as they are inside
JAX's programs. The host arrays of a step go up into the graph's static
input buffers, and the pipelined loop's token feedback is a device-to-device
copy into them. Graphs are on for every CUDA server, as jit is for every
JAX one, and ``enable_cuda_graph`` is accepted with no effect, as it is in
JAX. Prefill and chunked prefill stay eager: their shapes and start vary
per call.

Over several ranks (an engine with ``tp_size > 1``) each rank runs the
same server over its shard: its pools (and the draft's) hold its KV heads,
while the block tables, the allocator and the scheduler are whole on every
rank and make the same decisions, since every rank submits the same
requests and reads the same replicated tokens. Decisions on the clock
(deadlines, a drain timeout) would part the ranks, so over ranks they need
a ``clock`` the caller makes identical on every rank. Under gloo the steps
run eagerly (a graph cannot capture a host collective): ``decode_traces``
reads 0. A seq-sharded engine is refused, with JAX's message.

The observability and control plane is JAX's (JAX :226-370), built in
JAX's order with JAX's rules: request tracing at a ``trace_sample_rate``
above 0; the step profiler and the KV-pool accountant unless
``telemetry.step_profile`` is false; the request ledger and the capacity
model with the profiler and ``telemetry.accounting``; SLO monitoring and
load shedding, fault injection, and — with ``telemetry.enabled`` — burn-rate
alerts, the canary, incident bundles and the HTTP endpoint. The step
profiler's device interval of a step ends where the loop already waits
for its tokens (the async loop's ``InFlightStep`` fetch, or the prefill's
token read): it adds no sync. The compile watch
(``telemetry/compile_watch.py``) counts a graph's capture as its compile
and each new signature of an eager program (prefill per bucket, chunk) as
one. ``close()`` joins the HTTP thread and stops the canary's and the
watchdog's work.

Over several ranks each rank's profiler, ledger and tracer record into
its own registry; the SLO monitor, shedding, alerts, the canary and
incidents decide on the clock, so they need the caller's shared
``clock``, and only rank 0 serves HTTP.

Not in this slice (ROADMAP.md A7b-ii), each raising
``NotImplementedError``: supervised replicas, roles and KV handoff
(``export_prefix`` / ``import_prefix``). Of the
trace counters of ``stats``, ``decode_traces``, ``verify_traces``,
``draft_decode_traces`` and ``retraces`` count the graphs captured on CUDA,
as JAX counts executables; ``prefill_traces``, ``chunk_traces`` and
``draft_prefill_traces`` (eager programs), and all of them on the CPU,
where nothing is captured, report -1, JAX's own value for "unknown".
"""
from __future__ import annotations

import functools
import time
import weakref
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.inference.async_loop import (InFlightStep,
                                                      PublishWorker)
from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
from deepspeed_tpu_torch.inference.engine import (InferenceEngine, _bucket,
                                                  check_draft_compat,
                                                  graphs_capture_mesh)
from deepspeed_tpu_torch.inference.kv_cache import (HostKVTier, PagedKVCache,
                                                    init_paged_cache,
                                                    paged_read_block,
                                                    paged_swap_in)
from deepspeed_tpu_torch.inference.scheduler import Request, Scheduler
from deepspeed_tpu_torch.inference.speculation import (LookupIndex,
                                                       draft_propose,
                                                       greedy_accept_host)
from deepspeed_tpu_torch.model_implementations.transformer import (
    paged_decode_step, paged_prefill, paged_prefill_chunk, paged_verify_step)
from deepspeed_tpu_torch.ops.head_dim import warn_if_padded
from deepspeed_tpu_torch.telemetry import MetricRegistry, get_registry
from deepspeed_tpu_torch.telemetry import events as telemetry_events
from deepspeed_tpu_torch.telemetry.accounting import RequestLedger
from deepspeed_tpu_torch.telemetry.alerts import AlertEngine
from deepspeed_tpu_torch.telemetry.canary import CanaryProber
from deepspeed_tpu_torch.telemetry.capacity import CapacityModel
from deepspeed_tpu_torch.telemetry.capture import ProfilerCapture
from deepspeed_tpu_torch.telemetry.compile_watch import watched
from deepspeed_tpu_torch.telemetry.events import get_event_ring
from deepspeed_tpu_torch.telemetry.exporter import start_http_server
from deepspeed_tpu_torch.telemetry.faultinject import (FaultInjector,
                                                       PrefillFault)
from deepspeed_tpu_torch.telemetry.flight import arm_flight_recorder
from deepspeed_tpu_torch.telemetry.incident import (IncidentRecorder,
                                                    config_fingerprint)
from deepspeed_tpu_torch.telemetry.memory import (KVPoolAccountant,
                                                  get_memory_monitor)
from deepspeed_tpu_torch.telemetry.slo import SLOMonitor
from deepspeed_tpu_torch.telemetry.step_profile import (NULL_STEP_HANDLE,
                                                        StepProfiler)
from deepspeed_tpu_torch.telemetry.tracing import Tracer
from deepspeed_tpu_torch.utils.unported import not_ported

# finish reason -> event-ring kind (every lifecycle finish leaves a
# forensic entry; "eos"/"length" are the quiet normal path)
_LIFECYCLE_EVENTS = {
    "cancelled": telemetry_events.CANCEL,
    "deadline": telemetry_events.DEADLINE_EXPIRED,
    "shed": telemetry_events.SHED,
    "failed": telemetry_events.REQUEST_FAILED,
}


class _RequestTrace:
    """Per-request trace bookkeeping: the open phase spans plus running
    decode counters (annotated onto the decode span at retirement)."""

    __slots__ = ("trace", "queue", "prefill", "decode", "steps", "tokens")

    def __init__(self, trace):
        self.trace = trace
        self.queue = None
        self.prefill = None
        self.decode = None
        self.steps = 0
        self.tokens = 0


def submit_rejection(prompt, max_new_tokens: int, floor: int,
                     deadline_s) -> Optional[tuple]:
    """``(reason, message)`` when these submit() arguments can never be
    served, else None."""
    if not prompt:
        return "empty_prompt", "empty prompt"
    if max_new_tokens < floor:
        return "budget_floor", (
            f"max_new_tokens={max_new_tokens} is below the "
            f"schedulable floor {floor} (min_out_tokens)")
    if deadline_s is not None and deadline_s <= 0:
        return "bad_deadline", (
            f"deadline_s must be > 0 seconds (or None for no "
            f"deadline), got {deadline_s}")
    return None


def check_drain_timeout(timeout_s) -> None:
    """Shared ``drain(timeout_s=...)`` validation."""
    if timeout_s is not None and timeout_s < 0:
        raise ValueError(
            f"drain timeout_s must be >= 0 (or None for unbounded), "
            f"got {timeout_s}")


def _weak(method):
    """``method`` without a strong reference to its object: the server
    hands its snapshot and callback methods to objects it owns (the
    capacity model, alerts, the canary, incidents, the watchdog, the HTTP
    endpoint), and a strong one would make a reference cycle that keeps
    the server's pool on the device until the cycle collector runs."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)
    return call


def _upload(arr: np.ndarray, device: torch.device,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A host array on ``device`` (or written into the device tensor
    ``out``) without a host sync: a plain ``torch.as_tensor(...,
    device="cuda")`` waits for the stream to drain, so the array is staged
    in pinned memory and copied asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.clone() if out is None else out.copy_(t)
    t = t.pin_memory()
    return (t.to(device, non_blocking=True) if out is None
            else out.copy_(t, non_blocking=True))


def _stage(x, out: torch.Tensor) -> None:
    """A step input into its graph's static buffer ``out``: a host array
    (of ``out``'s dtype) through :func:`_upload`, a device tensor by a
    device-to-device copy."""
    if isinstance(x, np.ndarray):
        _upload(x, out.device, out)
    else:
        out.copy_(x)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, -1).to(torch.int32)


def _step_programs(params, cfg, cache: PagedKVCache):
    """The decode and verify steps over ``cache``, each returning its
    greedy tokens: the functions the server runs eagerly or captures. They
    close over the pool, not the server, so a graph that holds them keeps
    no server alive."""
    def decode(tokens, active):
        return _greedy(paged_decode_step(params, cfg, tokens, cache,
                                         active)[0])

    def verify(tokens):
        return _greedy(paged_verify_step(params, cfg, tokens, cache)[0])

    return decode, verify


def _pool_tensors(cache: PagedKVCache):
    """What a captured step reads and writes besides its inputs."""
    return (cache.k, cache.v, cache.block_tables, cache.lengths,
            cache.k_scale, cache.v_scale)


def _check_slice(supervised, role, handoff_import) -> None:
    """Raise on every option this slice does not port (ROADMAP.md
    A7b-ii)."""
    later = {
        "supervised replicas (ServingFrontend)": supervised,
        f"serving role {role!r} (disaggregated prefill/decode)":
            role != "mixed",
        "handoff_import (KV handoff)": handoff_import,
    }
    for what, armed in later.items():
        if armed:
            raise NotImplementedError(not_ported(what, "A7b-ii"))


class ContinuousBatchingServer:
    """``submit() / step() / drain()`` serving loop over an
    :class:`InferenceEngine`'s weights, greedy decoding only (output is
    token-for-token the one-shot ``generate``'s).

    ``clock`` (injectable, default ``time.perf_counter``) is the basis for
    every latency observation, deadline, SLO window, alert, canary probe
    and the ``drain`` timeout. ``fault_injector`` arms the chaos hooks
    (``telemetry/faultinject.py``); None (the default, and the default
    config) costs one ``None`` check a site."""

    def __init__(self, engine: InferenceEngine,
                 registry: Optional[MetricRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 supervised: bool = False, role: str = "mixed",
                 handoff_import: bool = False,
                 draft_engine: Optional[InferenceEngine] = None):
        if engine.model_config.head == "none":
            raise ValueError("continuous batching needs an LM head — "
                             "encoder models have nothing to decode")
        if engine.model_config.seq_shard_kv:
            raise NotImplementedError(
                "continuous batching with a seq-sharded KV cache is "
                "unsupported — the paged pool is already the "
                "long-context memory lever")
        cfg = engine.config
        _check_slice(supervised, role, handoff_import)
        self.engine = engine
        self._supervised = supervised
        self.role = role
        self._closed = False
        self.device = engine.device
        self.block_size = cfg.block_size
        self.num_slots = cfg.num_slots
        self._clock = clock if clock is not None else time.perf_counter
        # over ranks the clock must be the caller's, the same on each
        self._clock_shared = clock is not None or engine.tp == 1
        # per-slot token budget reuses the engine's memory accounting
        # (explicit max_out_tokens, or 'auto' free-memory sizing)
        per_slot = engine._max_out_budget(self.num_slots)
        if per_slot < self.block_size:
            raise ValueError(
                f"per-slot KV budget {per_slot} tokens is below one "
                f"block ({self.block_size}) — raise max_out_tokens or "
                "shrink block_size")
        self.max_blocks_per_slot = per_slot // self.block_size
        # prefix caching implies chunked prefill (one-block chunks when the
        # chunk knob is unset): a cache-hit admission prefills only the tail
        self.prefix_caching = cfg.enable_prefix_caching
        self.chunk_tokens = cfg.prefill_chunk_tokens or (
            self.block_size if cfg.enable_prefix_caching else 0)
        # per-slot speculative decoding: K = chunk width of the batched
        # verify forward (pending token + K-1 proposals per active slot,
        # by prompt lookup or, with a draft engine, by K chained draft
        # decode steps); 0 = off
        self.spec_tokens = cfg.speculation_tokens
        self.draft = draft_engine if draft_engine is not None \
            else cfg.speculation_draft
        if self.draft is not None:
            if self.spec_tokens < 2:
                raise ValueError(
                    "draft_engine proposes speculation_tokens-1 "
                    "candidates per slot — it requires "
                    "speculation_tokens >= 2")
            check_draft_compat(engine, self.draft)
            if self.draft.model_config.seq_shard_kv:
                raise NotImplementedError(not_ported(
                    "a draft engine with a sequence-sharded KV cache "
                    "(seq_shard_kv)"))
            if self.draft.device != self.device:
                raise ValueError(
                    f"the draft engine is on {self.draft.device}, the "
                    f"target on {self.device}")
        # telemetry: registry recording is always on; telemetry.enabled=
        # False swaps in a private registry, so nothing reaches the process
        # scrape surface
        tcfg = cfg.telemetry
        enabled = tcfg.enabled
        self.telemetry = registry or (get_registry() if enabled
                                      else MetricRegistry())
        # request-scoped tracing: armed only at a nonzero sample rate —
        # tracing off allocates NOTHING per request
        self.tracer = None
        self._rt: Dict[int, _RequestTrace] = {}
        if enabled and tcfg.trace_sample_rate > 0:
            self.tracer = Tracer(
                sample_rate=tcfg.trace_sample_rate,
                ring_capacity=tcfg.trace_ring_capacity,
                seed=tcfg.trace_seed,
                slow_threshold_s=tcfg.trace_slow_threshold_s,
                registry=self.telemetry)
        # SLO gates: windowed objectives over the serving histograms,
        # re-evaluated at step cadence on the server clock
        self.slo = None
        if enabled and tcfg.slo.enabled:
            self._check_shared_clock("telemetry.slo")
            self.slo = SLOMonitor(tcfg.slo, registry=self.telemetry,
                                  clock=self._clock)
        # chaos hooks: an explicit injector beats config; both default to
        # None = one None check a site
        self._fi = fault_injector
        if self._fi is None and enabled:
            self._fi = FaultInjector.from_config(
                tcfg.fault_injection, registry=self.telemetry)
        # SLO-driven load shedding: a config error if armed without the
        # objective it consults
        self._shedding = cfg.enable_load_shedding
        if self._shedding and (self.slo is None
                               or "queue_wait_p90" not in self.slo.targets):
            raise ValueError(
                "enable_load_shedding consults the telemetry.slo "
                "queue_wait_p90_s objective — enable telemetry.slo and "
                "set queue_wait_p90_s (docs/serving.md 'Request "
                "lifecycle & overload behavior')")
        self.max_preemptions = cfg.max_preemptions
        self._backoff_steps = cfg.preemption_backoff_steps
        # serving step observatory + KV-pool accounting: ON by default —
        # clock reads and histogram observes, NO device syncs. OFF builds
        # neither object and registers none of their families
        self._profiler = None
        self._pool_acct = None
        if tcfg.step_profile:
            self._profiler = StepProfiler(
                registry=self.telemetry, clock=self._clock,
                events_every=tcfg.step_profile_events_every,
                source="serve")
            self._pool_acct = KVPoolAccountant(
                registry=self.telemetry, clock=self._clock)
        # request-level cost accounting + capacity model: the ledger
        # splits each worked step's device-attributed wall across the
        # resident slots, so it arms only with the step profiler
        self._ledger = None
        self._capacity = None
        if self._profiler is not None and tcfg.accounting.enabled:
            self._ledger = RequestLedger(
                registry=self.telemetry, clock=self._clock,
                max_tenants=tcfg.accounting.max_tenants,
                source="serve")
            self._profiler.on_step_device = self._ledger.settle_step
            self._capacity = CapacityModel(
                registry=self.telemetry, clock=self._clock,
                window_s=tcfg.accounting.window_s,
                eval_interval_s=tcfg.accounting.eval_interval_s,
                levels=_weak(self._capacity_levels),
                goodput=_weak(self._capacity_goodput))
        # SLO burn-rate alerting + canary probes + incident bundles: all
        # default OFF; a supervised replica builds none of them
        self.alerts = None
        self.canary = None
        self.incidents = None
        if enabled and not supervised:
            if tcfg.incident.enabled:
                self._check_shared_clock("telemetry.incident")
                self.incidents = IncidentRecorder(
                    tcfg.incident, collect=_weak(self._incident_collect),
                    registry=self.telemetry, clock=self._clock,
                    fingerprint=config_fingerprint(cfg),
                    name="serve_incidents")
            if tcfg.slo.enabled and tcfg.slo.objectives:
                self.alerts = AlertEngine(
                    tcfg.slo, registry=self.telemetry,
                    clock=self._clock,
                    sources={"goodput": _weak(self._capacity_goodput)},
                    on_fire=_weak(self._on_alert_fire),
                    on_resolve=_weak(self._on_alert_resolve))
            if tcfg.canary.enabled:
                self._check_shared_clock("telemetry.canary")
                self.canary = CanaryProber(
                    tcfg.canary, submit=_weak(self.submit),
                    result=_weak(self.result),
                    finish_reason=_weak(self.finish_reason),
                    cancel=_weak(self.cancel),
                    registry=self.telemetry, clock=self._clock,
                    vocab_size=getattr(engine.model_config,
                                       "vocab_size", None))
        # the scrape endpoint: rank 0 only over ranks. Its snapshot
        # callables read host state only (never a CUDA tensor)
        self.http_server = None
        if (enabled and tcfg.http_port is not None and not supervised
                and comm.get_rank() == 0):
            self.http_server = start_http_server(
                tcfg.http_port, host=tcfg.http_host,
                registry=self.telemetry, tracer=self.tracer,
                goodput=_weak(self._goodput_snapshot),
                capacity=_weak(self.capacity_snapshot),
                incidents=_weak(self.incidents_snapshot))
        self.profiler_capture = ProfilerCapture()
        reg = self.telemetry
        self._h_queue_wait = reg.histogram(
            "serve_queue_wait_seconds", help="submit() to slot admission")
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", help="submit() to first token committed")
        self._h_request = reg.histogram(
            "serve_request_seconds", help="submit() to finished, end to end")
        self._h_decode_step = reg.histogram(
            "serve_decode_step_seconds",
            help="one decode step over all num_slots rows")
        self._h_token = reg.histogram(
            "serve_token_seconds",
            help="per-token decode latency (one committed token per live "
                 "slot per step)")
        self._c_submitted = reg.counter("serve_requests_submitted_total",
                                        help="accepted submit() calls")
        self._c_finished = reg.counter("serve_requests_finished_total",
                                       help="requests retired")
        self._c_prefills = reg.counter("serve_prefills_total",
                                       help="prefill programs executed")
        self._c_decode_steps = reg.counter("serve_decode_steps_total",
                                           help="decode steps executed")
        self._c_tokens = reg.counter("serve_tokens_total",
                                     help="generated tokens committed")
        self._g_occupancy = reg.gauge(
            "serve_slot_occupancy",
            help="live/num_slots at the last decode step")
        self._h_prefill_chunk = reg.histogram(
            "serve_prefill_chunk_seconds",
            help="one chunked-prefill chunk (non-final chunks observe the "
                 "dispatch interval)")
        self._c_tail_reclaimed = reg.counter(
            "serve_tail_blocks_reclaimed_total",
            help="reserved-but-never-written tail blocks returned to the "
                 "free list at retirement")
        self._c_finish = {
            "cancelled": reg.counter(
                "serve_cancelled_total",
                help="requests finished by cancel() or a bounded drain"),
            "deadline": reg.counter(
                "serve_deadline_expired_total",
                help="requests reaped past their deadline_s (finish "
                     "reason 'deadline'; queued expiries are never "
                     "admitted)"),
            "shed": reg.counter(
                "serve_shed_total",
                help="queued requests fast-failed by SLO-driven load "
                     "shedding (finish reason 'shed')"),
            "failed": reg.counter(
                "serve_requests_failed_total",
                help="requests failed by the server (preemption retries "
                     "exhausted)"),
        }
        self._c_preempted = reg.counter(
            "serve_preempted_total",
            help="slot preemptions (recompute-requeue)")
        self._c_spec_proposed = reg.counter(
            "serve_spec_proposed_total",
            help="prompt-lookup draft tokens submitted to the batched "
                 "verify forward")
        self._c_spec_accepted = reg.counter(
            "serve_spec_accepted_total",
            help="proposed draft tokens the target's argmax accepted")
        self._h_spec_commit = reg.histogram(
            "serve_spec_committed_per_forward",
            help="tokens committed per active slot per verify forward")
        # KV tiering: int8 pool storage and/or a host tier for demoted
        # prefix blocks (both change what a pool block holds and where it
        # lives, not the programs that run)
        self.kv_dtype = cfg.kv_cache_dtype
        self.host_tier = (HostKVTier(cfg.kv_host_blocks)
                          if cfg.kv_host_offload else None)
        # swap-thrash detector: rolling window of per-step swap-in counts
        self._swap_window: Deque[int] = deque(maxlen=self._SWAP_WINDOW_STEPS)
        self._swap_seen = 0
        self._swap_alarm = False
        self._submit_ts: Dict[int, float] = {}
        # when the request last ENTERED the queue (submit or preemption
        # requeue); _submit_ts stays the birth time for TTFT/latency
        self._queued_ts: Dict[int, float] = {}
        # only requests WITH a deadline live here
        self._deadlines: Dict[int, float] = {}
        self.finish_reasons: Dict[int, str] = {}
        # +1: block 0 is the reserved null block idle slots write into
        num_blocks = 1 + self.num_slots * self.max_blocks_per_slot
        self.scheduler = Scheduler(
            num_slots=self.num_slots, num_blocks=num_blocks,
            block_size=self.block_size,
            max_blocks_per_slot=self.max_blocks_per_slot,
            max_queued_requests=cfg.max_queued_requests,
            registry=self.telemetry,
            enable_prefix_caching=self.prefix_caching,
            tracer=self.tracer,
            spec_margin=max(self.spec_tokens - 1, 0),
            pool_accountant=self._pool_acct,
            host_tier=self.host_tier)
        self._cache = self._make_pool(num_blocks)
        # the pool object and its tensors stay the same for the server's
        # life: the step graphs are captured over them
        self._decode_fn, self._verify_fn = _step_programs(
            engine.params, engine.model_config, self._cache)
        # draft-model speculation: the draft's own fp pool with the
        # target's geometry, over the target's block tables (one tensor,
        # written in place), so draft k/v land block for block beside the
        # target k/v they shadow and every allocator decision covers both
        self._draft_cache = None
        self._draft_decode_fn = None
        if self.draft is not None:
            self._draft_cache = self._make_draft_pool(num_blocks)
            self._draft_decode_fn = _step_programs(
                self.draft.params, self.draft.model_config,
                self._draft_cache)[0]
        # decode / verify step graphs, made at first use; False runs the
        # steps eagerly on CUDA too (the control a check compares with)
        # over gloo ranks nothing is captured: the trace counters read 0
        self._host_collectives = self.device.type == "cuda" and \
            not graphs_capture_mesh(engine.mesh, "ContinuousBatchingServer")
        self._cuda_graphs = self.device.type == "cuda" and \
            not self._host_collectives
        self._graphs: Dict[str, GraphedStep] = {}
        self._host_mem_getter = None
        if self.host_tier is not None:
            # the allocator decides WHEN to tier; the server owns the pool,
            # so the copies are its callbacks. Both run only inside
            # admission-time allocation, which step() reaches only after
            # flushing every step in flight: the pool is written in place,
            # and a copy under a running step would corrupt it
            alloc = self.scheduler.allocator
            alloc.on_demote = self._demote_block
            alloc.on_swap_in = self._swap_in_block
            # /debug/memory accounts the tier's host bytes (weakref: a
            # dropped server must not pin its payloads)
            tier_ref = weakref.ref(self.host_tier)

            def _host_bytes():
                tier = tier_ref()
                return 0 if tier is None else tier.host_bytes

            self._host_mem_getter = _host_bytes
            get_memory_monitor().register_host_component(
                "kv_host_tier", _host_bytes)
        # the compile watch over the step programs, with JAX's names: a
        # graph's capture is its compile (GraphedStep records it), an eager
        # program's new signature is one. Python ints (length, start,
        # slot) are keyed by type, as JAX traces them
        programs = {"prefill": (self._prefill_program, "serve_prefill"),
                    "chunk": (self._chunk_program, "serve_prefill_chunk"),
                    "decode": (self._decode_fn, "serve_decode"),
                    "verify": (self._verify_fn, "serve_spec_verify")}
        if self._draft_decode_fn is not None:
            programs["draft_decode"] = (self._draft_decode_fn,
                                        "serve_draft_decode")
        self._watch = {kind: watched(fn, name, registry=self.telemetry)
                       for kind, (fn, name) in programs.items()}
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        self._step_clock = 0           # decode steps executed
        # scheduler tick: advances on EVERY step() call — requeue backoff
        # counts against it, so a backing-off queue head on an idle server
        # still becomes eligible
        self._tick = 0
        self._active_slot_steps = 0    # sum of live slots per decode step
        self._prefills = 0
        self._prefill_chunks = 0       # chunk programs executed
        self._prefill_token_units = 0  # tokens run through prefill compute
        self._prefix_tokens_skipped = 0   # prompt tokens served from cache
        self._tail_reclaimed = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_committed = 0       # tokens committed by verify steps
        self._spec_steps = 0           # verify forwards executed
        self._spec_slot_steps = 0      # sum of active slots per verify
        # acceptance-collapse detector: rolling (proposed, accepted) window
        self._spec_window: Deque[tuple] = deque(
            maxlen=self._SPEC_WINDOW_STEPS)
        self._spec_alarm = False
        # per-slot incremental lookup state, identity-checked against the
        # resident SlotState so a recycled slot always rebuilds
        self._spec_hist: Dict[int, tuple] = {}
        self._lifecycle_counts = dict.fromkeys(
            ("cancelled", "deadline", "preempted", "shed", "failed"), 0)
        # chunked prefills in flight, FIFO; at most ONE chunk (or one
        # chain of non-final chunks) runs per step()
        self._prefilling: Deque[dict] = deque()
        self._mid_prefill: set = set()
        # async dispatch loop: up to max_commit_lag decode steps chain on
        # the device across step() calls, committed FIFO; every host-driven
        # state change flushes the chain first
        self._async = cfg.async_loop
        self._max_lag = max(int(cfg.max_commit_lag), 1)
        self._inflight: Deque[InFlightStep] = deque()
        self._prefill_chain = cfg.prefill_chain and bool(self.chunk_tokens)
        self._worker = PublishWorker()
        # finishes discovered by an out-of-step flush (cancel/drain between
        # steps): returned by the NEXT step() call
        self._deferred_finished: List[int] = []
        # per-step publish records, shipped to the worker in batches
        self._pub_buf: List[tuple] = []
        self._async_stats = {
            "pipeline_starts": 0,
            "pipelined_steps": 0,
            "flushes": {},
            "flush_depths": {},
            "discarded_tokens": 0,
            "garbage_steps": 0,
        }
        # dispatch time of non-final chunks whose device span closes at
        # the next real fetch (one pending chain at a time)
        self._chunk_pending_t0: Optional[float] = None
        self._init_flight_recorder(tcfg)

    # decode-step ring events are sampled (every Nth step + the first)
    _EVENT_EVERY = 64

    # acceptance-collapse detector thresholds (see _maybe_spec_collapse)
    _SPEC_WINDOW_STEPS = 64
    _SPEC_MIN_PROPOSED = 64
    _SPEC_COLLAPSE_RATE = 0.05
    _SPEC_RECOVER_RATE = 0.10

    # swap-thrash detector (host tiering): over the last _SWAP_WINDOW_STEPS
    # steps, a mean swap-in rate above _KV_THRASH_SWAPS_PER_STEP fires one
    # kv_swap_thrash ring event; the alarm re-arms at or below
    # _KV_THRASH_RECOVER
    _SWAP_WINDOW_STEPS = 32
    _KV_THRASH_SWAPS_PER_STEP = 0.5
    _KV_THRASH_RECOVER = 0.125

    # ------------------------------------------------------------ setup

    def _check_shared_clock(self, what: str) -> None:
        if not self._clock_shared:
            raise ValueError(
                f"{what} over tp_size={self.engine.tp} ranks: each rank "
                "would decide on its own clock and the ranks would part; "
                "pass the server a clock that is the same on every rank")

    def _init_flight_recorder(self, tcfg) -> None:
        """Arm the config-gated flight-recorder surfaces (event ring size,
        fault dump, stall watchdog, memory components). Weak self-
        references: a dropped server never pins its pool."""
        ref = weakref.ref(self)

        def _pool():
            srv = ref()
            if srv is None:
                return None
            c = srv._cache
            return ((c.k, c.v) if c.k_scale is None
                    else (c.k, c.v, c.k_scale, c.v_scale))

        def _params():
            srv = ref()
            return None if srv is None else srv.engine.params

        self._flight = arm_flight_recorder(
            tcfg, self.telemetry, "serve_watchdog",
            [("kv_block_pool", _pool), ("params", _params)])
        self.watchdog = self._flight.watchdog
        if self.watchdog is not None and self.incidents is not None:
            # a watchdog dump is a forensic trigger like an alert firing
            self.watchdog.set_on_dump(_weak(self._on_watchdog_dump))

    # ------------------------------------------ observability snapshots
    # These run on the scrape thread: they read host-side telemetry
    # structures only, never a device tensor or live allocator state.

    def _goodput_snapshot(self) -> dict:
        """``GET /debug/goodput``: the step observatory's phase totals
        beside the KV-pool accounting and the async loop's flushes."""
        astats = getattr(self, "_async_stats", None)
        return {
            "step_profile": (self._profiler.snapshot()
                             if self._profiler is not None
                             else {"enabled": False}),
            "kv_pool": (self._pool_acct.snapshot()
                        if self._pool_acct is not None
                        else {"enabled": False}),
            "async_loop": ({
                "max_commit_lag": self._max_lag,
                "flushes": dict(astats["flushes"]),
                "flush_depths": {
                    reason: {str(d): n
                             for d, n in sorted(depths.items())}
                    for reason, depths in sorted(
                        astats["flush_depths"].items())},
            } if astats is not None else {"enabled": False}),
        }

    def _capacity_levels(self):
        """CapacityModel ``levels``: ``(active_slots, num_slots,
        free_blocks, usable_blocks)``."""
        sched = getattr(self, "scheduler", None)
        if sched is None:
            return (0, self.num_slots, 0, 0)
        alloc = sched.allocator
        return (sched.active_slots, self.num_slots,
                alloc.free_blocks, alloc.usable_blocks)

    def _capacity_goodput(self) -> Optional[float]:
        """CapacityModel ``goodput``: the step observatory's lifetime
        device/wall fraction (None before any step)."""
        p = self._profiler
        if p is None:
            return None
        return p.snapshot().get("goodput_fraction")

    def capacity_snapshot(self) -> dict:
        """``GET /debug/capacity`` (and ``stats["capacity"]``): the live
        capacity model's latest row. Report-only."""
        if self._capacity is None:
            return {"enabled": False,
                    "hint": "accounting disabled "
                            "(telemetry.accounting.enabled / "
                            "telemetry.step_profile)"}
        return self._capacity.snapshot()

    def _on_alert_fire(self, rule: str, info: dict) -> None:
        """AlertEngine ``on_fire``: a rule entering firing captures an
        incident (one bundle an episode)."""
        if self.incidents is not None:
            self.incidents.capture("alert", rule=rule, info=info)

    def _on_alert_resolve(self, rule: str, info: dict) -> None:
        """AlertEngine ``on_resolve``: closes the open episode once every
        joined rule resolved."""
        if self.incidents is not None:
            self.incidents.resolve(rule, info=info)

    def _on_watchdog_dump(self, dump: dict) -> None:
        """Watchdog ``on_dump``: the stall coordinates into an incident."""
        if self.incidents is not None:
            self.incidents.capture(
                "watchdog",
                info={"watchdog": dump.get("watchdog"),
                      "idle_seconds": dump.get("idle_seconds")})

    def _incident_collect(self) -> dict:
        """The incident bundle's body: telemetry structures only (the
        watchdog trigger runs on its checker thread)."""
        return {
            "observability": self.observability_state(),
            "events": get_event_ring().snapshot(),
            "capacity": self.capacity_snapshot(),
            "alerts": (self.alerts.snapshot()
                       if self.alerts is not None else None),
            "canary": (self.canary.snapshot()
                       if self.canary is not None else None),
        }

    def incidents_snapshot(self) -> dict:
        """``GET /debug/incidents`` (and ``stats["incidents"]``): the live
        alert/canary state beside the retained bundles."""
        if (self.incidents is None and self.alerts is None
                and self.canary is None):
            return {"enabled": False,
                    "hint": "no slo.objectives / canary / incident "
                            "knobs armed (docs/observability.md "
                            "'SLOs, alerting & incidents')"}
        return {
            "enabled": True,
            "alerts": (self.alerts.snapshot()
                       if self.alerts is not None else None),
            "canary": (self.canary.snapshot()
                       if self.canary is not None else None),
            "incidents": (self.incidents.snapshot()
                          if self.incidents is not None else None),
        }

    def dump_incident(self, path: str) -> dict:
        """On-demand forensic bundle to ``path`` (never rate-limited);
        needs ``telemetry.incident``."""
        if self.incidents is None:
            raise RuntimeError(
                "incident capture is off — set telemetry.incident."
                "enabled (docs/observability.md 'SLOs, alerting & "
                "incidents')")
        return self.incidents.dump(path)

    def request_cost(self, request_id: int) -> Optional[dict]:
        """The closed cost record of a finished request (device-seconds,
        KV block-seconds, queue wait, swap bytes, speculation counts,
        token totals); None when accounting is off or the id is unknown
        or still running. Non-destructive."""
        if self._ledger is None:
            return None
        return self._ledger.cost(request_id)

    def pop_request_cost(self, request_id: int) -> Optional[dict]:
        """Harvest-and-drop a finished request's cost record."""
        if self._ledger is None:
            return None
        return self._ledger.pop_cost(request_id)

    def abandon_cost(self, request_id: int) -> Optional[dict]:
        """Force-close and harvest the cost record of a request this
        server will never finish."""
        if self._ledger is None:
            return None
        self._ledger.abandon(request_id)
        return self._ledger.pop_cost(request_id)

    def observability_state(self) -> dict:
        """One server's observability export: the registry's mergeable
        state, kept traces as dicts, and the goodput / dispatch-gap
        view. JSON round-trippable and scrape-thread-safe."""
        prof = (self._profiler.snapshot() if self._profiler is not None
                else {"enabled": False})
        return {
            "role": self.role,
            "metrics": self.telemetry.export_state(),
            "traces": ([t.to_dict() for t in self.tracer.traces()]
                       if self.tracer is not None else []),
            "tracing": self.tracer is not None,
            "goodput_fraction": prof.get("goodput_fraction"),
            "recent_gap_s": (self._profiler.recent_gap_s()
                             if self._profiler is not None else None),
        }

    def _pool_snapshot(self) -> dict:
        """Fresh pool-accounting view for :attr:`stats` (owner thread):
        recomputes the rate-limited fragmentation exactly."""
        self._pool_acct.update_fragmentation(
            self.scheduler.allocator.free_ids)
        return self._pool_acct.snapshot()

    def _make_draft_pool(self, num_blocks: int) -> PagedKVCache:
        """The draft model's pool: the target pool's slots, blocks and
        block size with the draft's layers and head dims, full precision
        whatever the target's (JAX ``_make_draft_pool`` :1035). Its block
        tables are the target's tensor."""
        dcfg = self.draft.model_config
        warn_if_padded("draft paged KV pool", dcfg.head_dim,
                       self.draft._act_dtype.itemsize, self.device)
        pool = init_paged_cache(
            dcfg.n_layer, self.num_slots, num_blocks, self.block_size,
            self.max_blocks_per_slot, self.draft.kv_heads_local,
            dcfg.head_dim,
            dtype=self.draft._act_dtype, quantized=False, device=self.device)
        pool.block_tables = self._cache.block_tables
        return pool

    def _make_pool(self, num_blocks: int) -> PagedKVCache:
        mcfg = self.engine.model_config
        quantized = self.kv_dtype == "int8"
        warn_if_padded("paged KV pool", mcfg.head_dim,
                       1 if quantized else self.engine._act_dtype.itemsize,
                       self.device)
        return init_paged_cache(
            mcfg.n_layer, self.num_slots, num_blocks, self.block_size,
            self.max_blocks_per_slot, self.engine.kv_heads_local,
            mcfg.head_dim,
            dtype=self.engine._act_dtype, quantized=quantized,
            device=self.device)

    # -------------------------------------------------- host-tier copies

    def _demote_block(self, block: int, h: bytes) -> None:
        """Allocator demotion callback: one parked block's payload
        device→host (complete on return) into the tier under its hash;
        the copy's wall is ``serve_kv_swap_seconds``."""
        t0 = self._clock()
        self.host_tier.put(h, paged_read_block(self._cache, block))
        if self._pool_acct is not None:
            self._pool_acct.observe_swap("out", self._clock() - t0,
                                         len(self.host_tier))

    def _swap_in_block(self, block: int, payload: dict) -> None:
        """Allocator swap-in callback: the (already tier-popped) payload
        back into a freshly allocated block, stream-ordered ahead of the
        step that next reads it; the host wall of its dispatch is
        ``serve_kv_swap_seconds``, as JAX's."""
        t0 = self._clock()
        paged_swap_in(self._cache, block, payload)
        if self._pool_acct is not None:
            self._pool_acct.observe_swap("in", self._clock() - t0,
                                         len(self.host_tier))

    def _check_swap_thrash(self) -> None:
        """Ring-event a swap-in storm ONCE per episode: a sustained swap-in
        rate over the rolling window means blocks cycle device↔host faster
        than they serve (the device pool is undersized for the live working
        set). Re-arms after the rate recovers."""
        if self.host_tier is None:
            return
        swaps = self.scheduler.allocator.swap_ins
        self._swap_window.append(swaps - self._swap_seen)
        self._swap_seen = swaps
        if len(self._swap_window) < self._SWAP_WINDOW_STEPS:
            return
        rate = sum(self._swap_window) / len(self._swap_window)
        if not self._swap_alarm and rate > self._KV_THRASH_SWAPS_PER_STEP:
            self._swap_alarm = True
            get_event_ring().record(
                telemetry_events.KV_SWAP_THRASH,
                swap_ins_per_step=round(rate, 4),
                window_steps=len(self._swap_window),
                host_blocks=len(self.host_tier),
                free_blocks=self.scheduler.allocator.free_blocks)
        elif self._swap_alarm and rate <= self._KV_THRASH_RECOVER:
            self._swap_alarm = False

    # the four device programs: each returns its greedy tokens as an int32
    # device tensor and writes the pool in place. Decode and verify run as
    # CUDA graphs on CUDA (_graph); prefill and chunks run eagerly

    @torch.no_grad()
    def _prefill_program(self, ids: torch.Tensor, length: int, slot: int):
        logits, _ = paged_prefill(
            self.engine.params, self.engine.model_config, ids, length,
            self._cache, slot)
        return _greedy(logits)

    @torch.no_grad()
    def _chunk_program(self, ids: torch.Tensor, start: int, length: int,
                       slot: int):
        logits, _ = paged_prefill_chunk(
            self.engine.params, self.engine.model_config, ids, start,
            length, self._cache, slot)
        return _greedy(logits)

    def _prefill(self, ids: np.ndarray, length: int, slot: int):
        return self._watch["prefill"](
            _upload(ids.astype(np.int64), self.device), length, slot)

    def _chunk(self, ids: np.ndarray, start: int, length: int, slot: int):
        return self._watch["chunk"](
            _upload(ids.astype(np.int64), self.device), start, length, slot)

    def _graph(self, kind: str) -> Optional[GraphedStep]:
        """The graph of the ``decode``, ``verify`` or ``draft_decode`` step,
        made at its first use, over static inputs of the step's fixed
        shapes (tokens ``[S]`` and ``active [S]``, or tokens ``[S, K]``);
        None where the steps run eagerly."""
        if not self._cuda_graphs:
            return None
        g = self._graphs.get(kind)
        if g is None:
            S, dev = self.num_slots, self.device
            pool = self._draft_cache if kind == "draft_decode" \
                else self._cache
            if kind == "verify":
                fn, inputs = self._verify_fn, (torch.zeros(
                    (S, self.spec_tokens), dtype=torch.long, device=dev),)
            else:
                fn = self._decode_fn if kind == "decode" \
                    else self._draft_decode_fn
                inputs = (torch.zeros(S, dtype=torch.long, device=dev),
                          torch.zeros(S, dtype=torch.bool, device=dev))
            g = self._graphs[kind] = GraphedStep(
                f"serve_{kind}", fn, inputs,
                functools.partial(_pool_tensors, pool),
                watch=self._watch[kind])
        return g

    @torch.no_grad()
    def _decode(self, tokens, active, kind: str = "decode"):
        """One decode step over all slots of the target (``kind``
        ``"decode"``) or of the draft (``"draft_decode"``). ``tokens``: the
        slots' pending tokens, an int64 host array, or the previous step's
        device tokens (the pipelined feedback, a draft's chain);
        ``active``: a host or device bool array."""
        g = self._graph(kind)
        if g is None:
            if isinstance(tokens, np.ndarray):
                tokens = _upload(tokens, self.device)
            if isinstance(active, np.ndarray):
                active = _upload(active, self.device)
            return self._watch[kind](tokens.long(), active)
        _stage(tokens, g.inputs[0])
        _stage(active, g.inputs[1])
        return g()

    @torch.no_grad()
    def _verify(self, tokens):
        """``tokens [S, K]``: an int host array, or the device tokens a
        draft proposal round built."""
        if isinstance(tokens, np.ndarray):
            tokens = tokens.astype(np.int64)
        g = self._graph("verify")
        if g is None:
            if isinstance(tokens, np.ndarray):
                tokens = _upload(tokens, self.device)
            return self._watch["verify"](tokens.long())
        _stage(tokens, g.inputs[0])
        return g()

    @torch.no_grad()
    def _draft_prefill_slot(self, slot: int, state) -> None:
        """Admit one slot's FULL scheduled prompt into the draft pool (JAX
        ``_draft_prefill_slot`` :1933), right after the target's prefill
        completes. The draft always prefills from position 0, even under
        prefix caching or chunked prefill: shared prefix blocks are
        rewritten with the same content, and a preemption's re-admission
        rebuilds the whole draft state the reset scrubbed."""
        if self.draft is None:
            return
        sched_prompt = state.request.sched_prompt
        plen = len(sched_prompt)
        T = min(max(_bucket(plen), self.block_size),
                self.max_blocks_per_slot * self.block_size)
        ids = np.zeros((1, T), np.int64)
        ids[0, :plen] = sched_prompt
        paged_prefill(self.draft.params, self.draft.model_config,
                      _upload(ids, self.device), plen, self._draft_cache,
                      slot)

    def _draft_propose(self, states: Dict[int, object]):
        """One draft proposal round for the given slots (JAX
        ``_draft_propose`` :1959): K chained draft decode steps over all
        slots, on the device. Returns ``(verify tokens [S, K], props [S,
        K-1])``, both device tensors."""
        S = self.num_slots
        pend = np.zeros((S,), np.int64)
        active = np.zeros((S,), bool)
        for slot, state in states.items():
            pend[slot] = state.pending
            active[slot] = True
        active = _upload(active, self.device)
        pend_t = _upload(pend, self.device)
        props = draft_propose(
            lambda t: self._decode(t, active, "draft_decode"), pend_t,
            self.spec_tokens)
        return torch.cat([pend_t[:, None], props.long()], 1), props

    # ----------------------------------------------- prefill/decode handoff

    def export_prefix(self, hashes, on_block=None):
        raise NotImplementedError(not_ported("export_prefix (KV handoff)",
                                             "A7b-ii"))

    def import_prefix(self, entries) -> int:
        raise NotImplementedError(not_ported("import_prefix (KV handoff)",
                                             "A7b-ii"))

    # ------------------------------------------------------------ API

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               request_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0,
               trace_context: Optional[dict] = None,
               tenant: Optional[str] = None) -> int:
        """Queue one request; returns its id. Raises when the request can
        never be scheduled (block span beyond a slot) or the queue is full.

        ``deadline_s`` bounds the request's WHOLE lifetime (queue wait
        included) on the server clock; ``priority`` (higher wins) orders
        preemption and shedding victims, FIFO breaks ties. ``tenant``
        labels the request for per-tenant metering (never read by
        scheduling); ``trace_context`` lands as ``link_*`` attributes on
        the request trace's root."""
        if deadline_s is not None:
            self._check_shared_clock("deadline_s")
        floor = max(1, self.engine.config.min_out_tokens)
        rej = submit_rejection(prompt, max_new_tokens, floor, deadline_s)
        if rej is not None:
            self._count_rejection(rej[0], request_id, tenant=tenant)
            raise ValueError(rej[1])
        if request_id is None:
            request_id = self._next_id
        elif (request_id in self._results
              or any(s.request.request_id == request_id
                     for s in self.scheduler.slots.values())
              or any(r.request_id == request_id
                     for r in self.scheduler.queue)):
            self._count_rejection("duplicate_id", request_id,
                                  tenant=tenant)
            raise ValueError(
                f"request_id {request_id} is already queued, resident, "
                "or finished — a duplicate would silently overwrite its "
                "output")
        self._next_id = max(self._next_id, request_id) + 1
        now = self._clock()
        deadline_ts = None if deadline_s is None else now + deadline_s
        try:
            self.scheduler.submit(Request(
                request_id=request_id, prompt=list(prompt),
                max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                priority=priority, deadline_ts=deadline_ts,
                tenant=tenant))
        except Exception:
            # scheduler-side refusals count into the same per-tenant
            # rejection series as server-side ones
            if self._ledger is not None:
                self._ledger.tenants.count_rejection(tenant)
            raise
        if self._ledger is not None:
            self._ledger.open(request_id, tokens_in=len(prompt),
                              tenant=tenant)
        self._submit_ts[request_id] = now
        self._queued_ts[request_id] = now
        if deadline_ts is not None:
            self._deadlines[request_id] = deadline_ts
        if self.tracer is not None:
            # the root opens NOW; the queue_wait child stays open until
            # admission into a slot
            tr = self.tracer.start_trace(
                "request", trace_id=request_id,
                prompt_tokens=len(prompt),
                max_new_tokens=max_new_tokens)
            if priority:
                tr.root.set("priority", priority)
            if deadline_s is not None:
                tr.root.set("deadline_s", deadline_s)
            if trace_context:
                for k, v in trace_context.items():
                    tr.root.set(f"link_{k}", v)
            rt = _RequestTrace(tr)
            rt.queue = tr.begin("queue_wait")
            self._rt[request_id] = rt
        self._c_submitted.inc()
        if self._fi is not None:
            self._fi.on_submit(request_id)
        return request_id

    def _count_rejection(self, reason: str,
                         request_id: Optional[int] = None,
                         tenant: Optional[str] = None) -> None:
        """Server-side refusals; the scheduler counts its own (span/pool/
        queue_full) into the same family."""
        self.telemetry.counter(
            "serve_admission_rejections_total",
            help="refused submit() calls, by reason",
            labels={"reason": reason}).inc()
        if self._ledger is not None:
            self._ledger.tenants.count_rejection(tenant)
        get_event_ring().record(telemetry_events.ADMISSION_REJECT,
                                reason=reason, source="server")
        if self.tracer is not None:
            # rejected requests are ALWAYS kept
            attrs = {} if request_id is None else {"request_id": request_id}
            self.tracer.record_rejected("request", reason, **attrs)

    # ------------------------------------------------- lifecycle actions

    def _reset_slot_arrays(self, slot: int) -> None:
        """Device-side reset of a vacated slot — length 0 and an all-null
        block table, so later decode appends land in the null block — as
        stream-ordered writes (no sync; steps already in flight read the
        old row)."""
        self._cache.lengths[slot] = 0
        self._cache.block_tables[slot] = 0
        if self._draft_cache is not None:
            # the draft shares the tables; its length must not let stale
            # draft k/v read as live context
            self._draft_cache.lengths[slot] = 0
        # every slot-vacating path runs through here: drop its lookup state
        self._spec_hist.pop(slot, None)

    def _drop_prefill_job(self, slot: int) -> None:
        """Forget any in-flight chunked prefill for a vacated slot."""
        if slot in self._mid_prefill:
            if (self._chunk_pending_t0 is not None and self._prefilling
                    and self._prefilling[0]["slot"] == slot):
                # the dropped slot owns the deferred chunk dispatch:
                # rebalance the profiler's outstanding pairing now (no
                # span is credited: its fetch is unobservable)
                if self._profiler is not None:
                    self._profiler.note_fetch(self._clock())
                self._chunk_pending_t0 = None
            self._mid_prefill.discard(slot)
            self._prefilling = deque(
                j for j in self._prefilling if j["slot"] != slot)

    def _teardown_slot(self, slot: int) -> None:
        """Vacate a resident slot mid-flight (cancel / injected prefill
        fault / retries-exhausted preemption): drop any in-flight chunk
        job, release the blocks, reset the device-side slot state — in
        that order."""
        if self._ledger is not None:
            state = self.scheduler.slots.get(slot)
            if state is not None:
                self._ledger.close_residency(state.request.request_id)
        self._drop_prefill_job(slot)
        self.scheduler.release(slot)
        self._reset_slot_arrays(slot)

    def _finalize(self, req: Request, tokens: List[int], reason: str,
                  finished: Optional[list] = None) -> None:
        """Terminal lifecycle bookkeeping shared by cancel / deadline /
        shed / fail: record the (possibly partial) output and finish
        reason, tick the reason's counter and ring event, close the trace
        (always kept) and feed the watchdog."""
        rid = req.request_id
        self._results[rid] = tokens
        self.finish_reasons[rid] = reason
        if finished is not None:
            finished.append(rid)
        self._submit_ts.pop(rid, None)
        self._queued_ts.pop(rid, None)
        self._deadlines.pop(rid, None)
        if self._ledger is not None:
            self._ledger.finish(
                rid, tokens_out=max(len(tokens) - len(req.prompt), 0),
                reason=reason)
        if self._pool_acct is not None:
            self._pool_acct.observe_request_peak(req.peak_blocks)
        self._c_finish[reason].inc()
        self._lifecycle_counts[reason] += 1
        get_event_ring().record(
            _LIFECYCLE_EVENTS[reason], request_id=rid,
            generated=len(tokens) - len(req.prompt),
            preemptions=req.preemptions)
        rt = (self._rt.pop(rid, None) if self.tracer is not None
              else None)
        if rt is not None:
            for sp in (rt.queue, rt.prefill, rt.decode):
                if sp is not None and sp.end is None:
                    rt.trace.end_span(sp)
            rt.trace.root.set("finish_reason", reason)
            rt.trace.root.set("generated_tokens",
                              len(tokens) - len(req.prompt))
            self.tracer.finish(rt.trace, status=reason)
        if self.watchdog is not None:
            self.watchdog.notify_progress()

    def cancel(self, request_id: int, reason: str = "cancelled") -> bool:
        """Cancel one request in ANY state: queued (prompt returned as the
        partial result), mid-prefill or decoding (slot retired, blocks
        released, prompt + tokens-so-far returned). Returns False when the
        request is already finished or unknown. ``reason`` is "cancelled"
        from callers, "deadline" from the reaper."""
        if reason not in ("cancelled", "deadline"):
            raise ValueError(
                f"cancel reason must be 'cancelled' or 'deadline', "
                f"got {reason!r}")
        if request_id in self._results:
            return False
        req = self.scheduler.remove_queued(request_id)
        if req is not None:
            self._finalize(req, list(req.prompt) + list(req.committed),
                           reason)
            return True
        slot = self.scheduler.find_slot(request_id)
        if slot is None:
            return False
        if self._inflight:
            # cancel takes effect at the COMMITTED boundary the caller
            # observed: the target's in-flight tokens are discarded,
            # everyone else's commit normally
            self._flush_pipeline(self._deferred_finished, reason="cancel",
                                 discard_rid=request_id)
        state = self.scheduler.slots[slot]
        self._teardown_slot(slot)
        self._finalize(state.request,
                       list(state.request.prompt) + list(state.generated),
                       reason)
        return True

    def reclaim(self, request_id: int) -> Optional[List[int]]:
        """Take an UNFINISHED request away without leaving a terminal
        record (cancel, then forget its result and finish reason so the
        SAME id can be resubmitted). Returns the partial output, or None
        when the request is unknown or already finished."""
        if request_id in self._results:
            return None
        if not self.cancel(request_id):
            return None
        out = self._results.pop(request_id)
        self.finish_reasons.pop(request_id, None)
        return out

    def forget(self, request_id: int) -> None:
        """Drop a FINISHED request's terminal record (and its cost record)
        so the same id is resubmittable here again."""
        self._results.pop(request_id, None)
        self.finish_reasons.pop(request_id, None)
        if self._ledger is not None:
            self._ledger.pop_cost(request_id)

    def _fail_request(self, req: Request, tokens: List[int],
                      error: str, finished: Optional[list]) -> None:
        """Server-side failure (injected prefill fault / preemption
        retries exhausted): finish reason ``failed`` and an always-kept
        error trace naming the cause."""
        rt = (self._rt.get(req.request_id)
              if self.tracer is not None else None)
        if rt is not None:
            rt.trace.root.set("error", error)
        self._finalize(req, tokens, "failed", finished)

    def _injected_prefill_fault(self, slot: int, state,
                                finished: list,
                                seeded: bool = True) -> bool:
        """Fault-injection prefill site of both prefill paths: when the
        injector kills this request's prefill, tear the slot down and
        fail the request; True = the caller skips the prefill.
        ``seeded=False`` = targeted arms only (the seeded coin is per
        request, flipped at its first admission)."""
        if self._fi is None:
            return False
        req = state.request
        try:
            self._fi.check_prefill(req.request_id, seeded=seeded)
        except PrefillFault as e:
            self._teardown_slot(slot)
            self._fail_request(
                req, list(req.prompt) + list(state.generated),
                str(e), finished)
            return True
        return False

    def _reap_deadlines(self, finished: list) -> None:
        """Retire every request whose deadline passed — queued or resident
        — with finish reason ``deadline``."""
        if not self._deadlines:
            return
        now = self._clock()
        expired = [rid for rid, ts in self._deadlines.items() if now >= ts]
        for rid in expired:
            if self.cancel(rid, reason="deadline"):
                finished.append(rid)
            else:
                self._deadlines.pop(rid, None)

    def _maybe_shed(self, finished: list) -> None:
        """SLO-driven load shedding: while the queue-wait p90 objective is
        in violation on live in-window evidence, and some waiter has
        actually aged past the target since it last entered the queue,
        fast-fail the lowest-priority newest queued requests down to
        ``num_slots`` waiters."""
        if not self._shedding or self.slo is None:
            return
        self.slo.maybe_evaluate()
        res = self.slo.last_results.get("queue_wait_p90")
        if not res or not res["violated"] or res.get("no_data"):
            return
        now = self._clock()
        target = self.slo.targets["queue_wait_p90"]
        if not any(now - self._queued_ts.get(r.request_id, now) > target
                   for r in self.scheduler.queue):
            return
        while self.scheduler.pending_requests > self.num_slots:
            victim = min(
                enumerate(self.scheduler.queue),
                key=lambda iv: (iv[1].priority, -iv[0]))[1]
            self.scheduler.remove_queued(victim.request_id)
            self._finalize(victim,
                           list(victim.prompt) + list(victim.committed),
                           "shed", finished)

    def _preempt_slot(self, slot: int, finished: list) -> None:
        """Preempt one resident (recompute-requeue), or fail it when its
        retry budget is spent."""
        state = self.scheduler.slots[slot]
        req = state.request
        if req.preemptions >= self.max_preemptions:
            # bounded retries: failing loudly (kept error trace) beats a
            # preempt/requeue livelock
            self._teardown_slot(slot)
            self._fail_request(
                req, list(req.prompt) + list(state.generated),
                f"preempted {req.preemptions}x (max_preemptions)",
                finished)
            return
        mid = slot in self._mid_prefill
        self._drop_prefill_job(slot)
        rt = (self._rt.get(req.request_id)
              if self.tracer is not None else None)
        if rt is not None:
            if rt.decode is not None:
                rt.decode.set("tokens_committed", rt.tokens)
                rt.decode.set("steps", rt.steps)
                rt.trace.end_span(rt.decode)
                rt.decode = None
            if rt.prefill is not None and rt.prefill.end is None:
                rt.prefill.set("preempted", True)
                rt.trace.end_span(rt.prefill)
            rt.prefill = None
        if self._ledger is not None:
            # residency pauses while the request waits off-pool; the
            # record stays open
            self._ledger.close_residency(req.request_id)
        self.scheduler.preempt(slot, self._tick, self._backoff_steps,
                               register_extension=not mid)
        # requeue moment
        self._queued_ts[req.request_id] = self._clock()
        self._reset_slot_arrays(slot)
        self._c_preempted.inc()
        self._lifecycle_counts["preempted"] += 1
        get_event_ring().record(
            telemetry_events.PREEMPT, request_id=req.request_id,
            slot=slot, preemptions=req.preemptions,
            committed_tokens=len(req.committed),
            ready_at_step=req.ready_at_step)
        if rt is not None:
            rt.trace.root.set("preemptions", req.preemptions)
            rt.queue = rt.trace.begin("queue_wait", requeue=True)
        if self.watchdog is not None:
            self.watchdog.notify_progress()

    def _preempt_for_head(self, finished: list) -> bool:
        """When the first eligible queued request still isn't resident
        after admission, preempt the lowest-priority newest resident IF it
        ranks strictly below the waiter. Equal priorities never preempt."""
        if self.max_preemptions <= 0:
            return False
        now = self._clock() if self._deadlines else None
        head = self.scheduler.next_ready(self._tick, now=now)
        if head is None:
            return False
        victim = self.scheduler.pick_preemption_victim()
        if victim is None:
            return False
        slot, state = victim
        if state.request.priority >= head.priority:
            return False
        self._preempt_slot(slot, finished)
        return True

    def _admit(self, finished: list, sp=NULL_STEP_HANDLE) -> None:
        """Admit queued requests into free slots until blocks or slots run
        out. Monolithic mode prefills inline (one prompt bucket, 128·2^k,
        floored at block_size); chunked mode only claims the slot and
        installs its block table here — the prefill runs a chunk per
        ``step()`` via :meth:`_run_prefill_chunk`."""
        while True:
            now = self._clock() if self._deadlines else None
            swaps0 = (self.scheduler.allocator.swap_ins
                      if self._ledger is not None else 0)
            adm = self.scheduler.admit_next(self._tick, now=now)
            if adm is None:
                return
            slot, state = adm
            req = state.request
            sched_prompt = req.sched_prompt
            t_admit = self._clock()
            if not state.resumed:
                self._h_queue_wait.observe(
                    t_admit - self._submit_ts.get(req.request_id, t_admit))
            if self._ledger is not None:
                # queue wait charges EVERY admission; block residency
                # opens against the slot's whole allocated span
                self._ledger.note_queued(
                    req.request_id,
                    t_admit - self._queued_ts.get(req.request_id,
                                                  t_admit))
                self._ledger.open_residency(
                    req.request_id, len(state.blocks), now=t_admit)
                d_swaps = self.scheduler.allocator.swap_ins - swaps0
                if d_swaps and self.host_tier is not None:
                    self._ledger.note_swap_in_bytes(
                        req.request_id,
                        d_swaps * self.host_tier.block_nbytes)
            rt = (self._rt.get(req.request_id)
                  if self.tracer is not None else None)
            adm_span = None
            if rt is not None:
                rt.trace.end_span(rt.queue)
                adm_span = rt.trace.begin(
                    "admission", slot=slot,
                    resumed=state.resumed,
                    prefix_cache_hit=state.cached_blocks > 0,
                    blocks_reused=state.cached_blocks,
                    blocks_allocated=(len(state.blocks)
                                      - state.cached_blocks))
            # block table first — the prefill scatter reads it. Entries
            # beyond the allocated span stay 0 (null block), so bucket/
            # chunk padding past the span spills harmlessly.
            row = np.zeros((self.max_blocks_per_slot,), np.int32)
            row[:len(state.blocks)] = state.blocks
            self._cache.block_tables[slot] = _upload(row, self.device)
            if rt is not None:
                # admission work is done: close the span BEFORE the fault
                # site, so a failure's kept trace has every child closed
                rt.trace.end_span(adm_span)
            # fault-injection prefill site: the seeded coin flips once per
            # FIRST admission of a request
            if self._injected_prefill_fault(slot, state, finished,
                                            seeded=not state.resumed):
                continue
            if self.chunk_tokens:
                cached_len = state.cached_blocks * self.block_size
                self._prefix_tokens_skipped += cached_len
                # pin the slot's live length at the cached boundary NOW:
                # decode steps before this slot's chunks append their
                # masked garbage token at lengths[slot] — the next PRIVATE
                # position, never offset 0 of a shared prefix block
                self._cache.lengths[slot] = cached_len
                self._prefilling.append(
                    {"slot": slot, "state": state, "start": cached_len})
                self._mid_prefill.add(slot)
                if rt is not None:
                    # the prefill span brackets the WHOLE chunked phase
                    rt.prefill = rt.trace.begin(
                        "prefill", chunked=True,
                        tokens=len(sched_prompt) - cached_len,
                        cached_tokens_skipped=cached_len)
                continue
            # ---------------- monolithic bucketed prefill (chunking off)
            T = min(max(_bucket(len(sched_prompt)), self.block_size),
                    self.max_blocks_per_slot * self.block_size)
            if rt is not None:
                rt.prefill = rt.trace.begin(
                    "prefill", chunked=False, tokens=len(sched_prompt),
                    bucket=T)
            ids = np.zeros((1, T), np.int64)
            ids[0, :len(sched_prompt)] = sched_prompt
            t_pf = self._clock()
            tok0 = self._prefill(ids, len(sched_prompt), slot)
            self._prefills += 1
            self._prefill_token_units += T
            if self._ledger is not None:
                # weight = the PADDED bucket actually computed
                self._ledger.add_weight(req.request_id, T)
            tok0 = int(tok0.cpu()[0])   # host sync: prefill done
            now_t = self._clock()
            # the prefill's dispatch→fetch interval is device-attributed
            sp.device_interval(t_pf, now_t)
            self.telemetry.histogram(
                "serve_prefill_seconds",
                help="prefill wall time, by padded prompt-bucket length",
                labels={"bucket": str(T)}).observe(now_t - t_admit)
            if not state.generated:
                # first token this request ever emitted (a resumed request
                # that already emitted tokens does not observe it again)
                self._h_ttft.observe(
                    now_t - self._submit_ts.get(req.request_id, now_t))
            self._c_prefills.inc()
            self._c_tokens.inc()
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # a prefill IS progress
            if rt is not None:
                rt.trace.end_span(rt.prefill)
            self._draft_prefill_slot(slot, state)
            state.generated.append(tok0)
            state.pending = tok0
            if self._finished(state, tok0):
                self._retire(slot, state, finished)
            elif rt is not None:
                rt.decode = rt.trace.begin("decode", slot=slot)

    def _run_prefill_chunk(self, finished: list,
                           sp=NULL_STEP_HANDLE) -> None:
        """Run AT MOST one chunk of the oldest in-flight chunked prefill,
        then the step decodes every active slot. With ``prefill_chain`` the
        prompt's NON-FINAL chunks dispatch as one device-side chain in a
        single call; the final chunk, which fetches the first token, stays
        on its own step."""
        if not self._prefilling:
            return
        job = self._prefilling[0]
        slot, state = job["slot"], job["state"]
        req = state.request
        sched_prompt = req.sched_prompt
        C = self.chunk_tokens
        plen = len(sched_prompt)
        # targeted arms only: the seeded coin flipped at admission
        if self._injected_prefill_fault(slot, state, finished,
                                        seeded=False):
            return
        rt = (self._rt.get(req.request_id)
              if self.tracer is not None else None)
        while True:
            start = job["start"]
            ids = np.zeros((1, C), np.int64)
            valid = min(plen - start, C)
            ids[0, :valid] = sched_prompt[start:start + valid]
            ck = None
            if rt is not None:
                ck = rt.trace.begin("prefill_chunk", parent=rt.prefill,
                                    start_token=start, tokens=valid)
            t0 = self._clock()
            tok = self._chunk(ids, start, plen, slot)
            self._prefill_chunks += 1
            self._prefill_token_units += C
            if self._ledger is not None:
                self._ledger.add_weight(req.request_id, C)
            job["start"] = start + C
            if job["start"] >= plen:
                break             # final chunk: fall through to fetch
            # NON-final chunk: its logits are chunk-tail garbage the host
            # never reads, so nothing is fetched. The dispatch is noted
            # now; its device span closes at the next real fetch
            # (_realize_chunk_span), which its compute precedes
            t1 = self._clock()
            self._h_prefill_chunk.observe(t1 - t0)   # dispatch interval
            if self._chunk_pending_t0 is None:
                # ONE dispatch note per pending chain (one fetch note
                # realizes it)
                self._chunk_pending_t0 = t0
                sp.note_dispatch(t0)
            if ck is not None:
                rt.trace.end_span(ck)
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # a chunk IS progress
            if not self._prefill_chain:
                return            # more chunks, one per step()
            if job["start"] + C >= plen:
                return            # next chunk is final — next step's
        # final chunk: the prompt is resident, the first token is real
        tok0 = int(tok.cpu()[0])  # host sync: prefill complete
        t1 = self._clock()
        self._h_prefill_chunk.observe(t1 - t0)
        sp.device_interval(self._chunk_pending_t0
                           if self._chunk_pending_t0 is not None
                           else t0, t1,
                           note_dispatch=self._chunk_pending_t0 is None)
        self._chunk_pending_t0 = None
        if ck is not None:
            rt.trace.end_span(ck)
        if self.watchdog is not None:
            self.watchdog.notify_progress()   # a chunk IS progress
        self._prefilling.popleft()
        self._mid_prefill.discard(slot)
        if self.prefix_caching:
            # publish the cold tail's full prompt blocks — only now is
            # their content valid for another request to hit
            self.scheduler.commit_prefix(state)
        now = self._clock()
        if not state.generated:
            self._h_ttft.observe(
                now - self._submit_ts.get(req.request_id, now))
        self._c_prefills.inc()
        self._c_tokens.inc()
        self._prefills += 1
        if rt is not None:
            rt.trace.end_span(rt.prefill)
        self._draft_prefill_slot(slot, state)
        state.generated.append(tok0)
        state.pending = tok0
        if self._finished(state, tok0):
            self._retire(slot, state, finished)
        elif rt is not None:
            rt.decode = rt.trace.begin("decode", slot=slot)

    def _finished(self, state, tok: int) -> bool:
        req = state.request
        if self._fi is not None and self._fi.is_wedged(req.request_id):
            # injected wedge: neither EOS nor budget finishes it — it
            # decodes until a deadline / cancel / bounded drain reaps it
            return False
        return (tok == req.eos_token_id
                or len(state.generated) >= req.max_new_tokens)

    def _retire(self, slot: int, state, finished: list) -> None:
        req = state.request
        rt = (self._rt.pop(req.request_id, None)
              if self.tracer is not None else None)
        fin = None
        if rt is not None:
            if rt.decode is not None:
                rt.decode.set("tokens_committed", rt.tokens)
                rt.decode.set("steps", rt.steps)
                rt.trace.end_span(rt.decode)
            fin = rt.trace.begin("finish")
        out = list(req.prompt) + state.generated
        self._results[req.request_id] = out
        reason = ("eos" if state.generated
                  and state.generated[-1] == req.eos_token_id
                  else "length")
        self.finish_reasons[req.request_id] = reason
        finished.append(req.request_id)
        ts = self._submit_ts.pop(req.request_id, None)
        self._queued_ts.pop(req.request_id, None)
        self._deadlines.pop(req.request_id, None)
        if ts is not None:
            self._h_request.observe(self._clock() - ts)
        if self._ledger is not None:
            # pending-close: the retiring step's own device share still
            # settles onto the record before it emits
            self._ledger.finish(req.request_id,
                                tokens_out=len(state.generated),
                                reason=reason)
        if self._pool_acct is not None:
            self._pool_acct.observe_request_peak(req.peak_blocks)
        self._c_finished.inc()
        # reserved-tail accounting: blocks allocated for budget the
        # sequence EOSed before reaching were never written (the cache
        # holds prompt + all generated but the last)
        live = len(req.prompt) + max(len(state.generated) - 1, 0)
        tail = max(0, len(state.blocks) - (-(-live // self.block_size)))
        if tail:
            self._c_tail_reclaimed.inc(tail)
            self._tail_reclaimed += tail
        # slot + blocks recycle NOW: the freed span admits the next queued
        # request on the same step
        self.scheduler.release(slot)
        self._reset_slot_arrays(slot)
        if rt is not None:
            rt.trace.root.set("finish_reason", reason)
            rt.trace.root.set("generated_tokens", len(state.generated))
            rt.trace.end_span(fin)
            self.tracer.finish(rt.trace)

    def step(self) -> List[int]:
        """One scheduler round: reap expired deadlines, admit from the
        queue into free slots (preempting lower-priority residents for a
        higher-priority waiter when the pool is short), run at most ONE
        chunk of any in-flight chunked prefill, then one decode step for
        all active resident slots. Returns the request ids that got a
        result this round.

        With ``inference.async_loop`` (default) a steady-state step — no
        queued work, no chunked prefill in flight, no expired deadline —
        runs PIPELINED: decode step N+1 dispatches chained from step N's
        device tokens before N is fetched, and the OLDEST in-flight step
        commits once the chain is ``max_commit_lag`` deep. Any step with a
        host-driven state change flushes the chain first."""
        # step observatory: phase marks at boundaries the loop already
        # crosses — clock reads only; OFF = the shared no-op handle
        sp = (self._profiler.begin() if self._profiler is not None
              else NULL_STEP_HANDLE)
        finished: List[int] = []
        self._take_deferred(finished)
        self._tick += 1
        if self.canary is not None:
            # the prober submits through the REAL path ahead of this
            # round's admission and scores its outstanding probe
            self.canary.tick()
        if self.alerts is not None:
            self.alerts.maybe_evaluate()
        if self._fi is not None:
            self._fi.apply_famine(self.scheduler.allocator)
        self._reap_deadlines(finished)
        self._maybe_shed(finished)
        self._take_deferred(finished)
        if (self._async and not self.scheduler.queue
                and not self._prefilling):
            return self._step_pipelined(sp, finished)
        if self._inflight:
            self._flush_pipeline(finished, sp, reason="host_action")
        self._admit(finished, sp)
        # degradation ladder, rung 2 (rung 1, prefix-LRU eviction, already
        # ran inside the allocator): preempt strictly-lower-priority
        # residents for the blocked waiter, re-admitting after each
        guard = self.num_slots
        while guard > 0 and self._preempt_for_head(finished):
            guard -= 1
            self._admit(finished, sp)
        # tier health: sample this admission round's swap-in traffic
        self._check_swap_thrash()
        sp.mark("admission")
        self._run_prefill_chunk(finished, sp)
        sp.mark("prefill_chunk")
        if not self.scheduler.slots:
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # idle is not a stall
            # nothing resident: the device idles for lack of WORK
            sp.finish(live=False)
            return finished
        if self.spec_tokens:
            self._decode_speculative(finished, sp)
        else:
            self._decode_once(finished, sp)
        if self.slo is not None and not self._shedding:
            self.slo.maybe_evaluate()
        if self._capacity is not None:
            self._capacity.maybe_evaluate()
        sp.mark("publish")
        sp.finish(live=bool(self.scheduler.slots))
        return finished

    # ------------------------------------------------ async dispatch loop

    def _take_deferred(self, finished: List[int]) -> None:
        if self._deferred_finished:
            finished.extend(self._deferred_finished)
            self._deferred_finished.clear()

    def _realize_chunk_span(self, sp, t1: float) -> None:
        """Close the device span of chunk dispatches whose fetch was
        deferred: the chunk finished before whatever result just landed
        at ``t1`` (the later program reads its pool writes)."""
        if self._chunk_pending_t0 is None:
            return
        if sp is not NULL_STEP_HANDLE:
            sp.device_interval(self._chunk_pending_t0, t1,
                               note_dispatch=False)
        elif self._profiler is not None:
            # no step handle live (out-of-step flush): keep the
            # outstanding-dispatch pairing exact
            self._profiler.note_fetch(t1)
        self._chunk_pending_t0 = None

    def _step_pipelined(self, sp, finished: List[int]) -> List[int]:
        """Steady-state async round: the only host work is the lag-N
        commit of the oldest in-flight step."""
        sp.mark("admission")      # the reap/shed/famine checks above
        sp.mark("prefill_chunk")  # by definition: no chunk work here
        if not self.scheduler.slots:
            if self._inflight:
                # every resident retired at the last commit; the steps
                # dispatched beside it are garbage — fetch and discard
                # them before any admission reuses the released blocks
                self._flush_pipeline(finished, sp, reason="drain_tail")
            if self.watchdog is not None:
                self.watchdog.notify_progress()
            sp.finish(live=False)
            return finished
        if self.spec_tokens:
            self._pipelined_verify(finished, sp)
        else:
            self._pipelined_decode(finished, sp)
        if self.slo is not None and not self._shedding:
            self.slo.maybe_evaluate()
        if self._capacity is not None:
            self._capacity.maybe_evaluate()
        sp.mark("publish")
        sp.finish(live=bool(self.scheduler.slots))
        return finished

    def _active_states(self) -> Dict[int, object]:
        return {slot: state for slot, state in self.scheduler.slots.items()
                if slot not in self._mid_prefill}

    def _pipelined_decode(self, finished: List[int], sp) -> None:
        """Dispatch decode step N+1 BEFORE fetching step N: N's greedy
        tokens are already a device tensor, so N+1 chains from them with
        no host round trip, and the host commits N-1 while the device runs.
        A slot that finished at step N already ran one garbage row in step
        N+1: its commit discards it by state identity. With
        ``max_commit_lag`` N > 1 the chain holds N programs before the
        oldest commits."""
        chain = self._inflight
        rec = chain[-1] if chain else None
        states = self._active_states()
        if not states:
            sp.mark("propose")
            return
        S = self.num_slots
        active = np.zeros((S,), bool)
        active[list(states)] = True
        self.profiler_capture.step_begin()
        if rec is None:
            # pipeline start: host-built inputs, dispatched without a fetch
            tok_in = np.zeros((S,), np.int64)
            for slot, state in states.items():
                tok_in[slot] = state.pending
        else:
            tok_in = rec.tokens    # device-side token feedback
        t0 = self._clock()
        # device-credit window: with a step in flight the device has work
        # for this WHOLE step; a pipeline start from its own dispatch
        sp.pipelined(since=None if rec is not None else t0)
        sp.mark("propose", now=t0, dispatch=True)
        nxt = self._decode(tok_in, active)
        sp.mark("dispatch")
        chain.append(InFlightStep("decode", nxt, states, t0))
        if rec is None:
            self._async_stats["pipeline_starts"] += 1
            sp.mark("sync_wait")
            sp.mark("commit")
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # a dispatch IS progress
        elif len(chain) > self._max_lag:
            # the chain is full: commit the OLDEST (lag-N) and rethread the
            # new oldest's latency baseline to this fetch
            oldest = chain.popleft()
            t1 = self._commit_decode_record(oldest, finished, sp)
            chain[0].prev_fetch = t1
            self._async_stats["pipelined_steps"] += 1
        else:
            self._async_stats["pipelined_steps"] += 1
            sp.mark("sync_wait")
            sp.mark("commit")
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # a dispatch IS progress
        self.profiler_capture.step_end()

    def _commit_decode_record(self, rec: InFlightStep,
                              finished: List[int], sp=NULL_STEP_HANDLE,
                              discard_rid: Optional[int] = None) -> float:
        """Lag-N host commit of one in-flight decode step: wait for its
        token copy, append/EOS-check/retire for every slot whose SlotState
        is still the one resident at dispatch. ``discard_rid`` drops one
        request's token (a cancel in progress). Returns the fetch time."""
        in_step = sp is not NULL_STEP_HANDLE
        nxt = rec.fetch.wait()    # this step's tokens, nothing later
        t1 = self._clock()
        if in_step:
            sp.mark("sync_wait", now=t1, fetch=True)
        elif self._profiler is not None:
            self._profiler.note_fetch(t1)
        self._realize_chunk_span(sp, t1)
        dt = t1 - (rec.prev_fetch if rec.prev_fetch is not None
                   else rec.t_dispatch)
        if self._fi is not None:
            # injected latency is ACCOUNTED, never slept
            dt += self._fi.step_latency()
        n_live = 0
        for slot, state in rec.states.items():
            if self.scheduler.slots.get(slot) is not state or (
                    discard_rid is not None
                    and state.request.request_id == discard_rid):
                # retired / torn down after dispatch: garbage token
                self._async_stats["discarded_tokens"] += 1
                continue
            n_live += 1
            self._commit_slot_token(slot, state, int(nxt[slot]), finished)
        if in_step:
            sp.mark("commit")
        if n_live == 0:
            self._async_stats["garbage_steps"] += 1
            return t1
        self._step_clock += 1
        self._active_slot_steps += n_live
        self._queue_publish("decode", dt, n_live, n_live / self.num_slots)
        if self.watchdog is not None:
            self.watchdog.notify_progress()
        if self._step_clock % self._EVENT_EVERY == 1:
            get_event_ring().record(
                telemetry_events.STEP_END, source="serve_decode",
                step=self._step_clock, live=n_live, seconds=round(dt, 6),
                pipelined=True, sampled_every=self._EVENT_EVERY)
        return t1

    def _publish_decode_step(self, dt: float, n_live: int,
                             occ: float) -> None:
        self._h_decode_step.observe(dt)
        self._h_token.observe(dt)
        self._c_decode_steps.inc()
        self._c_tokens.inc(n_live)
        self._g_occupancy.set(occ)

    def _propose(self, states: Dict[int, object]):
        """Each slot's verify row ``[pending, p_1..p_{K-1}]`` from prompt
        lookup over its COMMITTED history (prompt + generated), with the
        incremental LookupIndex: full build at the slot's first verify,
        tail sync after. Returns ``(tokens [S, K], props)``."""
        K = self.spec_tokens
        tokens = np.zeros((self.num_slots, K), np.int32)
        props: Dict[int, List[int]] = {}
        for slot, state in states.items():
            entry = self._spec_hist.get(slot)
            if entry is None or entry[0] is not state:
                idx = LookupIndex(state.request.prompt)
                idx.extend(state.generated)
                self._spec_hist[slot] = (state, idx)
            else:
                idx = entry[1]
                grown = (len(state.request.prompt) + len(state.generated)
                         - len(idx.hist))
                if grown > 0:
                    idx.extend(state.generated[-grown:])
            props[slot] = idx.proposals(K - 1)
            tokens[slot, 0] = state.pending
            tokens[slot, 1:] = props[slot]
        return tokens, props

    def _pipelined_verify(self, finished: List[int], sp) -> None:
        """Async speculation round: commit the in-flight verify, then
        propose + dispatch the NEXT one and return with it in flight.
        Proposals come from the committed history, so the verify path
        commits BEFORE dispatching (chains never deepen past one round)."""
        chain = self._inflight
        rec = chain[-1] if chain else None
        prev_fetch = None
        # device credit in this round rides explicit spans ([step begin →
        # fetch] at commit, [dispatch → step end] via pipelined())
        sp.pipelined_mode()
        if rec is not None:
            prev_fetch = self._commit_verify_record(rec, finished, sp)
            chain.clear()
            self._async_stats["pipelined_steps"] += 1
        states = self._active_states()
        if not states:
            sp.mark("propose")
            return
        self.profiler_capture.step_begin()
        t0, t_toks, props = self._dispatch_verify(states, sp)
        self.profiler_capture.step_end()
        if rec is None:
            self._async_stats["pipeline_starts"] += 1
            if self.watchdog is not None:
                self.watchdog.notify_progress()   # a dispatch IS progress
        sp.pipelined(since=t0)
        chain.append(InFlightStep("verify", t_toks, states, t0, props=props,
                                  prev_fetch=prev_fetch))

    def _dispatch_verify(self, states: Dict[int, object],
                         sp=NULL_STEP_HANDLE):
        """Propose for ``states`` and dispatch the batched verify. Returns
        ``(t0, tokens, props)``: with prompt lookup the verify's argmaxes
        ``[S, K]`` and the per-slot host proposals; with a draft engine
        the argmaxes and the device proposals side by side, ``[S, 2K-1]``,
        so one copy brings both to the host, and ``props`` None. The
        proposal scan ends at ``t0``, where the dispatch-gap boundary is
        marked."""
        props = None
        if self.draft is None:
            tokens, props = self._propose(states)
        t0 = self._clock()
        self._realize_chunk_span(sp, t0)
        sp.mark("propose", now=t0, dispatch=True)
        if self.draft is None:
            out = self._verify(tokens)
        else:
            tokens, d_props = self._draft_propose(states)
            t_toks = self._verify(tokens)
            out = torch.cat([t_toks, d_props.to(t_toks.dtype)], 1)
        sp.mark("dispatch")
        return t0, out, props

    def _commit_verify_record(self, rec: InFlightStep, finished: List[int],
                              sp=NULL_STEP_HANDLE,
                              discard_rid: Optional[int] = None) -> float:
        """Commit one in-flight verify round: greedy-accept against the
        proposals it was scored with, append/EOS-check/retire per
        surviving slot, and advance lengths over the accepted prefixes in
        ONE device update."""
        in_step = sp is not NULL_STEP_HANDLE
        t_np, props = self._split_verify(rec.fetch.wait(), rec.props)
        t1 = self._clock()
        if in_step and getattr(sp, "_pipelined_mode", False):
            sp.mark("sync_wait", now=t1)
            # device busy from step begin (the round was in flight across
            # the call boundary) until this fetch
            sp.device_interval(0.0, t1, note_dispatch=False)
        elif in_step:
            sp.mark("sync_wait", now=t1, fetch=True)
        elif self._profiler is not None:
            self._profiler.note_fetch(t1)
        self._realize_chunk_span(sp, t1)
        dt = t1 - (rec.prev_fetch if rec.prev_fetch is not None
                   else rec.t_dispatch)
        if self._fi is not None:
            dt += self._fi.step_latency()
        live = {}
        for slot, state in rec.states.items():
            if self.scheduler.slots.get(slot) is not state or (
                    discard_rid is not None
                    and state.request.request_id == discard_rid):
                self._async_stats["discarded_tokens"] += 1
                continue
            live[slot] = state
        if not live:
            sp.mark("commit")
            self._async_stats["garbage_steps"] += 1
            return t1
        self._accept_and_commit(live, t_np, props, dt, finished,
                                inline=False, sp=sp)
        return t1

    def _split_verify(self, t_np: np.ndarray, props):
        """A fetched verify round's argmaxes and the proposals they were
        scored with: the draft's columns of the fetched block when the
        round had no host proposals (see :meth:`_dispatch_verify`)."""
        if props is not None:
            return t_np, props
        K = self.spec_tokens
        return t_np[:, :K], t_np[:, K:]

    def _accept_and_commit(self, live: Dict[int, object], t_np, props,
                           dt: float, finished: List[int],
                           inline: bool, sp=NULL_STEP_HANDLE) -> None:
        """The post-fetch half of a verify round, shared by the sync and
        async paths: greedy acceptance per slot, per-token EOS/budget
        bookkeeping, one vectorised length advance, then retirement. The
        sync path publishes its metrics ``inline``; the async path hands
        them to the worker."""
        K = self.spec_tokens
        adv = np.zeros((self.num_slots,), np.int32)
        committed_total = accepted_total = 0
        per_slot_commits: List[int] = []
        retire: List[int] = []
        for slot, state in live.items():
            m, committed = greedy_accept_host(t_np[slot], props[slot])
            accepted_total += m
            rt = (self._rt.get(state.request.request_id)
                  if self.tracer is not None else None)
            if rt is not None and rt.decode is not None:
                rt.steps += 1
            done = False
            n_committed = 0
            for tok in committed:
                state.generated.append(tok)
                n_committed += 1
                if rt is not None and rt.decode is not None:
                    rt.tokens += 1
                if self._finished(state, tok):
                    done = True
                    break
            committed_total += n_committed
            per_slot_commits.append(n_committed)
            # a continuing slot's cache gains [pending, p_1..p_m]; the
            # correction becomes the next pending. A retiring slot's
            # length is reset right below.
            adv[slot] = n_committed
            if self._ledger is not None:
                rid_ = state.request.request_id
                self._ledger.add_weight(rid_, n_committed)
                self._ledger.note_spec(rid_, K - 1, m)
            if done:
                retire.append(slot)
            else:
                state.pending = committed[-1]
        self._cache.lengths.add_(_upload(adv, self.device))
        if self._draft_cache is not None:
            # the proposal round advanced the draft pool by K a slot;
            # reconcile each surviving slot to its committed prefix before
            # the retire loop zeroes this round's finishers
            d_adj = np.zeros((self.num_slots,), np.int32)
            for slot in live:
                d_adj[slot] = int(adv[slot]) - K
            self._draft_cache.lengths.add_(_upload(d_adj, self.device))
        for slot in retire:
            self._retire(slot, self.scheduler.slots[slot], finished)
        sp.mark("commit")
        n_live = len(live)
        self._step_clock += 1
        self._active_slot_steps += n_live
        proposed = n_live * (K - 1)
        self._spec_proposed += proposed
        self._spec_accepted += accepted_total
        self._spec_committed += committed_total
        self._spec_steps += 1
        self._spec_slot_steps += n_live
        self._maybe_spec_collapse(proposed, accepted_total)
        vals = (dt, n_live, committed_total, proposed, accepted_total,
                per_slot_commits)
        if inline:
            self._publish_verify_step(*vals)
        else:
            self._queue_publish("verify", *vals)
        if self.watchdog is not None:
            self.watchdog.notify_progress()
        if self._step_clock % self._EVENT_EVERY == 1:
            get_event_ring().record(
                telemetry_events.STEP_END, source="serve_spec_verify",
                step=self._step_clock, live=n_live,
                committed=committed_total, accepted=accepted_total,
                seconds=round(dt, 6), sampled_every=self._EVENT_EVERY)

    def _publish_verify_step(self, dt: float, n_live: int,
                             committed_total: int, proposed: int,
                             accepted: int,
                             per_slot_commits: List[int]) -> None:
        self._h_decode_step.observe(dt)
        self._h_token.observe(dt * n_live / max(committed_total, 1))
        self._c_decode_steps.inc()
        self._c_tokens.inc(committed_total)
        self._g_occupancy.set(n_live / self.num_slots)
        self._c_spec_proposed.inc(proposed)
        self._c_spec_accepted.inc(accepted)
        for n in per_slot_commits:
            self._h_spec_commit.observe(n)

    # one worker job per this many buffered step records
    _PUBLISH_BATCH = 16

    def _queue_publish(self, kind: str, *vals) -> None:
        self._pub_buf.append((kind, vals))
        if len(self._pub_buf) >= self._PUBLISH_BATCH:
            self._ship_publish_buf()

    def _ship_publish_buf(self) -> None:
        """Hand the buffered step records to the worker as ONE job."""
        if not self._pub_buf:
            return
        buf, self._pub_buf = self._pub_buf, []

        def job():
            for kind, vals in buf:
                if kind == "decode":
                    self._publish_decode_step(*vals)
                else:
                    self._publish_verify_step(*vals)

        self._worker.submit(job)

    def _drain_publishing(self) -> None:
        self._ship_publish_buf()
        self._worker.drain()

    def _flush_pipeline(self, finished: List[int], sp=NULL_STEP_HANDLE,
                        reason: str = "",
                        discard_rid: Optional[int] = None) -> None:
        """Commit whatever is in flight, oldest first, and drain the
        publish worker — the bounded flush every host-driven state change
        pays so the scheduler acts on committed state."""
        if self._inflight:
            depth = len(self._inflight)
            while self._inflight:
                rec = self._inflight.popleft()
                commit = (self._commit_decode_record if rec.kind == "decode"
                          else self._commit_verify_record)
                t1 = commit(rec, finished, sp, discard_rid=discard_rid)
                if self._inflight:
                    self._inflight[0].prev_fetch = t1
            fl = self._async_stats["flushes"]
            fl[reason] = fl.get(reason, 0) + 1
            fd = self._async_stats["flush_depths"].setdefault(reason, {})
            fd[depth] = fd.get(depth, 0) + 1
        self._drain_publishing()

    def _decode_once(self, finished: List[int],
                     sp=NULL_STEP_HANDLE) -> None:
        """One synchronous decode step for all active resident slots."""
        states = self._active_states()
        if not states:
            sp.mark("propose")
            return   # every resident slot is mid-prefill
        tokens = np.zeros((self.num_slots,), np.int64)
        active = np.zeros((self.num_slots,), bool)
        for slot, state in states.items():
            tokens[slot] = state.pending
            active[slot] = True
        self.profiler_capture.step_begin()
        t0 = self._clock()
        # a deferred chunk span closes here: the device ran the chunk
        # from its dispatch until (at least) this boundary
        self._realize_chunk_span(sp, t0)
        sp.mark("propose", now=t0, dispatch=True)
        nxt = self._decode(tokens, active)
        sp.mark("dispatch")
        self._step_clock += 1
        n_active = len(states)
        self._active_slot_steps += n_active
        nxt = nxt.cpu().numpy()          # host sync: the step completed
        t1 = self._clock()
        dt = t1 - t0
        sp.mark("sync_wait", now=t1, fetch=True)
        if self._fi is not None:
            # injected latency is ACCOUNTED, never slept
            dt += self._fi.step_latency()
        self.profiler_capture.step_end()
        self._publish_decode_step(dt, n_active, n_active / self.num_slots)
        if self.watchdog is not None:
            self.watchdog.notify_progress()
        if self._step_clock % self._EVENT_EVERY == 1:
            get_event_ring().record(
                telemetry_events.STEP_END, source="serve_decode",
                step=self._step_clock, live=n_active, seconds=round(dt, 6),
                sampled_every=self._EVENT_EVERY)
        sp.mark("publish")
        for slot, state in states.items():
            self._commit_slot_token(slot, state, int(nxt[slot]), finished)
        sp.mark("commit")

    def _commit_slot_token(self, slot: int, state, tok: int,
                           finished: List[int]) -> None:
        """Commit ONE decode token for one slot — the shared per-slot
        commit body of the sync loop and the lag-N commit."""
        state.generated.append(tok)
        if self._ledger is not None:
            self._ledger.add_weight(state.request.request_id, 1)
        if self.tracer is not None:
            rt = self._rt.get(state.request.request_id)
            if rt is not None and rt.decode is not None:
                rt.steps += 1
                rt.tokens += 1
        if self._finished(state, tok):
            self._retire(slot, state, finished)
        else:
            state.pending = tok

    def _decode_speculative(self, finished: List[int],
                            sp=NULL_STEP_HANDLE) -> None:
        """One synchronous speculative round: each active slot proposes up
        to K-1 tokens by prompt lookup, ONE batched verify forward scores
        every slot's ``[pending, p_1..p_{K-1}]`` through the block tables,
        and the accepted prefix commits host-side — 1..K tokens per slot.
        Rejected positions stay as masked garbage beyond ``lengths``."""
        states = self._active_states()
        if not states:
            sp.mark("propose")
            return
        self.profiler_capture.step_begin()
        t0, t_toks, props = self._dispatch_verify(states, sp)
        t_np, props = self._split_verify(t_toks.cpu().numpy(), props)
        t1 = self._clock()
        dt = t1 - t0
        sp.mark("sync_wait", now=t1, fetch=True)
        if self._fi is not None:
            dt += self._fi.step_latency()
        self.profiler_capture.step_end()
        self._accept_and_commit(states, t_np, props, dt, finished,
                                inline=True, sp=sp)
        sp.mark("publish")

    def _maybe_spec_collapse(self, proposed: int, accepted: int) -> None:
        """Ring-event an acceptance-rate collapse ONCE per episode; re-arms
        after the rate recovers."""
        self._spec_window.append((proposed, accepted))
        p = sum(w[0] for w in self._spec_window)
        if p < self._SPEC_MIN_PROPOSED:
            return
        rate = sum(w[1] for w in self._spec_window) / p
        if not self._spec_alarm and rate < self._SPEC_COLLAPSE_RATE:
            self._spec_alarm = True
            get_event_ring().record(
                telemetry_events.SPEC_COLLAPSE,
                acceptance_rate=round(rate, 4),
                window_steps=len(self._spec_window), proposed=p,
                k=self.spec_tokens)
        elif self._spec_alarm and rate >= self._SPEC_RECOVER_RATE:
            self._spec_alarm = False

    def result(self, request_id: int) -> Optional[List[int]]:
        """Finished output (prompt + generated, EOS included) or None;
        lifecycle-terminated requests return their partial output."""
        return self._results.get(request_id)

    def finish_reason(self, request_id: int) -> Optional[str]:
        """``eos`` / ``length`` / ``cancelled`` / ``deadline`` /
        ``shed`` / ``failed``, or None while unfinished."""
        return self.finish_reasons.get(request_id)

    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[int, List[int]]:
        """Run ``step`` until queue and slots are empty; returns all
        finished outputs keyed by request id. ``timeout_s`` bounds the
        drain on the server clock: past it, every unfinished request is
        cancelled (partial results returned)."""
        check_drain_timeout(timeout_s)
        if timeout_s is not None:
            self._check_shared_clock("drain timeout_s")
        deadline = None if timeout_s is None \
            else self._clock() + timeout_s
        while not self.scheduler.idle:
            if deadline is not None and self._clock() >= deadline:
                get_event_ring().record(
                    telemetry_events.CANCEL, source="drain_timeout",
                    timeout_s=timeout_s,
                    stragglers=(self.scheduler.pending_requests
                                + self.scheduler.active_slots))
                for req in list(self.scheduler.queue):
                    self.cancel(req.request_id)
                for state in list(self.scheduler.slots.values()):
                    self.cancel(state.request.request_id)
                break
            self.step()
        # the async loop can leave garbage steps in flight beside the final
        # commits: fetch + discard them, so a drained server has no device
        # work outstanding and fully-published metrics
        self._flush_pipeline(self._deferred_finished, reason="drain")
        if self._ledger is not None:
            # no further worked step is coming: emit every pending-close
            # cost record now
            self._ledger.flush_pending()
        return dict(self._results)

    def dump_timeline(self, path: str) -> int:
        """Write the kept request traces plus the flight recorder's step
        and compile events as Chrome trace-event JSON (Perfetto,
        chrome://tracing). Returns the emitted event count."""
        if self.tracer is None:
            raise RuntimeError(
                "request tracing is off — set telemetry."
                "trace_sample_rate > 0 (docs/observability.md "
                "'Request tracing & SLOs')")
        return self.tracer.dump_timeline(path,
                                         event_ring=get_event_ring())

    def capture_decode_steps(self, num_steps: int, logdir: str) -> None:
        """Arm an on-demand ``torch.profiler`` capture: the next
        ``num_steps`` decode steps are traced into ``logdir`` as a Chrome
        trace. Host-side arming only (see telemetry/capture.py)."""
        self.profiler_capture.arm(num_steps, logdir)

    def close(self) -> None:
        """Release the scrape endpoint (its thread joined, the port
        free), the watchdog thread and the memory-monitor registrations,
        commit whatever is in flight and stop the publish worker. The
        canary submits only from ``step()``, so nothing probes after
        this. Idempotent."""
        if self._closed:
            return
        self._closed = True
        # disarm the stall watchdog BEFORE the teardown flush, whose
        # commits notify progress and would re-arm a fired watchdog
        wd, self.watchdog = self.watchdog, None
        if wd is not None:
            wd.disarm()
            wd.stop()
        if self.http_server is not None:
            self.http_server.close()
            self.http_server = None
        if self._host_mem_getter is not None:
            get_memory_monitor().unregister_component(
                "kv_host_tier", self._host_mem_getter)
            self._host_mem_getter = None
        if self._fi is not None:
            # a famine reservation withholds blocks of THIS pool only
            self.scheduler.allocator.set_reserved(0)
        self._flush_pipeline(self._deferred_finished, reason="close")
        if self._ledger is not None:
            self._ledger.flush_pending()
        self._worker.close()
        self._flight.close()

    # ------------------------------------------------------------ stats

    def _traces(self, kind: str) -> int:
        """Graphs captured for the ``kind`` step; -1 where steps run
        eagerly, 0 on CUDA over gloo ranks (none can be)."""
        if not self._cuda_graphs:
            return 0 if self._host_collectives else -1
        g = self._graphs.get(kind)
        return g.captures if g is not None else 0

    @property
    def stats(self) -> dict:
        """Serving telemetry, with the JAX server's keys. Where JAX counts
        executables, ``decode_traces``, ``verify_traces`` and
        ``draft_decode_traces`` count the graphs captured on CUDA (one per
        step kind at most: the shapes are static) and ``retraces`` those
        captured again (none: a graph is never recaptured);
        ``prefill_traces``, ``chunk_traces`` and ``draft_prefill_traces``
        (eager programs) and every counter on the CPU read -1, "unknown". The
        sections of unbuilt components (step profile, pool accounting,
        ledger, capacity, SLO, alerts, canary, incidents) read None, as in
        JAX."""
        self._drain_publishing()
        units = self._step_clock * self.num_slots
        alloc = self.scheduler.allocator
        return {
            "decode_steps": self._step_clock,
            "prefills": self._prefills,
            "prefill_chunks": self._prefill_chunks,
            "prefill_token_units": self._prefill_token_units,
            "decode_step_slot_units": units,
            "active_slot_steps": self._active_slot_steps,
            "slot_occupancy": (self._active_slot_steps / units
                               if units else 0.0),
            "decode_traces": self._traces("decode"),
            "prefill_traces": -1,
            "chunk_traces": -1 if self.chunk_tokens else 0,
            # a step's graph is captured once and never again
            "retraces": 0 if self._cuda_graphs else -1,
            "num_slots": self.num_slots,
            "block_size": self.block_size,
            "role": self.role,
            "free_blocks": alloc.free_blocks,
            "queued": self.scheduler.pending_requests,
            "prefix_caching": self.prefix_caching,
            "prefill_chunk_tokens": self.chunk_tokens,
            "prefix_cache_hits": self.scheduler.prefix_hits,
            "prefix_cache_misses": self.scheduler.prefix_misses,
            "prefix_cached_blocks": alloc.cached_blocks,
            "prefix_cache_evictions": alloc.evictions,
            "prefix_tokens_skipped": self._prefix_tokens_skipped,
            "tail_blocks_reclaimed": self._tail_reclaimed,
            "cancelled": self._lifecycle_counts["cancelled"],
            "deadline_expired": self._lifecycle_counts["deadline"],
            "preempted": self._lifecycle_counts["preempted"],
            "shed": self._lifecycle_counts["shed"],
            "failed": self._lifecycle_counts["failed"],
            "requeue_depth": self.scheduler.requeue_depth,
            "speculation": {
                "k": self.spec_tokens,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None,
                "verify_steps": self._spec_steps,
                "committed_tokens": self._spec_committed,
                "tokens_per_forward": round(
                    self._spec_committed / self._spec_slot_steps, 3)
                if self._spec_slot_steps else None,
                "verify_traces": (self._traces("verify")
                                  if self.spec_tokens else 0),
                "draft": ("model" if self.draft is not None
                          else "prompt-lookup"),
                # the draft's prefill is eager; its decode step a graph
                "draft_prefill_traces": (-1 if self.draft is not None
                                         else 0),
                "draft_decode_traces": (self._traces("draft_decode")
                                        if self.draft is not None else 0),
            },
            "kv_tier": {
                "kv_dtype": self.kv_dtype,
                "pool_bytes": sum(
                    int(x.nbytes) for x in (self._cache.k, self._cache.v,
                                            self._cache.k_scale,
                                            self._cache.v_scale)
                    if x is not None),
                "host_offload": self.host_tier is not None,
                "host_blocks": (len(self.host_tier)
                                if self.host_tier is not None else 0),
                "host_bytes": (self.host_tier.host_bytes
                               if self.host_tier is not None else 0),
                "host_dropped": (self.host_tier.dropped
                                 if self.host_tier is not None else 0),
                "demotions": alloc.demotions,
                "swap_ins": alloc.swap_ins,
                "thrash_alarm": self._swap_alarm,
            },
            "fault_injection": (self._fi.snapshot()
                                if self._fi is not None else None),
            "async_loop": {
                "enabled": self._async,
                "commit_lag": len(self._inflight),
                "max_commit_lag": self._max_lag,
                "prefill_chain": self._prefill_chain,
                "pipeline_starts": self._async_stats["pipeline_starts"],
                "pipelined_steps": self._async_stats["pipelined_steps"],
                "flushes": dict(self._async_stats["flushes"]),
                "flush_depths": {
                    reason: {str(d): n for d, n in sorted(depths.items())}
                    for reason, depths in sorted(
                        self._async_stats["flush_depths"].items())},
                "discarded_tokens": self._async_stats["discarded_tokens"],
                "garbage_steps": self._async_stats["garbage_steps"],
                "worker": self._worker.snapshot(),
            },
            "step_profile": (self._profiler.snapshot()
                             if self._profiler is not None else None),
            "kv_pool": (self._pool_snapshot()
                        if self._pool_acct is not None else None),
            "traces_started": (self.tracer.started
                               if self.tracer is not None else 0),
            "traces_kept": (self.tracer.kept
                            if self.tracer is not None else 0),
            "slo_compliance": (self.slo.compliance_ratio
                               if self.slo is not None else None),
            "accounting": (self._ledger.snapshot()
                           if self._ledger is not None else None),
            "capacity": (self._capacity.snapshot()
                         if self._capacity is not None else None),
            "alerts": (self.alerts.snapshot()
                       if self.alerts is not None else None),
            "canary": (self.canary.snapshot()
                       if self.canary is not None else None),
            "incidents": (self.incidents.snapshot()
                          if self.incidents is not None else None),
        }
