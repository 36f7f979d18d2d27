"""Inference engine.

Counterpart of ``deepspeed_tpu/inference/engine.py``: owns the weights on
one device, the dense KV cache and a HF-style ``generate``. The JAX
engine compiles the whole decode loop into one ``while_loop`` with one host
sync per generation; here the loop is Python over :func:`decode_step`,
which on CUDA runs as a CUDA graph
(:class:`~deepspeed_tpu_torch.inference.cuda_graph.GraphedStep`): captured
at the second step of the first ``generate`` of a shape and replayed every
step after, so a step costs one graph launch, not a launch per kernel.
Sampling (repetition penalty, min_new_tokens, temperature, top-k, top-p)
stays eager between replays. Graphs are on for every CUDA engine, as jit is
for every JAX one; ``enable_cuda_graph`` is accepted with no effect, as in
JAX. The engine keeps one dense cache and its graph, for the last (batch,
cache length) bucket, so repeated calls of one shape allocate and capture
nothing. The host asks the device whether every row is done only every
``DONE_CHECK_EVERY`` steps; rows that finished earlier keep decoding until
then, but their tokens are masked to 0 and not counted, so the check
changes only time, never output.

The other ways to generate are JAX's too, each a host loop over graphed
steps where JAX runs one ``while_loop``:

* ``generate(num_beams>1)``, JAX's ``_beam_loop``: beams decode through
  the decode graph over ``B * num_beams`` rows, and each step reorders the
  cache rows by parent in place (an ``index_select`` into scratch, then
  ``copy_``), so the graph's cache never moves.
* ``generate_speculative`` (and ``generate(assistant_model=...)``): a
  draft engine, or prompt lookup (``draft=None``), proposes ``K-1`` tokens
  a round and the target scores them in one :func:`decode_chunk`, itself a
  graph (``generate_verify``) over the kept cache; greedy acceptance, or
  rejection sampling when ``temperature > 0``. The draft keeps a cache and
  a decode graph of its own for the draft role, apart from its main cache,
  so a target may be its own draft. Acceptance and commit stay on the
  device; the host reads whether any row is live one round late, so it
  never waits for the round it has just enqueued.
* ``profile_model_time`` / ``model_times`` time each ``forward`` call,
  with CUDA events on the card.

:func:`save_serving_checkpoint` / :func:`load_serving_checkpoint` write and
read the JAX package's serving layout (a config JSON and one safetensors
file), in both directions.

Int8 weights, as in JAX: ``dtype="int8"`` stores the projection weights
as int8 with row-group scales and runs activations in bf16;
``quant.enabled`` does the same at the config's dtype; and
``quant.activation.enabled`` (w8a8) quantizes with per-output-channel
scales and runs every projection as an int8 x int8 GEMM
(``ops/int8_gemm.py``). Weights are quantized on the device, after the
cast to the activation dtype.

``model`` may also be an HF model: a live ``transformers`` model or a
``module_inject.state_dict_loader.CheckpointModelView`` over a state dict
(``init_inference(path)`` builds one over checkpoint files). The policy
table (``module_inject/policies.py``) converts it in the activation dtype
on the device its tensors lie on. Encoder configs (``pre_layer_norm=
False``: BERT, DistilBERT) run ``encoder_forward`` in :meth:`forward`.

**Several ranks** (``tensor_parallel.tp_size``, ``sp_size``; one process
a rank, started with ``init_distributed``): the engine takes a mesh of
``seq = sp_size`` and ``tensor = tp_size`` over the process group (JAX
``_build_mesh``: seq outside tensor) and keeps only its shard: the heads
of wq/wk/wv/wo and the MLP's columns by ``tp_param_specs`` (int8 leaves
quantized whole first, then cut like their weight), a dense cache of
``kv_heads / tp`` heads and, under ``sp_size``, of this rank's block of
``max_seq / sp`` positions (``seq_shard_kv``). The transformer states the
all-reduces (``model_implementations/transformer.py``). Every rank must
call ``generate`` with the same arguments (the same ``seed`` for
sampling): each holds the same replicated logits, so each makes the same
choices. Over NCCL the decode and verify graphs capture their
all-reduces; under gloo (host collectives, which a graph cannot capture)
the steps run eagerly, as the engine logs once.

``generate`` traces as JAX's does (``trace_sample_rate > 0``: a root with
``prefill_dispatch``, ``decode_dispatch`` and ``fetch`` children), and its
prefill and decode programs are under the compile watch (``infer_prefill``,
``infer_decode``; a decode graph's capture is its compile).

Not in this slice (ROADMAP.md queue C): expert-parallel meshes and MoE.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import (MeshConfig, axis_index, mesh_for,
                                           mesh_shape, set_global_mesh)
from deepspeed_tpu_torch.inference.async_loop import TokenFetch
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
from deepspeed_tpu_torch.inference.kv_cache import (KVCache, auto_max_tokens,
                                                    init_cache)
from deepspeed_tpu_torch.inference.speculation import (
    commit_speculative_block, greedy_accept, lookup_proposals)
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, causal_forward, decode_chunk, decode_step,
    encoder_forward, init_params, prefill)
from deepspeed_tpu_torch.module_inject.policies import convert_hf_model
from deepspeed_tpu_torch.module_inject.quantize import GroupQuantizer
from deepspeed_tpu_torch.ops.int8_gemm import (int8_compute_layout,
                                               is_quantized)
from deepspeed_tpu_torch.ops.head_dim import warn_if_padded
from deepspeed_tpu_torch.parallel.tensor_parallel import (gather_tree,
                                                          shard_tree,
                                                          tp_param_specs)
from deepspeed_tpu_torch.telemetry import (MetricRegistry, Tracer,
                                           get_registry)
from deepspeed_tpu_torch.telemetry.compile_watch import watched
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.unported import not_ported
# host checks for an all-done batch every this many decode steps
DONE_CHECK_EVERY = 8
NEG_INF = -1e30


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _bucket(n: int, base: int = 128) -> int:
    """Geometric shape bucket: the smallest ``base * 2**k >= n``."""
    if n <= base:
        return base
    b = base
    while b < n:
        b *= 2
    return b


def _fit_to_budget(need: int, budget: int) -> int:
    """Bucketed cache size for ``need`` tokens under ``budget``: the
    geometric bucket, clamped to the budget when the raw need fits it.
    Returns 0 when even the raw need exceeds the budget."""
    if _round_up(need, 128) > budget:
        return 0
    return min(_bucket(need), budget)


def check_draft_compat(target, draft) -> None:
    """Validate a draft engine against its speculation target: LM heads
    on both sides and interchangeable token ids. Shared by the one-shot
    ``generate_speculative(draft=...)`` path and the paged server's
    ``speculation_draft`` wiring so both reject the same mismatches
    with the same message."""
    if target.model_config.head == "none" or \
            draft.model_config.head == "none":
        raise ValueError("speculative decoding needs LM heads on "
                         "both engines")
    if target.model_config.vocab_size != draft.model_config.vocab_size:
        raise ValueError(
            f"target/draft vocab sizes differ "
            f"({target.model_config.vocab_size} vs "
            f"{draft.model_config.vocab_size}) — token ids must be "
            "interchangeable")


def _categorical(lg: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(lg)``: the Gumbel-max trick, as
    ``jax.random.categorical`` draws."""
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    return torch.argmax(lg - torch.log(-torch.log(u.clamp_min(1e-20))), -1)


def graphs_capture_mesh(mesh, who: str) -> bool:
    """Whether CUDA graphs may capture a step over ``mesh``: yes without
    collectives or over NCCL; over gloo (host collectives) no, and ``who``
    says so once in the log."""
    if mesh is None or comm.capturable():
        return True
    logger.info(f"{who}: the mesh's collectives run on the host (gloo), "
                "which a CUDA graph cannot capture: its steps run eagerly")
    return False


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; asking for CUDA
    without a card is an error, not a quiet move to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False — pass device='cpu' to run on the host")
    return dev


class InferenceEngine:
    """Generation engine over the fused transformer.

    ``model`` is ``(InferenceTransformerConfig, params)``, a bare
    ``InferenceTransformerConfig`` (random weights from a generator seeded
    0), or an HF model (live, or a ``CheckpointModelView``) that the
    policy table converts. Weights move to ``device`` in the engine
    dtype.
    """

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 device=None, mesh=None):
        self.config = config or DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        c = self.config
        if c.injection_policy is not None:
            # checked from the config alone, before any conversion or load
            raise NotImplementedError(
                "custom injection_policy dicts are torch-module surgery "
                "(reference replace_module.py) — register a conversion "
                "policy instead: subclass HFPolicy and decorate with "
                "deepspeed_tpu_torch.module_inject.policies.register_policy")
        # dtype="int8" means int8 weight storage with bf16 activations
        int8 = c.torch_dtype == torch.int8
        self._weight_quant = int8 or c.quant.enabled
        self._act_dtype = torch.bfloat16 if int8 else c.torch_dtype
        if isinstance(model, tuple):
            self.model_config, params = model
        elif isinstance(model, InferenceTransformerConfig):
            self.model_config = model
            params = init_params(
                torch.Generator(device=self.device).manual_seed(0),
                dataclasses.replace(model, dtype=self._act_dtype),
                self.device)
        else:
            # an HF model, live or a CheckpointModelView: the policy table,
            # on the device its tensors lie on
            self.model_config, params = convert_hf_model(
                model, dtype=self._act_dtype)
        # the engine dtype wins over the model config's
        self.model_config = dataclasses.replace(self.model_config,
                                                dtype=self._act_dtype)
        if self.model_config.num_experts > 0:
            raise NotImplementedError(not_ported("MoE layers (_moe_mlp)"))
        if not c.triangular_masking and self.model_config.pre_layer_norm \
                and self.model_config.head != "none":
            raise NotImplementedError(
                "triangular_masking=False on a causal LM (bidirectional "
                "decoding) is not supported; encoder models are already "
                "bidirectional and ignore the flag")
        if c.quant.activation.enabled:
            # w8a8 needs int8 weights: quantized here, or stored so (a
            # serving checkpoint's)
            if not self._weight_quant and not _has_int8(params):
                raise ValueError(
                    "quant.activation.enabled (w8a8 GEMMs) requires int8 "
                    "weight storage — set dtype='int8'/quant.enabled or "
                    "load an int8 serving checkpoint")
            self.model_config = dataclasses.replace(self.model_config,
                                                    int8_compute=True)
        self.mesh = mesh if mesh is not None else self._build_mesh()
        if c.seq_parallel_size > 1:
            if self.mesh is None or mesh_shape(self.mesh)["seq"] <= 1:
                raise ValueError("seq_parallel_size>1 needs a mesh with "
                                 "a 'seq' axis")
            self.model_config = dataclasses.replace(self.model_config,
                                                    seq_shard_kv=True)
        self.tp = self.sp = 1
        if self.mesh is not None:
            tp = c.tp_size
            if self.model_config.kv_heads % tp or \
                    self.model_config.n_head % tp:
                raise ValueError(
                    f"tp_size={tp} must divide n_head="
                    f"{self.model_config.n_head} and kv_heads="
                    f"{self.model_config.kv_heads}")
            set_global_mesh(self.mesh)
            self.tp = mesh_shape(self.mesh)["tensor"]
            self.sp = mesh_shape(self.mesh)["seq"]
        self.params = self._place_params(params)
        tcfg = c.telemetry
        # process-wide registry; telemetry.enabled=false records into a
        # private one, so nothing reaches the process scrape surface
        self.telemetry = get_registry() if tcfg.enabled else MetricRegistry()
        # request-scoped tracing: a generate() call gets a two-level trace
        # (root + dispatch/fetch children) under the server's sampling
        # config
        self.tracer = None
        if tcfg.enabled and tcfg.trace_sample_rate > 0:
            self.tracer = Tracer(
                sample_rate=tcfg.trace_sample_rate,
                ring_capacity=tcfg.trace_ring_capacity,
                seed=tcfg.trace_seed,
                slow_threshold_s=tcfg.trace_slow_threshold_s,
                registry=self.telemetry)
        # the compile watch over generate's programs (JAX's names): an
        # eager program's new signature, or a decode graph's capture
        self._prefill_w = watched(self._prefill_program, "infer_prefill",
                                  registry=self.telemetry)
        self._decode_w = watched(self._decode_program, "infer_decode",
                                 registry=self.telemetry)
        # generate's decode step as a CUDA graph; False runs it eagerly on
        # CUDA too (the control a check compares with). A graph cannot
        # capture a host (gloo) collective: such a mesh runs eagerly
        self._cuda_graphs = self.device.type == "cuda" and \
            graphs_capture_mesh(self.mesh, "InferenceEngine")
        # ((batch, max_seq), dense cache, its decode-step graph or None):
        # the one cache kept between generate calls
        self._kept = None
        # the same for the draft role of generate_speculative, so that an
        # engine that drafts for itself has a second cache
        self._kept_draft = None
        # (K, graph) of the verify chunk over the kept cache
        self._chunk_graph = None
        # profile_model_time: forward() calls timed, read by model_times
        self.model_profile_enabled = False
        self._profile_events = False
        self._model_times: list = []

    def _prefill_program(self, input_ids, lengths, cache: KVCache):
        return prefill(self.params, self.model_config, input_ids, lengths,
                       cache)

    def _decode_program(self, tok, cache: KVCache):
        return decode_step(self.params, self.model_config, tok, cache)[0]

    def _fail_trace(self, tr, exc: BaseException) -> None:
        """Finish a generation trace as an error (always kept)."""
        if tr is not None and tr.root.end is None:
            tr.root.set("error", type(exc).__name__)
            self.tracer.finish(tr, status="error")

    def _record_generate(self, dt: float) -> None:
        self.telemetry.histogram(
            "inference_generate_seconds",
            help="generate()/generate_speculative() call wall time"
        ).observe(dt)
        self.telemetry.counter("inference_generate_calls_total",
                               help="generation calls").inc()

    # ------------------------------------------------------------ setup

    @property
    def kv_heads_local(self) -> int:
        """The KV heads this rank's caches hold (``kv_heads / tp``)."""
        return self.model_config.kv_heads // self.tp

    def _build_mesh(self):
        """A mesh of ``seq = sp_size`` and ``tensor = tp_size`` (tensor
        innermost, JAX's order) over the process group, the rest of the
        ranks on ``data`` (replicas); None for tp = sp = 1."""
        tp, sp = self.config.tp_size, self.config.seq_parallel_size
        if tp <= 1 and sp <= 1:
            return None
        ws = comm.get_world_size()
        if ws < tp * sp:
            raise ValueError(
                f"tp_size={tp} * ep_size=1 * sp_size={sp} but only {ws} "
                "ranks (start one process a rank and call "
                "deepspeed_tpu_torch.init_distributed() first)")
        return mesh_for(MeshConfig(data=-1, seq=sp, tensor=tp))

    def _place_params(self, params):
        """Weights on the device in the activation dtype — an int8 node's
        leaves moved as they are, so its scales stay f32 — then, with
        int8 storage, quantized (per output channel under w8a8), and
        under w8a8 every int8 GEMM's weight stored column-major."""
        def place(x):
            if is_quantized(x):
                return {k: torch.as_tensor(v, device=self.device)
                        for k, v in x.items()}
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if isinstance(x, list):
                return [place(v) for v in x]
            x = torch.as_tensor(x, device=self.device)
            return x.to(self._act_dtype) if x.is_floating_point() else x
        params = place(params)
        if self._weight_quant:
            wq = self.config.quant.weight
            params = GroupQuantizer(
                num_bits=wq.num_bits, group_size=wq.group_size,
                out_mode=self.model_config.int8_compute
            ).quantize_tree(params)
        if self.tp > 1:   # this rank's shard (int8 leaves cut quantized)
            params = shard_tree(params, tp_param_specs(params), self.tp,
                                axis_index("tensor", self.mesh))
        if self.model_config.int8_compute:
            params = int8_compute_layout(params)
        return params

    def _max_out_budget(self, batch: int) -> int:
        """KV-token budget per sequence: explicit ``max_out_tokens``, or —
        with ``'auto'`` — sized from the device's free memory, falling back
        to 1024 where the device reports none."""
        mo = self.config.max_out_tokens
        if mo != "auto":
            return _round_up(int(mo), 128)
        cfg = self.model_config
        # the cache shrinks by the heads over tensor and the positions
        # over seq on each rank
        auto = auto_max_tokens(cfg.n_layer, batch, cfg.kv_heads,
                               cfg.head_dim, dtype=self._act_dtype,
                               shard_factor=self.tp * self.sp,
                               device=self.device)
        return _round_up(1024, 128) if auto is None else auto

    def _make_cache(self, batch: int, max_seq: int,
                    role: str = "main") -> KVCache:
        """The dense cache of ``batch`` rows of ``max_seq`` positions for
        ``role`` (``"main"``, or ``"draft"`` when the engine drafts for
        ``generate_speculative``): the one kept for the role when the
        shape matches (its positions past a row's length hold an earlier
        call's keys, which attention masks as it masks right-pad garbage),
        else a new one that replaces it and its graphs."""
        attr = "_kept" if role == "main" else "_kept_draft"
        kept = getattr(self, attr)
        if kept is not None and kept[0] == (batch, max_seq):
            return kept[1]
        setattr(self, attr, None)   # free the old cache and graphs first
        if role == "main":
            self._chunk_graph = None
        cfg = self.model_config
        warn_if_padded("dense KV cache", cfg.head_dim,
                       self._act_dtype.itemsize, self.device)
        if max_seq % self.sp:
            raise ValueError(f"a cache of {max_seq} positions does not "
                             f"split over sp_size={self.sp}")
        # this rank's heads and, under seq, its block of positions
        cache = init_cache(cfg.n_layer, batch, max_seq // self.sp,
                           self.kv_heads_local, cfg.head_dim,
                           dtype=self._act_dtype, device=self.device)
        setattr(self, attr, ((batch, max_seq), cache, None))
        return cache

    def _decode_fn(self, cache: KVCache):
        """``tok [B] -> logits [B, V]``: one decode step over ``cache``,
        advancing its lengths; on CUDA through the graph kept with the
        cache (made at first use), else eagerly."""
        params, cfg = self.params, self.model_config

        def eager(tok):
            return decode_step(params, cfg, tok, cache)[0]

        def watched_eager(tok):
            return self._decode_w(tok, cache)

        attr = next((a for a in ("_kept", "_kept_draft")
                     if getattr(self, a) is not None
                     and getattr(self, a)[1] is cache), None)
        if not self._cuda_graphs or attr is None:
            return watched_eager
        kept = getattr(self, attr)
        graph = kept[2]
        if graph is None:
            graph = GraphedStep(
                "generate_decode" if attr == "_kept"
                else "generate_draft_decode", eager,
                (torch.zeros(cache.lengths.shape[0], dtype=torch.long,
                             device=self.device),),
                lambda: (cache.k, cache.v, cache.lengths),
                watch=self._decode_w)
            setattr(self, attr, (kept[0], cache, graph))

        def step(tok):
            graph.inputs[0].copy_(tok)
            return graph()
        return step

    def _chunk_fn(self, cache: KVCache, K: int):
        """``tokens [B, K] -> logits [B, K, V]``: the speculative verify
        chunk over ``cache`` (lengths not advanced); on CUDA through a
        graph kept with the main cache (made at first use), else
        eagerly."""
        params, cfg = self.params, self.model_config

        def eager(tokens):
            return decode_chunk(params, cfg, tokens, cache)[0]

        if not self._cuda_graphs or self._kept is None \
                or self._kept[1] is not cache:
            return eager
        if self._chunk_graph is None or self._chunk_graph[0] != K:
            self._chunk_graph = (K, GraphedStep(
                "generate_verify", eager,
                (torch.zeros((cache.lengths.shape[0], K), dtype=torch.long,
                             device=self.device),),
                lambda: (cache.k, cache.v, cache.lengths)))
        graph = self._chunk_graph[1]

        def step(tokens):
            graph.inputs[0].copy_(tokens)
            return graph()
        return step

    # ------------------------------------------------------------ API

    def profile_model_time(self, use_cuda_events: bool = True) -> None:
        """Time every ``forward`` call from now on (JAX
        ``profile_model_time`` :379): with CUDA events on the card, by the
        host clock on the CPU. ``use_cuda_events`` is accepted for
        signature parity, as JAX does."""
        del use_cuda_events
        self.model_profile_enabled = True
        self._profile_events = self.device.type == "cuda"

    def model_times(self) -> list:
        """The collected per-call latencies in seconds; clears on read
        (JAX ``model_times`` :390). Raises when profiling is off."""
        if not self.model_profile_enabled:
            raise AssertionError("model profiling is not enabled — call "
                                 "profile_model_time() first")
        out, self._model_times = self._model_times, []

        def seconds(t):
            if isinstance(t, float):
                return t
            t[1].synchronize()
            return t[0].elapsed_time(t[1]) / 1e3
        return [seconds(t) for t in out]

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask=None):
        """Encoder forward (the post-LN BERT family) → hidden states
        ``[B, T, E]``, or full-sequence logits ``[B, T, V]`` for causal
        models (hidden states where the model has no LM head)."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(np.asarray(attention_mask),
                                             device=self.device)
        ev = t0 = None
        if self.model_profile_enabled and self._profile_events:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        elif self.model_profile_enabled:
            t0 = time.perf_counter()
        fwd = (causal_forward if self.model_config.pre_layer_norm
               else encoder_forward)
        out = fwd(self.params, self.model_config, ids,
                  attention_mask=attention_mask)
        if ev is not None:
            ev[1].record()
            self._model_times.append(ev)
        elif t0 is not None:
            self._model_times.append(time.perf_counter() - t0)
        return out

    __call__ = forward

    def _check_schedulable(self, B: int, max_new_tokens: int) -> None:
        if "max_batch_size" in self.config.model_fields_set and \
                B > self.config.max_batch_size:
            raise ValueError(
                f"batch {B} exceeds the configured max_batch_size="
                f"{self.config.max_batch_size}")
        if max_new_tokens < self.config.min_out_tokens:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} is below "
                f"min_out_tokens={self.config.min_out_tokens}")

    @staticmethod
    def _assemble_output(ids, lengths, out_np, n_np) -> list:
        """Prompt + generated tokens per row, as lists."""
        return [np.asarray(ids[b, :lengths[b]]).tolist()
                + out_np[b, :int(n_np[b])].tolist()
                for b in range(len(lengths))]

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, num_beams: int = 1,
                 length_penalty: float = 1.0,
                 repetition_penalty: float = 1.0,
                 min_new_tokens: int = 0,
                 eos_token_id: Optional[int] = None,
                 attention_mask=None, seed: int = 0,
                 assistant_model: Optional["InferenceEngine"] = None
                 ) -> list:
        """Greedy/sampled generation, or beam search (``num_beams > 1``).
        ``input_ids``: a list of token lists, or a right-padded ``[B, T]``
        array with its HF-style ``attention_mask``. Returns a list of token
        lists (prompt + generated). Sampling draws from a
        ``torch.Generator`` seeded with ``seed``. ``assistant_model`` is
        HF's spelling of :meth:`generate_speculative` with that draft."""
        if self.model_config.head == "none":
            raise ValueError("this model has no LM head — use forward() "
                             "for hidden states")
        if assistant_model is not None:
            if (top_k or top_p or num_beams > 1 or min_new_tokens or
                    float(repetition_penalty) != 1.0):
                raise ValueError(
                    "assistant_model composes with plain greedy/sampled "
                    "decoding only (no top-k/top-p/beams/penalties/"
                    "min_new_tokens) — see generate_speculative")
            return self.generate_speculative(
                input_ids, assistant_model, max_new_tokens,
                temperature=temperature, eos_token_id=eos_token_id,
                attention_mask=attention_mask, seed=seed)
        t0 = time.perf_counter()
        ids, lengths = _pad_batch(input_ids, attention_mask)
        B, T = ids.shape
        if max_new_tokens <= 0:
            self._record_generate(time.perf_counter() - t0)
            return [np.asarray(ids[b, :lengths[b]]).tolist()
                    for b in range(B)]
        self._check_schedulable(B, max_new_tokens)
        need = int(lengths.max()) + max_new_tokens
        budget = self._max_out_budget(B * max(num_beams, 1))
        max_seq = _fit_to_budget(need, budget)
        if not max_seq:
            raise ValueError(
                f"prompt + max_new_tokens needs a {_round_up(need, 128)}-"
                f"token KV cache but the budget is {budget} tokens "
                f"(max_out_tokens={self.config.max_out_tokens!r}; set "
                "max_out_tokens='auto' to size it from free memory)")
        if num_beams > 1:
            if float(temperature) > 0.0 or top_k or top_p:
                raise ValueError(
                    "beam search composes with greedy scoring only "
                    "(sampling+beams is not supported, matching HF's "
                    "separate code paths)")
            if float(repetition_penalty) != 1.0 or min_new_tokens:
                raise NotImplementedError(
                    "repetition_penalty/min_new_tokens are wired into "
                    "the greedy/sampled loop, not beam search")
        else:
            if float(repetition_penalty) <= 0.0:
                raise ValueError("repetition_penalty must be strictly "
                                 "positive; 1.0 disables it")
            if (int(top_k) > 0 or float(top_p) > 0.0) and \
                    float(temperature) <= 0.0:
                raise ValueError(
                    "top_k/top_p are sampling filters — pass temperature>0; "
                    "temperature=0 means greedy and would silently ignore "
                    "them")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        # two-level request trace: root + dispatch/fetch children. The
        # children time the dispatch intervals and the final fetch; a
        # failure past this point finishes the trace as an error
        tr = None
        if self.tracer is not None:
            tr = self.tracer.start_trace(
                "generate", rows=B, max_new_tokens=max_new_tokens,
                prompt_tokens=int(lengths.sum()))
        try:
            with torch.inference_mode():
                if num_beams > 1:
                    # every beam shares the prefix: a tiled prefill, one
                    # row a beam
                    cache = self._make_cache(B * num_beams, max_seq)
                    sp = tr.begin("dispatch", beams=num_beams) if tr \
                        else None
                    logits, cache = self._prefill_w(
                        torch.as_tensor(np.repeat(ids, num_beams, axis=0),
                                        dtype=torch.long,
                                        device=self.device),
                        torch.as_tensor(np.repeat(lengths, num_beams,
                                                  axis=0),
                                        device=self.device), cache)
                    out, n_gen = self._beam_loop(
                        logits, cache, lengths, max_new_tokens, num_beams,
                        eos, float(length_penalty))
                else:
                    cache = self._make_cache(B, max_seq)
                    sp = tr.begin("prefill_dispatch", cache_len=max_seq) \
                        if tr else None
                    logits, cache = self._prefill_w(
                        torch.as_tensor(ids, dtype=torch.long,
                                        device=self.device),
                        torch.as_tensor(lengths, device=self.device),
                        cache)
                    if tr:
                        tr.end_span(sp)
                        sp = tr.begin("decode_dispatch")
                    out, n_gen = self._generate_loop(
                        logits, cache, ids, lengths, max_new_tokens,
                        float(temperature), int(top_k), float(top_p), eos,
                        float(repetition_penalty), int(min_new_tokens),
                        seed)
                if tr:
                    tr.end_span(sp)
                    sp = tr.begin("fetch")
                out, n_gen = out.cpu().numpy(), n_gen.cpu().numpy()
                if tr:
                    tr.end_span(sp)
                    self.tracer.finish(tr)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            self._fail_trace(tr, e)
            raise
        self._record_generate(time.perf_counter() - t0)
        return self._assemble_output(ids, lengths, out, n_gen)

    def generate_speculative(self, input_ids,
                             draft: Optional["InferenceEngine"] = None,
                             max_new_tokens: int = 32,
                             draft_tokens: int = 4, *,
                             temperature: float = 0.0,
                             eos_token_id: Optional[int] = None,
                             attention_mask=None, seed: int = 0) -> list:
        """Speculative decoding (JAX ``generate_speculative`` :623). Each
        round the draft proposes ``draft_tokens - 1`` tokens one after the
        other, and the target scores the whole candidate chunk in ONE
        :func:`decode_chunk` forward, committing 1 to ``draft_tokens``
        tokens.

        ``temperature == 0``: greedy acceptance, the tokens of greedy
        ``generate``. ``temperature > 0``: rejection sampling (Leviathan et
        al.; Chen et al.): proposal ``d_i`` is accepted with probability
        ``min(1, p_t(d_i)/p_d(d_i))`` and the first rejection resampled
        from ``norm(max(p_t - p_d, 0))``, so the committed stream is
        distributed as sampling from the target alone. ``draft=None``:
        prompt lookup, greedy only — the proposals are the tokens that
        followed the latest earlier occurrence of the current bigram in
        the row's own history.

        The verify chunk and the draft's decode steps run as CUDA graphs on
        the card; the rounds are a host loop that reads one flag a round,
        a round late, so it never waits for the device.
        ``last_speculative_stats`` holds
        the rounds (verify forwards), the tokens and their ratio."""
        t0 = time.perf_counter()
        if draft_tokens < 2:
            raise ValueError(f"draft_tokens must be >= 2, got "
                             f"{draft_tokens} (1 draft proposal minimum)")
        if draft is not None:
            check_draft_compat(self, draft)
            if draft.device != self.device:
                raise ValueError(f"the draft engine is on {draft.device}, "
                                 f"the target on {self.device}")
        elif self.model_config.head == "none":
            raise ValueError("speculative decoding needs LM heads on "
                             "both engines")
        if draft is None and float(temperature) > 0.0:
            raise NotImplementedError(
                "prompt-lookup speculative decoding (draft=None) is "
                "greedy-only: its proposals are deterministic, so "
                "rejection sampling degenerates — pass a draft engine "
                "for sampled speculation")
        ids, lengths = _pad_batch(input_ids, attention_mask)
        B, T = ids.shape
        if max_new_tokens <= 0:
            self._record_generate(time.perf_counter() - t0)
            return [np.asarray(ids[b, :lengths[b]]).tolist()
                    for b in range(B)]
        self._check_schedulable(B, max_new_tokens)
        K = int(draft_tokens)
        # margin: the draft runs K appends past the last committed token,
        # and the final round may overshoot max_new by up to K
        need = int(lengths.max()) + max_new_tokens + 2 * K
        max_seq = None
        for eng in ((self,) if draft is None else (self, draft)):
            budget = eng._max_out_budget(B)
            fit = _fit_to_budget(need, budget)
            if not fit:
                raise ValueError(
                    f"prompt + max_new_tokens + draft margin needs a "
                    f"{_round_up(need, 128)}-token KV cache but the "
                    f"{'draft' if eng is draft else 'target'} budget is "
                    f"{budget} tokens (max_out_tokens="
                    f"{eng.config.max_out_tokens!r})")
            max_seq = fit if max_seq is None else min(max_seq, fit)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        with torch.inference_mode():
            ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
            len_t = torch.as_tensor(lengths, device=self.device)
            cache_t = self._make_cache(B, max_seq)
            logits_t, cache_t = prefill(self.params, self.model_config,
                                        ids_t, len_t, cache_t)
            if draft is None:
                out, n_gen, rounds = self._lookup_loop(
                    logits_t, cache_t, ids_t, len_t, max_new_tokens, K, eos)
            else:
                cache_d = draft._make_cache(B, max_seq, role="draft")
                prefill(draft.params, draft.model_config, ids_t, len_t,
                        cache_d)
                out, n_gen, rounds = self._speculative_loop(
                    draft, logits_t, cache_t, cache_d, max_new_tokens, K,
                    eos, float(temperature), seed)
            out_np = out[:, :max_new_tokens].cpu().numpy()
            n_np = np.minimum(n_gen.cpu().numpy(), max_new_tokens)
            rounds = int(rounds)
        total = int(n_np.sum())
        self.last_speculative_stats = {
            "rounds": rounds, "tokens": total,
            "draft": "prompt-lookup" if draft is None else "model",
            "tokens_per_round": round(total / max(rounds, 1), 3)}
        self._record_generate(time.perf_counter() - t0)
        return self._assemble_output(ids, lengths, out_np, n_np)

    @staticmethod
    def _round_gate(done, n_gen, max_new_tokens, rounds):
        """JAX's loop condition for one round, on the device: whether any
        row is live. Counts the round when it is, and returns the ``done``
        the round's commit starts from (every row, when none is live, so
        a round run past the end changes nothing), and the flag's copy on
        its way to the host: the loop reads it one round later, so the
        host never waits for the round it has just enqueued and runs at
        most one round past the end."""
        go = (~done & (n_gen < max_new_tokens)).any()
        rounds += go.long()
        return TokenFetch(go), done | ~go

    def _lookup_loop(self, logits, cache, ids, lengths, max_new_tokens, K,
                     eos):
        """Prompt-lookup rounds (JAX ``_lookup_loop`` :735): proposals
        from the row's own history buffer, verified like a draft's."""
        B, T = ids.shape
        dev = self.device
        S = T + max_new_tokens + 2 * K
        ar = torch.arange(B, device=dev)
        iota = torch.arange(K, device=dev)[None, :]
        hist = torch.zeros((B, S), dtype=torch.long, device=dev)
        hist[:, :T] = ids
        hlen = lengths.long().clone()
        cur = torch.argmax(logits, -1)                   # token 0
        hist[ar, hlen] = cur
        hlen += 1
        out = torch.zeros((B, max_new_tokens + K), dtype=torch.long,
                          device=dev)
        out[:, 0] = cur
        n_gen = torch.ones((B,), dtype=torch.long, device=dev)
        done = cur == eos
        rounds = torch.zeros((), dtype=torch.long, device=dev)
        verify = self._chunk_fn(cache, K)
        go = None
        for _ in range(max_new_tokens - 1):
            if go is not None and not go.wait():
                break
            go, done = self._round_gate(done, n_gen, max_new_tokens, rounds)
            props = lookup_proposals(hist, hlen, cur, K)   # [B, K-1]
            t_toks = torch.argmax(
                verify(torch.cat([cur[:, None], props], 1)), -1)
            m, correction, committed = greedy_accept(t_toks, props, K)
            out, n_gen, done, adv, active = commit_speculative_block(
                committed, m, done, n_gen, out, eos, K, max_new_tokens)
            cache.lengths.add_(adv.int())
            # the history leads the cache by the pending token: it also
            # takes the correction
            hcols = (hlen[:, None] + iota).clamp(0, S - 1)
            hmask = (iota <= m[:, None]) & active[:, None]
            hist[ar[:, None], hcols] = torch.where(
                hmask, committed, hist[ar[:, None], hcols])
            hlen += adv
            cur = torch.where(active, correction[:, 0], cur)
        return out, n_gen, rounds

    def _speculative_loop(self, draft, logits, cache_t, cache_d,
                          max_new_tokens, K, eos, temperature, seed):
        """Draft → verify → commit rounds (JAX ``_speculative_loop``
        :805), greedy or by rejection sampling."""
        B = logits.shape[0]
        dev = self.device
        sampled = temperature > 0.0
        temp = max(temperature, 1e-6)
        gen = torch.Generator(device=dev).manual_seed(seed) if sampled \
            else None
        iota = torch.arange(K, device=dev)[None, :]
        ar = torch.arange(B, device=dev)
        cur = _categorical(logits / temp, gen) if sampled \
            else torch.argmax(logits, -1)
        out = torch.zeros((B, max_new_tokens + K), dtype=torch.long,
                          device=dev)
        out[:, 0] = cur
        n_gen = torch.ones((B,), dtype=torch.long, device=dev)
        done = cur == eos
        rounds = torch.zeros((), dtype=torch.long, device=dev)
        draft_step = draft._decode_fn(cache_d)
        verify = self._chunk_fn(cache_t, K)
        go = None
        for _ in range(max_new_tokens - 1):
            if go is not None and not go.wait():
                break
            go, done = self._round_gate(done, n_gen, max_new_tokens, rounds)
            # 1) K draft steps propose d1..d_{K-1}; the K-th only writes
            # d_{K-1}'s k/v, so a full accept leaves no hole in the cache
            tok, drafts, pds = cur, [], []
            for i in range(K):
                lg = draft_step(tok)
                if sampled:
                    tok = _categorical(lg / temp, gen)
                    if i < K - 1:
                        pds.append(torch.softmax(lg / temp, -1))
                else:
                    tok = torch.argmax(lg, -1)
                drafts.append(tok)
            drafts = torch.stack(drafts, 1)              # [B, K]
            props = drafts[:, :K - 1]
            # 2) the target verifies [cur, d1..d_{K-1}] in one forward
            lg_t = verify(torch.cat([cur[:, None], props], 1))
            if sampled:
                # accept d_{i+1} while u_i < pt_i(d_{i+1}) / pd_i(d_{i+1});
                # the correction comes from the residual norm(max(pt - pd,
                # 0)) after a rejection, from pt at the bonus position
                pt = torch.softmax(lg_t / temp, -1)       # [B, K, V]
                pd = torch.stack(pds, 1)                  # [B, K-1, V]
                p_t_at = torch.gather(pt[:, :K - 1], 2, props[..., None])[
                    ..., 0]
                p_d_at = torch.gather(pd, 2, props[..., None])[..., 0]
                u = torch.rand((B, K - 1), generator=gen, device=dev)
                accept = u * p_d_at.clamp_min(1e-30) < p_t_at
                m = torch.argmax(torch.cat(
                    [~accept, torch.ones((B, 1), dtype=torch.bool,
                                         device=dev)], 1).int(), 1)
                dists = torch.cat([(pt[:, :K - 1] - pd).clamp_min(0.0),
                                   pt[:, K - 1:]], 1)
                correction = _categorical(
                    torch.log(dists[ar, m] + 1e-30), gen)[:, None]
                committed = torch.where(iota < m[:, None], drafts,
                                        correction)
            else:
                m, correction, committed = greedy_accept(
                    torch.argmax(lg_t, -1), props, K)
            out, n_gen, done, adv, active = commit_speculative_block(
                committed, m, done, n_gen, out, eos, K, max_new_tokens)
            # the context gains [cur, d1..dm] on active rows; the draft
            # steps back from its K appends to the same point
            cache_t.lengths.add_(adv.int())
            cache_d.lengths.add_((adv - K).int())
            cur = torch.where(active, correction[:, 0], cur)
        return out, n_gen, rounds

    def _beam_loop(self, logits, cache, prompt_lens, max_new_tokens, nb,
                   eos, length_penalty):
        """Beam search (JAX ``_beam_loop`` :941). Beams are seeded with the
        top-``nb`` first tokens of beam 0; a finished beam stays frozen,
        emitting pad 0 at an unchanged score; each step takes the top
        ``nb`` of ``nb * V`` candidates and reorders the beams' cache rows,
        tokens and counts by parent. The best beam ranks by ``score /
        (prompt_len + n_gen) ** length_penalty``. Returns the best beam's
        tokens and counts ``[B, max_new]``, ``[B]`` as numpy."""
        Bnb, V = logits.shape
        B = Bnb // nb
        dev = self.device
        logp0 = torch.log_softmax(logits.float(), -1).reshape(B, nb, V)
        scores, tok = torch.topk(logp0[:, 0], nb)           # [B, nb]
        out = torch.zeros((B, nb, max_new_tokens), dtype=torch.long,
                          device=dev)
        out[:, :, 0] = tok
        finished = tok == eos
        n_gen = torch.ones((B, nb), dtype=torch.long, device=dev)
        pad_row = torch.full((V,), float("-inf"), device=dev)
        pad_row[0] = 0.0
        base = (torch.arange(B, device=dev) * nb)[:, None]
        step_fn = self._decode_fn(cache)
        # the cache rows to reorder: positions below the longest row
        hi = int(prompt_lens.max())
        for step in range(1, max_new_tokens):
            if step % DONE_CHECK_EVERY == 0 and bool(finished.all()):
                break
            logp = torch.log_softmax(step_fn(tok.reshape(-1)).float(),
                                     -1).reshape(B, nb, V)
            logp = torch.where(finished[:, :, None], pad_row, logp)
            cand = scores[:, :, None] + logp                 # [B, nb, V]
            scores, flat = torch.topk(cand.reshape(B, nb * V), nb)
            parent = flat // V                               # [B, nb]
            tok = flat % V
            rows = (base + parent).reshape(-1)
            hi = min(hi + 1, cache.max_seq)
            for x in (cache.k, cache.v):
                x[:, :, :hi].copy_(x[:, :, :hi].index_select(1, rows))
            cache.lengths.copy_(cache.lengths.index_select(0, rows))
            out = torch.gather(out, 1, parent[:, :, None].expand_as(out))
            finished = torch.gather(finished, 1, parent)
            n_gen = torch.gather(n_gen, 1, parent)
            out[:, :, step] = torch.where(finished, 0, tok)
            n_gen += (~finished).long()
            finished = finished | (tok == eos)
        full_len = (torch.as_tensor(prompt_lens, device=dev)[:, None]
                    + n_gen).float()
        best = torch.argmax(scores / full_len ** length_penalty, 1)  # [B]
        rows = torch.arange(B, device=dev)
        return out[rows, best], n_gen[rows, best]

    def _generate_loop(self, logits, cache, ids, lengths, max_new_tokens,
                       temperature, top_k, top_p, eos, rep, min_new, seed):
        """The decode loop of ``deepspeed_tpu``'s ``_generate_loop``
        (engine.py:1022), with its logit adjustments: repetition penalty,
        min_new_tokens, temperature, top-k, top-p and EOS."""
        B, V = logits.shape
        dev = self.device
        sampled = temperature > 0.0
        gen = torch.Generator(device=dev).manual_seed(seed) if sampled \
            else None
        rows = torch.arange(B, device=dev)
        step_fn = self._decode_fn(cache)
        presence = None
        if rep != 1.0:
            # HF's repetition penalty scores every prior token, prompt
            # included; pads beyond lengths are not tokens
            presence = torch.zeros((B, V), dtype=torch.bool, device=dev)
            for b in range(B):
                presence[b, torch.as_tensor(ids[b, :lengths[b]],
                                            dtype=torch.long)] = True

        def adjust(lg, min_left):
            if presence is not None:
                lg = torch.where(presence,
                                 torch.where(lg > 0, lg / rep, lg * rep), lg)
            if min_left > 0 and eos >= 0:   # HF MinNewTokens: no EOS yet
                lg = lg.clone()
                lg[:, eos] = float("-inf")
            return lg

        def select(lg):
            if not sampled:
                return torch.argmax(lg, -1)
            lg = lg / temperature
            if top_k > 0:
                kth = torch.topk(lg, min(top_k, V), dim=-1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, NEG_INF)
            if top_p > 0.0:
                # nucleus: keep the smallest descending prefix with mass
                # >= top_p (the top-1 token always)
                srt = torch.sort(lg, dim=-1, descending=True).values
                probs = torch.softmax(srt, -1)
                keep = torch.cumsum(probs, -1) - probs < top_p
                cutoff = srt.masked_fill(~keep, float("-inf")).amax(
                    -1, keepdim=True)
                lg = lg.masked_fill(lg < cutoff, NEG_INF)
            return _categorical(lg, gen)

        tok = select(adjust(logits, min_new))
        if presence is not None:
            presence[rows, tok] = True
        out = torch.zeros((B, max_new_tokens), dtype=torch.long, device=dev)
        out[:, 0] = tok
        done = tok == eos
        n_gen = torch.ones((B,), dtype=torch.int32, device=dev)
        for step in range(1, max_new_tokens):
            if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            nxt = select(adjust(step_fn(tok), min_new - step))
            if presence is not None:
                presence[rows, nxt] = True
            out[:, step] = torch.where(done, 0, nxt)
            n_gen += (~done).int()
            done = done | (nxt == eos)
            tok = nxt
        return out, n_gen



def _pad_batch(input_ids, attention_mask=None):
    """Right-pad to a geometric bucket (``_bucket``)."""
    if isinstance(input_ids, (list, tuple)):
        lengths = np.asarray([len(r) for r in input_ids], np.int32)
        T = _bucket(max(int(lengths.max()), 1))
        ids = np.zeros((len(input_ids), T), np.int32)
        for i, row in enumerate(input_ids):
            ids[i, :len(row)] = row
        return ids, lengths
    ids = np.asarray(input_ids, np.int32)
    if attention_mask is not None:
        lengths = np.asarray(attention_mask).sum(-1).astype(np.int32)
    else:
        lengths = np.full((ids.shape[0],), ids.shape[1], np.int32)
    if ids.shape[1] != _bucket(ids.shape[1]):
        padded = np.zeros((ids.shape[0], _bucket(ids.shape[1])), np.int32)
        padded[:, :ids.shape[1]] = ids
        ids = padded
    return ids, lengths


def _has_int8(tree) -> bool:
    """Whether a param tree holds an int8 node."""
    if is_quantized(tree):
        return True
    if isinstance(tree, dict):
        tree = list(tree.values())
    return isinstance(tree, (list, tuple)) and any(map(_has_int8, tree))


def _flatten_tree(tree, prefix=""):
    """``{'layers/0/attn/wq': leaf}``: ``/``-joined dict keys and list
    indices, the JAX package's ``flatten_with_names`` (an int8 node's
    leaves as ``.../wq/q`` and ``.../wq/scale`` or ``.../wq/oscale``)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten_tree(v, name + "/"))
        else:
            out[name] = v
    return out


def save_serving_checkpoint(engine: InferenceEngine, path: str) -> None:
    """Write the engine's converted serving state to disk (the reference's
    ``save_mp_checkpoint_path``), in the JAX package's layout, so either
    package loads the other's:

        <path>/serving_config.json   InferenceTransformerConfig fields
        <path>/serving.safetensors   flat '/'-joined param leaves

    Over ``tensor`` ranks the leaves are gathered whole (every rank calls
    it) and the first rank writes."""
    import json
    import os

    from deepspeed_tpu_torch.utils.safetensors_io import save_file

    params = engine.params
    if engine.tp > 1:
        params = gather_tree(params, tp_param_specs(params))
    if comm.get_rank() != 0:
        comm.barrier()
        return
    flat = _flatten_tree(params)
    os.makedirs(path, exist_ok=True)
    cfg = dataclasses.asdict(engine.model_config)
    cfg["dtype"] = str(engine.model_config.dtype).replace("torch.", "")
    for k, v in list(cfg.items()):
        if isinstance(v, tuple):
            cfg[k] = list(v)
    with open(os.path.join(path, "serving_config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_file(flat, os.path.join(path, "serving.safetensors"))
    comm.barrier()


def load_serving_checkpoint(path: str,
                            config: Optional[DeepSpeedInferenceConfig]
                            = None, device=None) -> InferenceEngine:
    """Rebuild an :class:`InferenceEngine` from ``save_serving_checkpoint``
    output (this package's or the JAX package's) — no conversion and no
    requantization: int8 nodes reload as stored."""
    import json
    import os

    from deepspeed_tpu_torch.utils.safetensors_io import load_file

    with open(os.path.join(path, "serving_config.json")) as f:
        raw = json.load(f)
    raw["dtype"] = getattr(torch, raw["dtype"])
    for k in ("local_windows", "moe_layers"):
        if raw.get(k) is not None:
            raw[k] = tuple(raw[k])
    model_cfg = InferenceTransformerConfig(**raw)

    # rebuild the nested tree from '/'-joined names
    tree: dict = {}
    for name, t in load_file(os.path.join(path, "serving.safetensors")
                             ).items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node
    return InferenceEngine((model_cfg, listify(tree)), config, device=device)
