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

:func:`save_serving_checkpoint` / :func:`load_serving_checkpoint` write and
read the JAX package's serving layout (a config JSON and one safetensors
file), in both directions.

Not in this slice (ROADMAP.md queue C): beams, speculative decoding,
HF conversion and checkpoint loading, int8 weights, meshes (TP/EP/SP), MoE,
the encoder path and request tracing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
from deepspeed_tpu_torch.inference.kv_cache import (KVCache, auto_max_tokens,
                                                    init_cache)
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, causal_forward, decode_step, init_params,
    prefill)
from deepspeed_tpu_torch.ops.head_dim import warn_if_padded
from deepspeed_tpu_torch.telemetry import MetricRegistry, get_registry

_LATER = "is not ported to deepspeed_tpu_torch yet (ROADMAP.md queue C)"
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

    ``model`` is ``(InferenceTransformerConfig, params)`` or a bare
    ``InferenceTransformerConfig`` (random weights from a generator seeded
    0). Weights move to ``device`` in the engine dtype.
    """

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 device=None):
        self.config = config or DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        c = self.config
        if c.injection_policy is not None:
            raise NotImplementedError(f"injection_policy {_LATER}")
        if c.torch_dtype == torch.int8 or c.quant.enabled:
            raise NotImplementedError(f"int8 weights and w8a8 {_LATER}")
        if c.tp_size > 1 or c.seq_parallel_size > 1:
            raise NotImplementedError(
                f"tensor/sequence-parallel meshes {_LATER}")
        self._act_dtype = c.torch_dtype
        if isinstance(model, tuple):
            self.model_config, params = model
        elif isinstance(model, InferenceTransformerConfig):
            self.model_config = model
            params = init_params(
                torch.Generator(device=self.device).manual_seed(0),
                dataclasses.replace(model, dtype=self._act_dtype),
                self.device)
        else:
            raise NotImplementedError(
                f"HF model conversion (module_inject/policies.py) {_LATER}; "
                "pass (InferenceTransformerConfig, params)")
        # the engine dtype wins over the model config's
        self.model_config = dataclasses.replace(self.model_config,
                                                dtype=self._act_dtype)
        if self.model_config.num_experts > 0:
            raise NotImplementedError(f"MoE layers (_moe_mlp) {_LATER}")
        if not self.model_config.pre_layer_norm:
            raise NotImplementedError(f"the encoder path {_LATER}")
        if not c.triangular_masking and self.model_config.head != "none":
            raise NotImplementedError(
                "triangular_masking=False on a causal LM (bidirectional "
                "decoding) is not supported")
        self.params = self._place_params(params)
        tcfg = c.telemetry
        if tcfg.enabled and tcfg.trace_sample_rate > 0:
            raise NotImplementedError(f"request tracing {_LATER}")
        # process-wide registry; telemetry.enabled=false records into a
        # private one, so nothing reaches the process scrape surface
        self.telemetry = get_registry() if tcfg.enabled else MetricRegistry()
        # generate's decode step as a CUDA graph; False runs it eagerly on
        # CUDA too (the control a check compares with)
        self._cuda_graphs = self.device.type == "cuda"
        # ((batch, max_seq), dense cache, its decode-step graph or None):
        # the one cache kept between generate calls
        self._kept = None

    def _record_generate(self, dt: float) -> None:
        self.telemetry.histogram(
            "inference_generate_seconds",
            help="generate()/generate_speculative() call wall time"
        ).observe(dt)
        self.telemetry.counter("inference_generate_calls_total",
                               help="generation calls").inc()

    # ------------------------------------------------------------ setup

    def _place_params(self, params):
        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if isinstance(x, list):
                return [place(v) for v in x]
            x = torch.as_tensor(x, device=self.device)
            return x.to(self._act_dtype) if x.is_floating_point() else x
        return place(params)

    def _max_out_budget(self, batch: int) -> int:
        """KV-token budget per sequence: explicit ``max_out_tokens``, or —
        with ``'auto'`` — sized from the device's free memory, falling back
        to 1024 where the device reports none."""
        mo = self.config.max_out_tokens
        if mo != "auto":
            return _round_up(int(mo), 128)
        cfg = self.model_config
        auto = auto_max_tokens(cfg.n_layer, batch, cfg.kv_heads,
                               cfg.head_dim, dtype=self._act_dtype,
                               device=self.device)
        return _round_up(1024, 128) if auto is None else auto

    def _make_cache(self, batch: int, max_seq: int) -> KVCache:
        """The dense cache of ``batch`` rows of ``max_seq`` positions: the
        kept one when the shape matches (its positions past a row's length
        hold an earlier call's keys, which attention masks as it masks
        right-pad garbage), else a new one that replaces it and its
        graph."""
        if self._kept is not None and self._kept[0] == (batch, max_seq):
            return self._kept[1]
        self._kept = None   # free the old cache and graph first
        cfg = self.model_config
        warn_if_padded("dense KV cache", cfg.head_dim,
                       self._act_dtype.itemsize, self.device)
        cache = init_cache(cfg.n_layer, batch, max_seq, cfg.kv_heads,
                           cfg.head_dim, dtype=self._act_dtype,
                           device=self.device)
        self._kept = ((batch, max_seq), cache, None)
        return cache

    def _decode_fn(self, cache: KVCache):
        """``tok [B] -> logits [B, V]``: one decode step over ``cache``,
        advancing its lengths; on CUDA through the graph kept with the
        cache (made at first use), else eagerly."""
        params, cfg = self.params, self.model_config

        def eager(tok):
            return decode_step(params, cfg, tok, cache)[0]

        kept = self._kept
        if not self._cuda_graphs or kept is None or kept[1] is not cache:
            return eager
        graph = kept[2]
        if graph is None:
            graph = GraphedStep(
                "generate_decode", eager,
                (torch.zeros(cache.lengths.shape[0], dtype=torch.long,
                             device=self.device),),
                lambda: (cache.k, cache.v, cache.lengths))
            self._kept = (kept[0], cache, graph)

        def step(tok):
            graph.inputs[0].copy_(tok)
            return graph()
        return step

    # ------------------------------------------------------------ API

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask=None):
        """Full-sequence logits ``[B, T, V]`` for causal models."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(np.asarray(attention_mask),
                                             device=self.device)
        return causal_forward(self.params, self.model_config, ids,
                              attention_mask=attention_mask)

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
                 assistant_model=None) -> list:
        """Greedy/sampled generation. ``input_ids``: a list of token lists,
        or a right-padded ``[B, T]`` array with its HF-style
        ``attention_mask``. Returns a list of token lists (prompt +
        generated). Sampling draws from a ``torch.Generator`` seeded with
        ``seed``."""
        del length_penalty   # beam search only
        if self.model_config.head == "none":
            raise ValueError("this model has no LM head — use forward() "
                             "for hidden states")
        if assistant_model is not None:
            raise NotImplementedError(f"speculative decoding {_LATER}")
        if num_beams > 1:
            raise NotImplementedError(f"beam search (_beam_loop) {_LATER}")
        t0 = time.perf_counter()
        ids, lengths = _pad_batch(input_ids, attention_mask)
        B, T = ids.shape
        if max_new_tokens <= 0:
            self._record_generate(time.perf_counter() - t0)
            return [np.asarray(ids[b, :lengths[b]]).tolist()
                    for b in range(B)]
        self._check_schedulable(B, max_new_tokens)
        need = int(lengths.max()) + max_new_tokens
        budget = self._max_out_budget(B)
        max_seq = _fit_to_budget(need, budget)
        if not max_seq:
            raise ValueError(
                f"prompt + max_new_tokens needs a {_round_up(need, 128)}-"
                f"token KV cache but the budget is {budget} tokens "
                f"(max_out_tokens={self.config.max_out_tokens!r}; set "
                "max_out_tokens='auto' to size it from free memory)")
        if float(repetition_penalty) <= 0.0:
            raise ValueError("repetition_penalty must be strictly positive; "
                             "1.0 disables it")
        if (int(top_k) > 0 or float(top_p) > 0.0) and \
                float(temperature) <= 0.0:
            raise ValueError(
                "top_k/top_p are sampling filters — pass temperature>0; "
                "temperature=0 means greedy and would silently ignore them")
        with torch.inference_mode():
            cache = self._make_cache(B, max_seq)
            logits, cache = prefill(
                self.params, self.model_config,
                torch.as_tensor(ids, dtype=torch.long, device=self.device),
                torch.as_tensor(lengths, device=self.device), cache)
            out, n_gen = self._generate_loop(
                logits, cache, ids, lengths, max_new_tokens,
                float(temperature), int(top_k), float(top_p),
                -1 if eos_token_id is None else int(eos_token_id),
                float(repetition_penalty), int(min_new_tokens), seed)
        self._record_generate(time.perf_counter() - t0)
        return self._assemble_output(ids, lengths, out, n_gen)

    def generate_speculative(self, *args, **kwargs):
        raise NotImplementedError(f"generate_speculative {_LATER}")

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
            # Gumbel-max draw, as jax.random.categorical
            u = torch.rand(lg.shape, generator=gen, device=dev)
            return torch.argmax(lg - torch.log(-torch.log(
                u.clamp_min(1e-20))), -1)

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
        return out.cpu().numpy(), n_gen.cpu().numpy()



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


def _flatten_tree(tree, prefix=""):
    """``{'layers/0/attn/wq': leaf}``: ``/``-joined dict keys and list
    indices, the JAX package's ``flatten_with_names``."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, dict) and set(v) == {"q", "scale"}:
            raise NotImplementedError(
                f"int8 weight leaves ({name}: {{q, scale}}) in a serving "
                f"checkpoint {_LATER[:-1]}, A4)")
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
    """
    import json
    import os

    from deepspeed_tpu_torch.utils.safetensors_io import save_file

    flat = _flatten_tree(engine.params)
    os.makedirs(path, exist_ok=True)
    cfg = dataclasses.asdict(engine.model_config)
    cfg["dtype"] = str(engine.model_config.dtype).replace("torch.", "")
    for k, v in list(cfg.items()):
        if isinstance(v, tuple):
            cfg[k] = list(v)
    with open(os.path.join(path, "serving_config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    save_file(flat, os.path.join(path, "serving.safetensors"))


def load_serving_checkpoint(path: str,
                            config: Optional[DeepSpeedInferenceConfig]
                            = None, device=None) -> InferenceEngine:
    """Rebuild an :class:`InferenceEngine` from ``save_serving_checkpoint``
    output (this package's or the JAX package's) — no conversion."""
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

    def listify(node, name=""):
        if isinstance(node, dict):
            if set(node) == {"q", "scale"}:
                raise NotImplementedError(
                    f"int8 weight leaves ({name}: {{q, scale}}) in a "
                    f"serving checkpoint {_LATER[:-1]}, A4)")
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)], f"{name}/{i}")
                        for i in range(len(node))]
            return {k: listify(v, f"{name}/{k}".lstrip("/"))
                    for k, v in node.items()}
        return node
    return InferenceEngine((model_cfg, listify(tree)), config, device=device)
