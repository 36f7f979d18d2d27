"""LLaMA model family for training.

Counterpart of ``deepspeed_tpu/models/llama.py``: RMSNorm, rotary position
embeddings, grouped-query attention, SwiGLU MLP, no biases, with the JAX
model's presets, names and layouts, so that carrying weights across is a
rename (``module_inject/from_jax.py``). Parameters form a flat dict with
the flax paths joined by dots: ``embed`` ``[V, C]``,
``layers_{i}.ln_attn``, ``layers_{i}.attn.{wq,wk,wv,wo}.kernel`` (kernel
``[in, out]``), ``layers_{i}.ln_mlp``, ``layers_{i}.mlp.{gate,up,down}.
kernel``, ``ln_f`` and, untied, ``lm_head`` ``[V, C]``.

As in the port's GPT-2, the ``nn.Module`` tree holds the structure and the
names (on the ``meta`` device by default); the weights are passed to
:meth:`LlamaLMModel.apply` and ``loss_fn`` as that dict. With ``remat``
each block runs under ``torch.utils.checkpoint.checkpoint``
(non-reentrant) and is recomputed whole in the backward pass; the JAX
model's selective policy (save the dots and the flash output) is not
ported (ROADMAP.md A11). The numbers are the same either way.

Numerics follow the JAX model: RMSNorm with f32 statistics, cast to the
input dtype, then multiplied by the weight in that dtype; HF rotate-half
rotary embeddings in f32 at positions ``arange(T)``; Dense products in
the compute dtype; logits ``x @ head.T`` in the compute dtype and the loss
in f32 with the labels masked to ``[0, vocab_size)``. k and v keep their
``n_kv_head`` heads into attention: the flash kernels read kv head
``h // (H // KH)`` and the backward (B3) sums each group's dk/dv. The
loss gathers with a clamped index, so a label outside the vocabulary is
masked and never turns the loss NaN (JAX fills NaN there; ROADMAP.md D).

``flash_block`` is the JAX model's tile-size override for its Pallas
kernel. The CUDA kernels choose their own tiles per head dim, so the port
accepts the field, so that a JAX config carries over, and ignores it.
MoE layers (``num_experts > 0``) and ``sequence_parallel`` (ring and
Ulysses attention) are refused when the model is built (ROADMAP.md queue
C, A8).

Under a ``tensor`` mesh axis the engine hands each rank its shard by
:meth:`LlamaLMModel.tp_specs` (JAX's entries): its heads of wq/wk/wv (k
and v keep their ``n_kv_head / tensor`` heads unexpanded into the
kernels), its columns of gate/up, its rows of wo/down, and its rows of
``embed`` and the untied ``lm_head`` (vocab-parallel); the collectives are
GPT-2's (``models/gpt2.py``). Under a ``seq`` axis each rank takes its
block of the positions after the embedding (the rotary angles at their
global positions), and attention gathers q/k/v along T.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention import (causal_attention,
                                               causal_attention_reference)
from deepspeed_tpu_torch.models.gpt2 import refuse_split_switchback
from deepspeed_tpu_torch.ops.int8_training import lm_logits, maybe_switchback
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    copy_to_group, next_token_labels, reduce_from_group, seq_attention,
    seq_block, seq_mean, vocab_parallel_embedding, vocab_parallel_nll)
from deepspeed_tpu_torch.runtime.zero.partition import PartitionSpec as P
from deepspeed_tpu_torch.utils.unported import not_ported

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_positions: int = 2048
    n_embd: int = 2048
    n_layer: int = 16
    n_head: int = 16
    n_kv_head: int = 16            # < n_head => grouped-query attention
    intermediate_size: int = 5504  # SwiGLU hidden (~8/3 * n_embd rounded)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    use_flash_attention: bool = True
    # the JAX Pallas kernel's tile override; accepted and ignored here
    flash_block: int = 0
    sequence_parallel: bool = False
    sp_mode: str = "ring"
    # Mixtral-style MoE (refused by LlamaLMModel: queue C, A8)
    num_experts: int = 0
    moe_layers: Optional[tuple] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # SwitchBack int8 projections and logits (ops/int8_training.py)
    int8_training: bool = False

    def __post_init__(self):
        if self.n_head % self.n_kv_head:
            raise ValueError(f"n_head={self.n_head} must be divisible by "
                             f"n_kv_head={self.n_kv_head}")
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got "
                             f"{self.sp_mode!r}")
        if self.num_experts > 0:
            layers = self.moe_layer_set
            if not layers:
                raise ValueError("num_experts > 0 needs at least one MoE "
                                 "layer (moe_layers is empty)")
            bad = sorted(i for i in layers if not 0 <= i < self.n_layer)
            if bad:
                raise ValueError(f"moe_layers {bad} out of range for "
                                 f"n_layer={self.n_layer}")

    @property
    def moe_layer_set(self) -> frozenset:
        if self.num_experts <= 0:
            return frozenset()
        if self.moe_layers is not None:
            return frozenset(self.moe_layers)
        return frozenset(range(self.n_layer))

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


PRESETS: Dict[str, dict] = {
    # HF config shapes for the common ladder
    "llama-tiny": dict(vocab_size=512, n_positions=256, n_embd=128,
                       n_layer=2, n_head=4, n_kv_head=2,
                       intermediate_size=352),
    "llama-1b": dict(n_embd=2048, n_layer=16, n_head=16, n_kv_head=16,
                     intermediate_size=5504),
    "llama-3b": dict(n_embd=2560, n_layer=26, n_head=20, n_kv_head=20,
                     intermediate_size=6912),
    "llama-7b": dict(n_embd=4096, n_layer=32, n_head=32, n_kv_head=32,
                     intermediate_size=11008, n_positions=4096),
    # mistral-style GQA variant
    "llama-7b-gqa": dict(n_embd=4096, n_layer=32, n_head=32, n_kv_head=8,
                         intermediate_size=14336, n_positions=4096),
    # Mixtral layout (its config builds; the model refuses it: A8)
    "mixtral-tiny": dict(vocab_size=512, n_positions=256, n_embd=128,
                         n_layer=2, n_head=4, n_kv_head=2,
                         intermediate_size=352, num_experts=4,
                         moe_capacity_factor=2.0),
    "mixtral-8x7b": dict(n_embd=4096, n_layer=32, n_head=32, n_kv_head=8,
                         intermediate_size=14336, n_positions=4096,
                         num_experts=8, moe_top_k=2),
}


def config_for(name: str, **overrides) -> LlamaConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}: {sorted(PRESETS)}")
    return LlamaConfig(**{**PRESETS[name], **overrides})


def _rms_norm(x, weight, eps):
    """RMSNorm with f32 statistics (HF LlamaRMSNorm): the scaled output is
    cast to the input dtype, then multiplied by the weight in it."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _rope(q, k, theta, start: int = 0):
    """HF rotate-half rotary embedding at positions ``start + arange(T)``,
    in f32. q/k ``[B, T, H, D]``."""
    T, D = q.shape[1], q.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=q.device) / D))
    ang = torch.arange(start, start + T, dtype=torch.float32,
                       device=q.device)[:, None] * inv[None, :]  # [T, D/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], -1)

    qf, kf = q.float(), k.float()
    return ((qf * cos + rot(qf) * sin).to(q.dtype),
            (kf * cos + rot(kf) * sin).to(k.dtype))


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False)``: kernel ``[in, out]``, the product
    (SwitchBack's with ``int8``) in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype, device=None,
                 int8: bool = False):
        super().__init__()
        self.dtype = dtype
        self.matmul = maybe_switchback(int8)
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device))

    def forward(self, x, reduce: bool = False):
        """``reduce``: a row-parallel product, summed over ``tensor``."""
        out = self.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return reduce_from_group(out) if reduce else out


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C, HD, KD = cfg.n_embd, cfg.n_head * cfg.head_dim, \
            cfg.n_kv_head * cfg.head_dim
        args = (cfg.dtype, device, cfg.int8_training)
        self.wq = Dense(C, HD, *args)
        self.wk = Dense(C, KD, *args)
        self.wv = Dense(C, KD, *args)
        self.wo = Dense(HD, C, *args)

    def forward(self, x, start: int = 0):
        """``start``: the first position of ``x`` (a seq rank's block)."""
        cfg = self.cfg
        B, T, _ = x.shape
        D = cfg.head_dim
        # the rank's heads under tensor
        H, KH = self.wq.kernel.shape[1] // D, self.wk.kernel.shape[1] // D
        split = H < cfg.n_head
        refuse_split_switchback(cfg.int8_training, split)
        if split:
            x = copy_to_group(x)
        q = self.wq(x).reshape(B, T, H, D)
        k = self.wk(x).reshape(B, T, KH, D)
        v = self.wv(x).reshape(B, T, KH, D)
        q, k = _rope(q, k, cfg.rope_theta, start)
        # k/v unexpanded: the kernels (and the oracle) read each group's
        # kv head in place
        attn = (causal_attention if cfg.use_flash_attention
                else causal_attention_reference)
        y = seq_attention(attn, q, k, v)
        return self.wo(y.reshape(B, T, H * D), reduce=split)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        C, Fh = cfg.n_embd, cfg.intermediate_size
        self.intermediate = Fh
        args = (cfg.dtype, device, cfg.int8_training)
        self.gate = Dense(C, Fh, *args)
        self.up = Dense(C, Fh, *args)
        self.down = Dense(Fh, C, *args)

    def forward(self, x):
        split = self.gate.kernel.shape[1] < self.intermediate
        if split:   # the rank's columns of the hidden units
            x = copy_to_group(x)
        return self.down(F.silu(self.gate(x)) * self.up(x), reduce=split)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.eps = cfg.rms_eps
        self.ln_attn = nn.Parameter(torch.ones(cfg.n_embd, device=device))
        self.attn = LlamaAttention(cfg, device)
        self.ln_mlp = nn.Parameter(torch.ones(cfg.n_embd, device=device))
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, start: int = 0):
        x = x + self.attn(_rms_norm(x, self.ln_attn, self.eps), start)
        return x + self.mlp(_rms_norm(x, self.ln_mlp, self.eps))


def _run_block(block: LlamaBlock, params: Params, x, start: int = 0):
    return torch.func.functional_call(block, params, (x, start))


class Llama(nn.Module):
    """Causal LM trunk and head; ``forward`` returns logits ``[B, T, V]``
    in the compute dtype."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C, V = cfg.n_embd, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty(V, C, device=device))
        for i in range(cfg.n_layer):
            self.add_module(f"layers_{i}", LlamaBlock(cfg, device))
        self.ln_f = nn.Parameter(torch.ones(C, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(V, C, device=device))
        self._block_keys = [n for n, _ in self.layers_0.named_parameters()]

    def forward(self, input_ids, params: Optional[Params] = None):
        """``params`` (default: the module's own) is the flat dict of
        weights."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        embed = params["embed"]
        # under seq: this rank's block of the positions
        start, n = seq_block(input_ids.shape[1])
        ids = input_ids[:, start:start + n].long()
        # gather rows, then cast (as the JAX model does); under tensor the
        # rows are split over the ranks
        x = (vocab_parallel_embedding(embed, ids)
             if embed.shape[0] < cfg.vocab_size else embed[ids]).to(
                 cfg.dtype)
        for i in range(cfg.n_layer):
            bp = {n: params[f"layers_{i}.{n}"] for n in self._block_keys}
            block = self.get_submodule(f"layers_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_run_block, block, bp, x, start,
                               use_reentrant=False)
            else:
                x = _run_block(block, bp, x, start)
        x = _rms_norm(x, params["ln_f"], cfg.rms_eps)
        head = embed if cfg.tie_embeddings else params["lm_head"]
        if head.shape[0] < cfg.vocab_size:   # vocab-parallel logits
            refuse_split_switchback(cfg.int8_training, True)
            x = copy_to_group(x)
        return lm_logits(x, head.to(cfg.dtype), cfg.int8_training)


class LlamaLMModel:
    """Engine-facing wrapper: ``init``, ``apply``, ``loss_fn`` (the
    contract of the port's ``GPT2LMModel``).

    ``loss_fn(params, batch, rng=None)``: ``batch`` holds ``input_ids``
    ``[B, T]`` (next-token prediction) and optionally ``labels``. The
    module tree is built on ``device`` (default ``meta``: it holds no
    weights)."""

    def __init__(self, config: LlamaConfig, device="meta"):
        if config.num_experts > 0:
            raise NotImplementedError(not_ported("LLaMA with MoE layers", "A8"))
        if config.sequence_parallel:
            raise NotImplementedError(not_ported(
                "LLaMA with sequence_parallel (ring and Ulysses attention)",
                "A8"))
        self.config = config
        self.module = Llama(config, device=device)

    def init(self, generator: torch.Generator) -> Params:
        """f32 weights on ``generator.device`` with the flax model's
        distributions: ``embed`` and ``lm_head`` normal(0.02), Dense
        kernels lecun-normal (a normal truncated at 2 std, std
        ``sqrt(1/fan_in) / 0.8796``), norms 1."""
        params = {}
        for name, p in self.module.named_parameters():
            t = torch.empty(p.shape, dtype=torch.float32,
                            device=generator.device)
            if name in ("embed", "lm_head"):
                t.normal_(0.0, 0.02, generator=generator)
            elif name.endswith(".kernel"):
                std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            else:
                t.fill_(1.0)
            params[name] = t
        return params

    def apply(self, params: Params, input_ids):
        """Logits ``[B, T, V]`` in the compute dtype (this rank's block of
        T under seq, its vocabulary columns under tensor)."""
        return self.module(input_ids, params)

    def loss_fn(self, params: Params, batch, rng=None):
        """Mean next-token cross entropy in f32 over the labels in
        ``[0, vocab_size)`` (``rng`` is unused: the model has no
        dropout)."""
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        logits = self.apply(params, input_ids)
        start, n = seq_block(input_ids.shape[1])
        if labels is None:
            labels, m = next_token_labels(input_ids, start, n)
            logits = logits[:, :m]
        else:
            labels = labels[:, start:start + n]
        labels = labels.long()
        nll = vocab_parallel_nll(
            logits.float(), labels.clamp(0, self.config.vocab_size - 1))
        mask = (labels >= 0) & (labels < self.config.vocab_size)
        return seq_mean(nll, mask)

    def tp_specs(self) -> Dict[str, P]:
        """Megatron placement, JAX's entries by the port's flat names:
        q/k/v/gate/up column-parallel, wo/down row-parallel, ``embed`` and
        the untied ``lm_head`` vocab-parallel."""
        block = {"ln_attn": P(), "ln_mlp": P(),
                 "attn.wq.kernel": P(None, "tensor"),
                 "attn.wk.kernel": P(None, "tensor"),
                 "attn.wv.kernel": P(None, "tensor"),
                 "attn.wo.kernel": P("tensor", None),
                 "mlp.gate.kernel": P(None, "tensor"),
                 "mlp.up.kernel": P(None, "tensor"),
                 "mlp.down.kernel": P("tensor", None)}
        specs = {"embed": P("tensor", None), "ln_f": P()}
        if not self.config.tie_embeddings:
            specs["lm_head"] = P("tensor", None)
        for i in range(self.config.n_layer):
            specs.update({f"layers_{i}.{k}": s for k, s in block.items()})
        return specs

    def param_count(self, params: Params) -> int:
        return sum(p.numel() for p in params.values())

    def flops_per_token(self) -> float:
        """~6 x parameters per token (training forward + backward), as the
        JAX model counts it."""
        cfg = self.config
        attn = (2 * cfg.n_embd * (cfg.n_head * cfg.head_dim)           # q,o
                + 2 * cfg.n_embd * (cfg.n_kv_head * cfg.head_dim))     # k,v
        ffn = 3 * cfg.n_embd * cfg.intermediate_size
        n = (cfg.vocab_size * cfg.n_embd * (1 if cfg.tie_embeddings else 2)
             + cfg.n_layer * (attn + ffn))
        return 6.0 * n


def params_from_hf(hf_state_dict, cfg: LlamaConfig) -> Params:
    """Map an HF ``LlamaForCausalLM`` state dict (torch tensors or numpy
    arrays) onto this model's flat params: f32 copies on each tensor's
    device, torch's ``[out, in]`` kernels transposed to ``[in, out]``.
    Mixtral checkpoints (``block_sparse_moe``) are refused (A8)."""
    if cfg.num_experts > 0 or any("block_sparse_moe" in k
                                  for k in hf_state_dict):
        raise NotImplementedError(not_ported("Mixtral (MoE) checkpoints", "A8"))

    def t(name, transpose=False):
        w = torch.as_tensor(hf_state_dict[name]).detach()
        w = w.t() if transpose else w
        return torch.empty(w.shape, dtype=torch.float32,
                           device=w.device).copy_(w)

    params: Params = {"embed": t("model.embed_tokens.weight")}
    for i in range(cfg.n_layer):
        p, q = f"model.layers.{i}.", f"layers_{i}."
        params[q + "ln_attn"] = t(p + "input_layernorm.weight")
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            params[f"{q}attn.{ours}.kernel"] = t(
                f"{p}self_attn.{theirs}.weight", True)
        params[q + "ln_mlp"] = t(p + "post_attention_layernorm.weight")
        for ours in ("gate", "up", "down"):
            params[f"{q}mlp.{ours}.kernel"] = t(
                f"{p}mlp.{ours}_proj.weight", True)
    params["ln_f"] = t("model.norm.weight")
    if not cfg.tie_embeddings:
        params["lm_head"] = t("lm_head.weight")
    return params
