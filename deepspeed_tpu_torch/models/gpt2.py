"""GPT-2 model family for training.

Counterpart of ``deepspeed_tpu/models/gpt2.py``: the same presets, the same
function and the same parameter names and layouts as the flax model, so
that carrying weights across is a rename (``module_inject/from_jax.py``).
Parameters form a flat dict with the flax paths joined by dots: ``wte``
``[padded_vocab, C]``, ``wpe``, ``h_{i}.ln_1.{scale,bias}``,
``h_{i}.attn.c_attn.{kernel,bias}`` (kernel ``[in, out]``),
``h_{i}.attn.c_proj``, ``h_{i}.ln_2``, ``h_{i}.mlp.c_fc``,
``h_{i}.mlp.c_proj``, ``ln_f``.

The ``nn.Module`` tree holds the structure and the names; the weights are
passed to :meth:`GPT2LMModel.apply` and ``loss_fn`` as that dict (the
engine's compute-dtype copy), as the JAX model takes its params. By
default the modules are built on the ``meta`` device, so they hold no
memory. With ``remat`` each block runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant) and is recomputed
in the backward pass, flash forward included.

Numerics follow flax: LayerNorm with ``epsilon=1e-6`` and fast variance
(``E[x^2] - E[x]^2``) in f32, output in the compute dtype; Dense layers
round the product and then the bias add in the compute dtype; tanh GELU;
logits ``x @ wte.T`` in the compute dtype, the loss in f32 over all padded
vocabulary columns with the labels masked to ``[0, vocab_size)``. With
``int8_training`` the Dense products and the logits run through SwitchBack
(``ops/int8_training.py``), as the JAX model routes its Dense layers and
``lm_logits``.

With ``offload_params`` the model takes part in ZeRO-3 parameter offload
(``runtime/zero/param_offload.py``): ``handles_param_offload`` tells the
engine so, and the engine installs its fetch with
:meth:`GPT2LMModel.set_param_fetch`. The weights then stay on the host and
the model fetches each block's weights inside its checkpointed
``_run_block`` (so the backward recompute fetches them again), ``wte``
once at the start (the embedding and the tied logits use the same copy),
``wpe`` and ``ln_f`` at their use, as JAX's ``models/gpt2.py:236-375``
places its fetches.

Under a ``tensor`` mesh axis the engine hands each rank its shard by
:meth:`GPT2LMModel.tp_specs` (JAX's entries) and :meth:`GPT2LMModel.
tp_fused`: ``c_attn`` holds the rank's heads of q, of k and of v (not a
contiguous half of the fused columns), ``c_fc`` its columns, both
``c_proj`` their rows, and ``wte`` its rows of the padded vocabulary. The
forward tells the split from the shapes and states the collectives
(``parallel/tensor_parallel.py``): the column-parallel inputs are copied
to the group, the row-parallel products summed over it before their bias,
the embedding is the masked row lookup summed over the group, and the tied
head gives each rank its vocabulary columns of the logits, which the
vocab-parallel loss takes. Under a ``seq`` axis each rank takes its block
of the T positions after the embedding, attention gathers q/k/v along T,
and the loss is the global masked mean.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention import causal_attention
from deepspeed_tpu_torch.ops.flash_attention import flash_attention_reference
from deepspeed_tpu_torch.ops.int8_training import lm_logits, maybe_switchback
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    copy_to_group, next_token_labels, reduce_from_group, seq_attention,
    seq_block, seq_mean, vocab_parallel_embedding, vocab_parallel_nll)
from deepspeed_tpu_torch.runtime.zero.partition import PartitionSpec as P
from deepspeed_tpu_torch.utils.unported import not_ported

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-6   # flax nn.LayerNorm's default


def refuse_split_switchback(int8: bool, split: bool) -> None:
    """SwitchBack quantizes each token's row of a product's input; a
    row-parallel input is split over the ranks, and the row's amax would
    be a rank's."""
    if int8 and split:
        raise NotImplementedError(
            not_ported("int8_training (SwitchBack) with a tensor axis"))


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    use_flash_attention: bool = True
    # pad the vocabulary to a multiple of 128, as the JAX model does
    vocab_pad_multiple: int = 128
    # SwitchBack (ops/int8_training.py): the four projections of a block
    # and the logits run int8 forward and dx products
    int8_training: bool = False
    # ZeRO-3 parameter offload: fetch each block's weights at its use
    offload_params: bool = False
    # options of the JAX model that this port refuses (queue C)
    sequence_parallel: bool = False
    num_experts: int = 0

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


PRESETS: Dict[str, dict] = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=16),
    "gpt2-2.7b": dict(n_embd=2560, n_layer=32, n_head=32),
    "gpt2-6.7b": dict(n_embd=4096, n_layer=32, n_head=32),
}


def config_for(name: str, **overrides) -> GPT2Config:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}: {sorted(PRESETS)}")
    return GPT2Config(**{**PRESETS[name], **overrides})


def layer_norm(x, scale, bias, dtype, eps: float = LN_EPS):
    """flax ``nn.LayerNorm``: f32 statistics with the fast variance
    (clipped at 0), output in ``dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float())
    return (y + bias.float()).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, n: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]``; inputs and weights in
    ``dtype``, the product (SwitchBack's with ``int8``) rounded before the
    bias add."""

    def __init__(self, n_in: int, n_out: int, dtype, device=None,
                 int8: bool = False):
        super().__init__()
        self.dtype = dtype
        self.matmul = maybe_switchback(int8)
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x, reduce: bool = False):
        """``reduce``: a row-parallel product, summed over the ``tensor``
        group before the bias (added once)."""
        d = self.dtype
        out = self.matmul(x.to(d), self.kernel.to(d))
        if reduce:
            out = reduce_from_group(out)
        return out + self.bias.to(d)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_attn = Dense(C, 3 * C, cfg.dtype, device, cfg.int8_training)
        self.c_proj = Dense(C, C, cfg.dtype, device, cfg.int8_training)

    def _attend(self, q, k, v, reference_attention):
        cfg = self.cfg
        if reference_attention:
            return flash_attention_reference(q, k, v, causal=True)[0]
        if cfg.use_flash_attention:
            return causal_attention(q, k, v)
        # the JAX model's plain path: scale in the compute dtype, mask at
        # the dtype's min, softmax in f32
        T = q.shape[1]
        scale = 1.0 / torch.tensor(math.sqrt(cfg.head_dim), dtype=cfg.dtype)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~mask, torch.finfo(att.dtype).min)
        att = torch.softmax(att.float(), dim=-1).to(cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", att, v)

    def forward(self, x, reference_attention: bool = False):
        cfg = self.cfg
        B, T, C = x.shape
        D = cfg.head_dim
        # the rank's heads of q, k and v under tensor (C of them whole)
        Cl = self.c_attn.kernel.shape[1] // 3
        split = Cl < C
        refuse_split_switchback(cfg.int8_training, split)
        if split:
            x = copy_to_group(x)
        # views of the fused projection, strides (T*3Cl, 3Cl, D, 1): the
        # flash kernels read them in place
        q, k, v = (t.reshape(B, T, Cl // D, D)
                   for t in self.c_attn(x).split(Cl, dim=-1))
        y = seq_attention(self._attend, q, k, v, reference_attention)
        return self.c_proj(y.reshape(B, T, Cl), reduce=split)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        C = cfg.n_embd
        self.c_fc = Dense(C, 4 * C, cfg.dtype, device, cfg.int8_training)
        self.c_proj = Dense(4 * C, C, cfg.dtype, device, cfg.int8_training)

    def forward(self, x):
        split = self.c_fc.kernel.shape[1] < self.c_proj.kernel.shape[1] * 4
        if split:   # the rank's columns of the 4C hidden units
            x = copy_to_group(x)
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"),
                           reduce=split)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, reference_attention: bool = False):
        x = x + self.attn(self.ln_1(x), reference_attention)
        return x + self.mlp(self.ln_2(x))


def _run_block(block: Block, params: Params, x, reference_attention: bool,
               fetch=None, prefix: str = ""):
    if fetch is not None:   # inside the checkpoint: recompute re-fetches
        params = {n: fetch(prefix + n, p) for n, p in params.items()}
    return torch.func.functional_call(block, params, (x,),
                                      {"reference_attention":
                                       reference_attention})


class GPT2(nn.Module):
    """Causal LM; ``forward`` returns logits ``[B, T, padded_vocab]`` in
    the compute dtype."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.wte = nn.Parameter(torch.empty(cfg.padded_vocab_size, C,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, C,
                                            device=device))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, device))
        self.ln_f = LayerNorm(C, cfg.dtype, device)
        self._block_keys = [n for n, _ in self.h_0.named_parameters()]
        # the engine's parameter fetch (offload_params), None: identity
        self.fetch = None

    def forward(self, input_ids, params: Optional[Params] = None,
                reference_attention: bool = False):
        """``params`` (default: the module's own) is the flat dict of
        weights; ``reference_attention`` takes attention through the
        kernels' plain version under autograd instead of the kernels."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        fetch = self.fetch if cfg.offload_params else None

        def get(name):
            p = params[name]
            return p if fetch is None else fetch(name, p)
        # under seq: this rank's block of the positions
        start, n = seq_block(input_ids.shape[1])
        ids = input_ids[:, start:start + n].long()
        wte = get("wte")
        vocab_split = wte.shape[0] < cfg.padded_vocab_size
        # gather rows, then cast (as the JAX model does)
        rows = (vocab_parallel_embedding(wte, ids) if vocab_split
                else wte[ids])
        x = rows.to(cfg.dtype) + get("wpe")[start:start + n].to(
            cfg.dtype)[None]
        for i in range(cfg.n_layer):
            bp = {n: params[f"h_{i}.{n}"] for n in self._block_keys}
            block = self.get_submodule(f"h_{i}")
            args = (block, bp, x, reference_attention, fetch, f"h_{i}.")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_run_block, *args, use_reentrant=False)
            else:
                x = _run_block(*args)
        x = layer_norm(x, get("ln_f.scale"), get("ln_f.bias"), cfg.dtype)
        if vocab_split:   # the rank's vocabulary columns of the logits
            refuse_split_switchback(cfg.int8_training, True)
            x = copy_to_group(x)
        return lm_logits(x, wte.to(cfg.dtype), cfg.int8_training)


class GPT2LMModel:
    """Engine-facing wrapper: ``init``, ``apply``, ``loss_fn``.

    ``loss_fn(params, batch, rng=None)``: ``batch`` holds ``input_ids``
    ``[B, T]`` (next-token prediction) and optionally ``labels``. The
    module tree is built on ``device`` (default ``meta``: it holds no
    weights; they are passed to ``apply`` and ``loss_fn``)."""

    def __init__(self, config: GPT2Config, device="meta"):
        for bad, what in ((config.dropout > 0.0, "dropout > 0"),
                          (config.num_experts > 0, "MoE layers"),
                          (config.sequence_parallel, "sequence_parallel")):
            if bad:
                raise NotImplementedError(not_ported(f"GPT-2 with {what}"))
        self.config = config
        self.module = GPT2(config, device=device)

    @property
    def handles_param_offload(self) -> bool:
        """Engine hint: with ``offload_params`` the model fetches its own
        weights layer by layer, so the engine must not stage the whole
        tree."""
        return self.config.offload_params

    def set_param_fetch(self, fetch) -> None:
        """The engine's fetch (``runtime/zero/param_offload.ParamFetcher``:
        ``fetch(name, host_tensor)`` gives the weight on the card); None
        turns the fetches off."""
        self.module.fetch = fetch

    def init(self, generator: torch.Generator) -> Params:
        """f32 weights on ``generator.device`` with the flax model's
        distributions: ``wte`` normal(0.02), ``wpe`` normal(0.01), Dense
        kernels lecun-normal (a normal truncated at 2 std, std
        ``sqrt(1/fan_in) / 0.8796``), zero biases, LayerNorm 1 and 0."""
        params = {}
        for name, p in self.module.named_parameters():
            t = torch.empty(p.shape, dtype=torch.float32,
                            device=generator.device)
            if name == "wte":
                t.normal_(0.0, 0.02, generator=generator)
            elif name == "wpe":
                t.normal_(0.0, 0.01, generator=generator)
            elif name.endswith(".kernel"):
                std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            elif name.endswith(".scale"):
                t.fill_(1.0)
            else:
                t.zero_()
            params[name] = t
        return params

    def apply(self, params: Params, input_ids,
              reference_attention: bool = False):
        """Logits ``[B, T, padded_vocab]`` in the compute dtype (this
        rank's block of T under seq, its vocabulary columns under
        tensor)."""
        return self.module(input_ids, params, reference_attention)

    def loss_fn(self, params: Params, batch, rng=None,
                reference_attention: bool = False):
        """Mean next-token cross entropy in f32 (``rng`` is unused: the
        port has no dropout): ``logsumexp`` over every padded column minus
        the gold logit, over the labels in ``[0, vocab_size)``; an
        out-of-range label is clamped for the gather and masked."""
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        logits = self.apply(params, input_ids, reference_attention)
        start, n = seq_block(input_ids.shape[1])
        if labels is None:
            labels, m = next_token_labels(input_ids, start, n)
            logits = logits[:, :m]
        else:
            labels = labels[:, start:start + n]
        labels = labels.long()
        nll = vocab_parallel_nll(
            logits.float(),
            labels.clamp(0, self.config.padded_vocab_size - 1))
        mask = (labels >= 0) & (labels < self.config.vocab_size)
        return seq_mean(nll, mask)

    def tp_specs(self) -> Dict[str, P]:
        """Megatron placement, JAX's entries by the port's flat names:
        ``c_attn`` and ``c_fc`` column-parallel, both ``c_proj``
        row-parallel (their biases whole), ``wte`` vocab-parallel."""
        block = {"ln_1.scale": P(), "ln_1.bias": P(), "ln_2.scale": P(),
                 "ln_2.bias": P(),
                 "attn.c_attn.kernel": P(None, "tensor"),
                 "attn.c_attn.bias": P("tensor"),
                 "attn.c_proj.kernel": P("tensor", None),
                 "attn.c_proj.bias": P(),
                 "mlp.c_fc.kernel": P(None, "tensor"),
                 "mlp.c_fc.bias": P("tensor"),
                 "mlp.c_proj.kernel": P("tensor", None),
                 "mlp.c_proj.bias": P()}
        specs = {"wte": P("tensor", None), "wpe": P(), "ln_f.scale": P(),
                 "ln_f.bias": P()}
        for i in range(self.config.n_layer):
            specs.update({f"h_{i}.{k}": s for k, s in block.items()})
        return specs

    def tp_fused(self) -> Dict[str, int]:
        """The leaves whose split dim holds q, k and v side by side: each
        part is split over ``tensor`` on its own."""
        return {f"h_{i}.attn.c_attn.{k}": 3
                for i in range(self.config.n_layer)
                for k in ("kernel", "bias")}

    def param_count(self, params: Params) -> int:
        return sum(p.numel() for p in params.values())

    def flops_per_token(self) -> float:
        """~6 x parameters per token (training forward + backward), as the
        JAX model counts it."""
        cfg = self.config
        n = (cfg.padded_vocab_size * cfg.n_embd
             + cfg.n_positions * cfg.n_embd
             + cfg.n_layer * 12 * cfg.n_embd ** 2)
        return 6.0 * n
