"""BERT pre-training model family.

Counterpart of ``deepspeed_tpu/models/bert.py``: the training layer of
:mod:`deepspeed_tpu_torch.ops.transformer` assembled into a masked-LM (and
optional NSP) pre-training model with ``init`` and ``loss_fn(params,
batch, rng)``, so that ``deepspeed_tpu_torch.initialize`` trains it like
any other model.

Parameters form a flat dict with the JAX tree's paths joined by dots, the
layer list by index: ``wte`` ``[V, E]``, ``wpe``, ``wtte``,
``emb_ln.{scale,bias}``, ``layers.{i}.{attn_qkvw, ...}`` (the layer's
schema), ``mlm_dense.{w,b}``, ``mlm_ln.{scale,bias}``, ``mlm_bias``
(f32) and, with NSP, ``pooler.{w,b}`` and ``nsp.{w,b}`` (``nsp.b`` f32).
The MLM head's unembedding is tied to ``wte``.

Batch schema (BingBertSquad-style pre-training):
    input_ids      [B, T] int
    attention_mask [B, T] int (1 = live)             optional
    token_type_ids [B, T] int                        optional
    mlm_labels     [B, T] int, -100 = not masked     (MLM loss)
    nsp_labels     [B] int in {0, 1}                 optional (NSP loss)

A label outside its range (``[0, V)`` for MLM, ``[0, 2)`` for NSP), -100
included, is masked out of its loss and its gather is clamped, the rule
of the port's GPT-2 and LLaMA losses: the loss stays finite and no index
leaves the table (JAX's ``take_along_axis`` wraps a negative label and
gives NaN above the range).

An unmasked batch takes the layers' flash route (B1-B3, non-causal); a
batch with ``attention_mask`` takes their plain einsum route, as in JAX.
The port's engine calls ``loss_fn`` with ``rng=None`` (as it calls every
model), so BERT trains deterministically there, as the JAX model does
with ``rng=None``; an ``rng`` with dropout ratios above 0 in training mode
raises ``NotImplementedError`` (dropout: ROADMAP.md queue C, A9).

Under a ``tensor`` mesh axis the layers split by :meth:`BertPreTraining
Model.tp_specs` (JAX's entries; the fused ``attn_qkvw``/``attn_qkvb`` cut
part by part, :meth:`tp_fused`); embeddings and the MLM and NSP heads
stay whole. Under a ``seq`` axis each rank embeds and encodes its block
of the positions (attention gathers q/k/v along T), the MLM loss is the
global masked mean, and the NSP term comes from the rank that holds
position 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.int8_training import (lm_logits,
                                                   switchback_matmul)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer,
                                                 layer_norm_fp32, matmul)
from deepspeed_tpu_torch.parallel.tensor_parallel import (SEQ,
                                                          reduce_from_group,
                                                          seq_block,
                                                          seq_mean)
from deepspeed_tpu_torch.runtime.zero.partition import PartitionSpec as P

Params = Dict[str, torch.Tensor]
LAYER_KEYS = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
              "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
              "norm_w", "norm_b")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True      # reference default (preln modeling)
    with_nsp: bool = True
    dtype: Any = torch.bfloat16
    # SwitchBack int8 projections in every encoder layer and the MLM
    # dense/unembedding GEMMs (the NSP head stays full precision)
    int8_training: bool = False


PRESETS: Dict[str, dict] = {
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
}


def config_for(name: str, **overrides) -> BertConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}: {sorted(PRESETS)}")
    return BertConfig(**{**PRESETS[name], **overrides})


class BertPreTrainingModel:
    """Engine-facing BERT MLM (+NSP) model over the training layer."""

    def __init__(self, config: BertConfig, train: bool = True):
        """``train=False`` turns dropout off whatever the rng."""
        self.config = config
        self.train = train
        layer_cfg = DeepSpeedTransformerConfig(
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            heads=config.num_attention_heads,
            attn_dropout_ratio=config.attention_probs_dropout_prob,
            hidden_dropout_ratio=config.hidden_dropout_prob,
            num_hidden_layers=config.num_hidden_layers,
            initializer_range=config.initializer_range,
            layer_norm_eps=config.layer_norm_eps,
            pre_layer_norm=config.pre_layer_norm,
            fp16=config.dtype == torch.bfloat16,
            int8_training=config.int8_training,
            training=True)
        self.layers = [DeepSpeedTransformerLayer(layer_cfg)
                       for _ in range(config.num_hidden_layers)]

    # -- init --------------------------------------------------------------
    def init(self, generator: torch.Generator, **_) -> Params:
        """Weights on ``generator.device`` with the JAX model's tree,
        dtypes and distributions: embeddings and dense weights
        normal(``initializer_range``), the layers' own init, zero biases,
        LayerNorms 1 and 0; ``mlm_bias`` and ``nsp.b`` f32."""
        cfg = self.config
        E, V = cfg.hidden_size, cfg.vocab_size
        std, dt, dev = cfg.initializer_range, cfg.dtype, generator.device

        def emb(*shape):
            return (torch.randn(shape, generator=generator, device=dev)
                    * std).to(dt)

        def const(n, value, dtype=dt):
            return torch.full((n,), value, dtype=dtype, device=dev)
        params: Params = {
            "wte": emb(V, E), "wpe": emb(cfg.max_position_embeddings, E),
            "wtte": emb(cfg.type_vocab_size, E),
            "emb_ln.scale": const(E, 1.0), "emb_ln.bias": const(E, 0.0)}
        for i, layer in enumerate(self.layers):
            for k, v in layer.init(generator).items():
                params[f"layers.{i}.{k}"] = v
        params.update({
            "mlm_dense.w": emb(E, E), "mlm_dense.b": const(E, 0.0),
            "mlm_ln.scale": const(E, 1.0), "mlm_ln.bias": const(E, 0.0),
            "mlm_bias": const(V, 0.0, torch.float32)})
        if cfg.with_nsp:
            params.update({
                "pooler.w": emb(E, E), "pooler.b": const(E, 0.0),
                "nsp.w": emb(E, 2), "nsp.b": const(2, 0.0, torch.float32)})
        return params

    # -- forward -----------------------------------------------------------
    def _ln(self, x, params, name):
        return layer_norm_fp32(x, params[name + ".scale"],
                               params[name + ".bias"],
                               self.config.layer_norm_eps)

    def encode(self, params: Params, input_ids, attention_mask=None,
               token_type_ids=None, rng=None, deterministic=True):
        """The encoder's hidden states ``[B, T, E]`` in the compute
        dtype (this rank's block of T under seq)."""
        cfg = self.config
        start, n = seq_block(input_ids.shape[1])
        ids = input_ids[:, start:start + n].long()
        tt = (token_type_ids[:, start:start + n].long()
              if token_type_ids is not None else torch.zeros_like(ids))
        x = (params["wte"][ids] + params["wpe"][start:start + n][None]
             + params["wtte"][tt]).to(cfg.dtype)
        x = self._ln(x, params, "emb_ln")
        for i, layer in enumerate(self.layers):
            lp = {k: params[f"layers.{i}.{k}"] for k in LAYER_KEYS}
            x = layer.apply(lp, x, attention_mask=attention_mask, rng=rng,
                            deterministic=deterministic)
        return x

    # -- losses ------------------------------------------------------------
    def loss_fn(self, params: Params, batch, rng=None):
        """Mean MLM cross entropy over the live labels (those in ``[0,
        V)``; -100 marks a position that is not masked), in f32, plus the
        mean NSP cross entropy over the rows whose ``nsp_labels`` is 0 or
        1 when the batch has them."""
        cfg = self.config
        x = self.encode(params, batch["input_ids"],
                        batch.get("attention_mask"),
                        batch.get("token_type_ids"), rng=rng,
                        deterministic=(not self.train) or rng is None)
        if cfg.int8_training:
            h = switchback_matmul(x, params["mlm_dense.w"])
        else:
            h = matmul(x, params["mlm_dense.w"])
        h = F.gelu((h + params["mlm_dense.b"]).float()).to(x.dtype)
        h = self._ln(h, params, "mlm_ln")
        logits = lm_logits(h, params["wte"].to(h.dtype),
                           cfg.int8_training).float() + params["mlm_bias"]
        start, n = seq_block(batch["input_ids"].shape[1])
        labels = batch["mlm_labels"][:, start:start + n].long()
        live = (labels >= 0) & (labels < cfg.vocab_size)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(
            -1, labels.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        loss = seq_mean(torch.where(live, lse - gold, 0.0), live)
        if cfg.with_nsp and "nsp_labels" in batch:
            pooled = torch.tanh(matmul(x[:, 0], params["pooler.w"])
                                + params["pooler.b"])
            nsp_logits = (pooled @ params["nsp.w"].to(pooled.dtype)
                          ).float() + params["nsp.b"]
            nsp = batch["nsp_labels"].long()
            nsp_live = (nsp >= 0) & (nsp < nsp_logits.shape[-1])
            nsp_ll = torch.log_softmax(nsp_logits, -1).gather(
                -1, nsp.clamp(0, nsp_logits.shape[-1] - 1)[:, None])[:, 0]
            nsp_loss = -torch.where(nsp_live, nsp_ll, 0.0).sum() / \
                torch.clamp(nsp_live.sum(), min=1)
            # position 0 is the first seq rank's
            loss = loss + reduce_from_group(nsp_loss * float(start == 0),
                                            SEQ)
        return loss

    def param_count(self, params: Params) -> int:
        return sum(p.numel() for p in params.values())

    def flops_per_token(self) -> float:
        """6N per token (training forward + backward), N = the encoder's
        and the tied head's parameters, as the JAX model counts it."""
        cfg = self.config
        E, Fh, L = cfg.hidden_size, cfg.intermediate_size, \
            cfg.num_hidden_layers
        n = L * (4 * E * E + 2 * E * Fh) + cfg.vocab_size * E
        return 6.0 * n

    def tp_specs(self) -> Dict[str, P]:
        """Megatron placement, JAX's entries by the port's flat names: the
        fused QKV and the FFN-in column-parallel, the attention and
        FFN-out projections row-parallel (their biases whole), every
        embedding, norm and head whole."""
        layer = {"attn_qkvw": P(None, "tensor"), "attn_qkvb": P("tensor"),
                 "attn_ow": P("tensor", None), "attn_ob": P(),
                 "attn_nw": P(), "attn_nb": P(),
                 "inter_w": P(None, "tensor"), "inter_b": P("tensor"),
                 "output_w": P("tensor", None), "output_b": P(),
                 "norm_w": P(), "norm_b": P()}
        specs = {"wte": P(), "wpe": P(), "wtte": P(), "emb_ln.scale": P(),
                 "emb_ln.bias": P(), "mlm_dense.w": P(), "mlm_dense.b": P(),
                 "mlm_ln.scale": P(), "mlm_ln.bias": P(), "mlm_bias": P()}
        if self.config.with_nsp:
            specs.update({"pooler.w": P(), "pooler.b": P(), "nsp.w": P(),
                          "nsp.b": P()})
        for i in range(self.config.num_hidden_layers):
            specs.update({f"layers.{i}.{k}": s for k, s in layer.items()})
        return specs

    def tp_fused(self) -> Dict[str, int]:
        """The fused QKV leaves: q, k and v each split on their own."""
        return {f"layers.{i}.{k}": 3
                for i in range(self.config.num_hidden_layers)
                for k in ("attn_qkvw", "attn_qkvb")}
