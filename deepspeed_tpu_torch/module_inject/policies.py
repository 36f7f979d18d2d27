"""Architecture policy table: HF checkpoints → the fused inference tree.

Counterpart of ``deepspeed_tpu/module_inject/policies.py``: the same
eighteen policies, in the same order, producing the same
``(InferenceTransformerConfig, params)`` — every leaf equal to the JAX
package's in float32. A policy reads an HF model by attribute, duck-typed:
a live ``transformers`` model, or a
:class:`~deepspeed_tpu_torch.module_inject.state_dict_loader.
CheckpointModelView` over a flat state dict (files, or tensors made on the
card). Nothing here imports ``transformers``.

Each leaf is a new contiguous tensor on the device of the tensor it came
from (a model on the card converts on the card, with no host copy), cast
as JAX casts: to float32 first, then to the target dtype, so an fp16
checkpoint lands on the same bf16 bits as in JAX.

Weight-layout facts encoded below (verified against HF transformers):

* GPT-2 Conv1D stores ``[in, out]`` (y = x @ W); nn.Linear stores
  ``[out, in]`` (y = x @ W.T), transposed here to ``[in, out]``.
* GPT-NeoX / BLOOM fuse QKV per head: an ``[H, 3, D]`` interleave, not
  three stacked blocks as GPT-2.
* OPT's learned positional embedding carries a +2 offset
  (OPTLearnedPositionalEmbedding).
* GPT-Neo does NOT scale attention scores (attn_scale=1.0) and alternates
  global and local (windowed) attention layers.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Tuple, Type

import torch

from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig)

POLICIES: List[Type["HFPolicy"]] = []


def register_policy(cls):
    POLICIES.append(cls)
    return cls


def _t2j(t, dtype, transpose: bool = False) -> torch.Tensor:
    """A checkpoint tensor as a new contiguous tensor of ``dtype`` on its
    own device (transposed when asked): through float32 first, as JAX
    converts."""
    src = t.detach().float()
    if transpose:
        src = src.T
    return torch.empty(src.shape, dtype=dtype, device=src.device).copy_(src)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _ln(mod, dtype):
    return {"scale": _t2j(mod.weight, dtype), "bias": _t2j(mod.bias, dtype)}


def _linear_w(mod, dtype):
    """nn.Linear weight as [in, out]."""
    return _t2j(mod.weight, dtype, transpose=True)


def _owned(tree):
    """Every leaf contiguous and owning its storage (a slice of a fused
    projection is copied out, so the fused tensor can be freed)."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_owned(v) for v in tree]
    if tree.is_contiguous() and tree.storage_offset() == 0 and \
            tree.untyped_storage().nbytes() == tree.nbytes:
        return tree
    return tree.clone(memory_format=torch.contiguous_format)


class HFPolicy:
    """Base policy. Subclasses set ``model_types`` and implement convert."""
    model_types: Tuple[str, ...] = ()

    @classmethod
    def matches(cls, hf_config) -> bool:
        return getattr(hf_config, "model_type", None) in cls.model_types

    def convert(self, model, dtype) -> Tuple[InferenceTransformerConfig,
                                             Dict[str, Any]]:
        raise NotImplementedError


def convert_hf_model(model, dtype=torch.bfloat16):
    """Dispatch on the HF config's ``model_type`` (JAX
    ``convert_hf_model``)."""
    hf_cfg = getattr(model, "config", None)
    if hf_cfg is None:
        raise ValueError("expected a HF transformers model with .config")
    for pol in POLICIES:
        if pol.matches(hf_cfg):
            with torch.no_grad():
                cfg, params = pol().convert(model, dtype)
            return cfg, _owned(params)
    raise NotImplementedError(
        f"no policy for model_type={getattr(hf_cfg, 'model_type', '?')}; "
        f"supported: {sorted(t for p in POLICIES for t in p.model_types)}")


def _split_fused_stacked(W, b, E, H, D):
    """GPT-2 style fused qkv: [in, 3E] = [q | k | v] blocks."""
    wq = W[:, :E].reshape(E, H, D)
    wk = W[:, E:2 * E].reshape(E, H, D)
    wv = W[:, 2 * E:].reshape(E, H, D)
    bq = b[:E].reshape(H, D)
    bk = b[E:2 * E].reshape(H, D)
    bv = b[2 * E:].reshape(H, D)
    return wq, wk, wv, bq, bk, bv


def _split_fused_per_head(W, b, E, H, D):
    """GPT-NeoX / BLOOM fused qkv: [in, 3E] with per-head [H, 3, D] layout."""
    Wr = W.reshape(E, H, 3, D)
    br = b.reshape(H, 3, D)
    return (Wr[:, :, 0], Wr[:, :, 1], Wr[:, :, 2],
            br[:, 0], br[:, 1], br[:, 2])


def _attn_params(wq, wk, wv, bq, bk, bv, wo, bo):
    return {"wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
            "wo": wo, "bo": bo}


def _bias_or_zeros(mod, shape, dtype):
    """Module bias reshaped, or zeros when the checkpoint has none."""
    b = getattr(mod, "bias", None)
    if b is None:
        return _zeros(shape, dtype, mod.weight.device)
    return _t2j(b, dtype).reshape(shape)


def _separate_proj_attn(at, E, H, KH, D, dtype):
    """q/k/v/o as separate nn.Linear projections (llama-family layout)."""
    return _attn_params(
        _linear_w(at.q_proj, dtype).reshape(E, H, D),
        _linear_w(at.k_proj, dtype).reshape(E, KH, D),
        _linear_w(at.v_proj, dtype).reshape(E, KH, D),
        _bias_or_zeros(at.q_proj, (H, D), dtype),
        _bias_or_zeros(at.k_proj, (KH, D), dtype),
        _bias_or_zeros(at.v_proj, (KH, D), dtype),
        _linear_w(at.o_proj, dtype).reshape(H, D, E),
        _bias_or_zeros(at.o_proj, (E,), dtype))


@register_policy
class GPT2Policy(HFPolicy):
    model_types = ("gpt2",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.n_embd, hf.n_head, hf.n_layer
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.n_positions, n_embd=E,
            n_layer=L, n_head=H, activation=hf.activation_function,
            layer_norm_eps=hf.layer_norm_epsilon, dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.wte.weight, dtype),
                  "wpe": _t2j(tr.wpe.weight, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        for b in tr.h:
            W = _t2j(b.attn.c_attn.weight, dtype)        # Conv1D [E, 3E]
            bias = _t2j(b.attn.c_attn.bias, dtype)
            wq, wk, wv, bq, bk, bv = _split_fused_stacked(W, bias, E, H, D)
            wo = _t2j(b.attn.c_proj.weight, dtype).reshape(H, D, E)
            params["layers"].append({
                "ln1": _ln(b.ln_1, dtype), "ln2": _ln(b.ln_2, dtype),
                "attn": _attn_params(wq, wk, wv, bq, bk, bv, wo,
                                     _t2j(b.attn.c_proj.bias, dtype)),
                "mlp": {"wi": _t2j(b.mlp.c_fc.weight, dtype),
                        "bi": _t2j(b.mlp.c_fc.bias, dtype),
                        "wo": _t2j(b.mlp.c_proj.weight, dtype),
                        "bo": _t2j(b.mlp.c_proj.bias, dtype)}})
        return cfg, params


@register_policy
class GPTNeoPolicy(HFPolicy):
    model_types = ("gpt_neo",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_heads, hf.num_layers
        D = E // H
        windows = tuple(hf.window_size if t == "local" else None
                        for t in hf.attention_layers)
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H,
            intermediate_size=hf.intermediate_size or 4 * E,
            activation=hf.activation_function,
            layer_norm_eps=hf.layer_norm_epsilon,
            attn_scale=1.0,                 # GPT-Neo never scales scores
            local_windows=windows, dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.wte.weight, dtype),
                  "wpe": _t2j(tr.wpe.weight, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        zeros = _zeros((H, D), dtype, params["wte"].device)
        for b in tr.h:
            at = b.attn.attention
            params["layers"].append({
                "ln1": _ln(b.ln_1, dtype), "ln2": _ln(b.ln_2, dtype),
                "attn": _attn_params(
                    _linear_w(at.q_proj, dtype).reshape(E, H, D),
                    _linear_w(at.k_proj, dtype).reshape(E, H, D),
                    _linear_w(at.v_proj, dtype).reshape(E, H, D),
                    zeros, zeros, zeros,   # q/k/v_proj carry no bias
                    _linear_w(at.out_proj, dtype).reshape(H, D, E),
                    _t2j(at.out_proj.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.c_fc, dtype),
                        "bi": _t2j(b.mlp.c_fc.bias, dtype),
                        "wo": _linear_w(b.mlp.c_proj, dtype),
                        "bo": _t2j(b.mlp.c_proj.bias, dtype)}})
        return cfg, params


@register_policy
class OPTPolicy(HFPolicy):
    model_types = ("opt",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, hf.num_hidden_layers
        D = E // H
        if getattr(hf, "word_embed_proj_dim", E) != E:
            raise NotImplementedError("OPT word_embed_proj_dim != hidden")
        if not getattr(hf, "do_layer_norm_before", True):
            raise NotImplementedError("OPT do_layer_norm_before=False")
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, intermediate_size=hf.ffn_dim,
            activation=hf.activation_function, dtype=dtype)
        dec = model.model.decoder if hasattr(model, "model") else model.decoder
        params = {"wte": _t2j(dec.embed_tokens.weight, dtype),
                  # OPTLearnedPositionalEmbedding: position p reads row p+2
                  "wpe": _t2j(dec.embed_positions.weight, dtype)[2:],
                  "ln_f": _ln(dec.final_layer_norm, dtype), "layers": []}
        for b in dec.layers:
            at = b.self_attn
            params["layers"].append({
                "ln1": _ln(b.self_attn_layer_norm, dtype),
                "ln2": _ln(b.final_layer_norm, dtype),
                "attn": _attn_params(
                    _linear_w(at.q_proj, dtype).reshape(E, H, D),
                    _linear_w(at.k_proj, dtype).reshape(E, H, D),
                    _linear_w(at.v_proj, dtype).reshape(E, H, D),
                    _t2j(at.q_proj.bias, dtype).reshape(H, D),
                    _t2j(at.k_proj.bias, dtype).reshape(H, D),
                    _t2j(at.v_proj.bias, dtype).reshape(H, D),
                    _linear_w(at.out_proj, dtype).reshape(H, D, E),
                    _t2j(at.out_proj.bias, dtype)),
                "mlp": {"wi": _linear_w(b.fc1, dtype),
                        "bi": _t2j(b.fc1.bias, dtype),
                        "wo": _linear_w(b.fc2, dtype),
                        "bo": _t2j(b.fc2.bias, dtype)}})
        return cfg, params


@register_policy
class GPTJPolicy(HFPolicy):
    model_types = ("gptj",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.n_embd, hf.n_head, hf.n_layer
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.n_positions, n_embd=E,
            n_layer=L, n_head=H, positional="rotary",
            rotary_dim=hf.rotary_dim or D, rotary_interleaved=True,
            parallel_attn_mlp=True, activation=hf.activation_function,
            layer_norm_eps=hf.layer_norm_epsilon,
            tied_lm_head=not hasattr(model, "lm_head"), dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.wte.weight, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        if hasattr(model, "lm_head"):
            params["lm_head"] = _linear_w(model.lm_head, dtype)
            if model.lm_head.bias is not None:
                params["lm_head_bias"] = _t2j(model.lm_head.bias, dtype)
        dev = params["wte"].device
        zeros = _zeros((H, D), dtype, dev)
        for b in tr.h:
            at = b.attn
            params["layers"].append({
                "ln1": _ln(b.ln_1, dtype),   # shared by attn+mlp (no ln2)
                "attn": _attn_params(
                    _linear_w(at.q_proj, dtype).reshape(E, H, D),
                    _linear_w(at.k_proj, dtype).reshape(E, H, D),
                    _linear_w(at.v_proj, dtype).reshape(E, H, D),
                    zeros, zeros, zeros,
                    _linear_w(at.out_proj, dtype).reshape(H, D, E),
                    _zeros((E,), dtype, dev)),
                "mlp": {"wi": _linear_w(b.mlp.fc_in, dtype),
                        "bi": _t2j(b.mlp.fc_in.bias, dtype),
                        "wo": _linear_w(b.mlp.fc_out, dtype),
                        "bo": _t2j(b.mlp.fc_out.bias, dtype)}})
        return cfg, params


@register_policy
class GPTNeoXPolicy(HFPolicy):
    model_types = ("gpt_neox",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, hf.num_hidden_layers
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H,
            intermediate_size=hf.intermediate_size, positional="rotary",
            rotary_dim=int(D * hf.rotary_pct),
            rotary_base=getattr(hf, "rotary_emb_base", 10000.0),
            parallel_attn_mlp=bool(getattr(hf, "use_parallel_residual",
                                           True)),
            activation=hf.hidden_act, layer_norm_eps=hf.layer_norm_eps,
            tied_lm_head=not hasattr(model, "embed_out"), dtype=dtype)
        base = model.gpt_neox if hasattr(model, "gpt_neox") else model
        params = {"wte": _t2j(base.embed_in.weight, dtype),
                  "ln_f": _ln(base.final_layer_norm, dtype), "layers": []}
        if hasattr(model, "embed_out"):
            params["lm_head"] = _linear_w(model.embed_out, dtype)
        for b in base.layers:
            at = b.attention
            W = _linear_w(at.query_key_value, dtype)    # [E, 3E]
            bias = _t2j(at.query_key_value.bias, dtype)
            wq, wk, wv, bq, bk, bv = _split_fused_per_head(W, bias, E, H, D)
            params["layers"].append({
                "ln1": _ln(b.input_layernorm, dtype),
                "ln2": _ln(b.post_attention_layernorm, dtype),
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(at.dense, dtype).reshape(H, D, E),
                    _t2j(at.dense.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.dense_h_to_4h, dtype),
                        "bi": _t2j(b.mlp.dense_h_to_4h.bias, dtype),
                        "wo": _linear_w(b.mlp.dense_4h_to_h, dtype),
                        "bo": _t2j(b.mlp.dense_4h_to_h.bias, dtype)}})
        return cfg, params


@register_policy
class BLOOMPolicy(HFPolicy):
    model_types = ("bloom",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.n_head, hf.n_layer
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=2048, n_embd=E, n_layer=L,
            n_head=H, positional="alibi", activation="gelu_new",
            layer_norm_eps=hf.layer_norm_epsilon, dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.word_embeddings.weight, dtype),
                  "ln_emb": _ln(tr.word_embeddings_layernorm, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        for b in tr.h:
            at = b.self_attention
            W = _linear_w(at.query_key_value, dtype)
            bias = _t2j(at.query_key_value.bias, dtype)
            wq, wk, wv, bq, bk, bv = _split_fused_per_head(W, bias, E, H, D)
            params["layers"].append({
                "ln1": _ln(b.input_layernorm, dtype),
                "ln2": _ln(b.post_attention_layernorm, dtype),
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(at.dense, dtype).reshape(H, D, E),
                    _t2j(at.dense.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.dense_h_to_4h, dtype),
                        "bi": _t2j(b.mlp.dense_h_to_4h.bias, dtype),
                        "wo": _linear_w(b.mlp.dense_4h_to_h, dtype),
                        "bo": _t2j(b.mlp.dense_4h_to_h.bias, dtype)}})
        return cfg, params


@register_policy
class FalconPolicy(HFPolicy):
    """Falcon decoders, all four layouts: 7b-style (multi-query, parallel
    attn+MLP, one shared LN), 40b/180b "new decoder architecture" (GQA via
    ``num_kv_heads``, parallel with separate ln_attn/ln_mlp), Falcon2-11B
    (new arch with a single shared LN — ``num_ln_in_parallel_attn=1``),
    and falcon-rw (ALiBi, per-head fused QKV, sequential block). The fused
    ``query_key_value`` is stored GROUPED BY KV HEAD: each group is
    [q_per_group query heads | k | v] — the split below mirrors
    transformers' ``FalconAttention._split_heads``."""
    model_types = ("falcon",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, \
            hf.num_hidden_layers
        D = E // H
        new_arch = bool(getattr(hf, "new_decoder_architecture", False))
        multi_query = bool(getattr(hf, "multi_query", True))
        alibi = bool(getattr(hf, "alibi", False))
        if new_arch:
            KH = hf.num_kv_heads
        elif multi_query:
            KH = 1
        else:
            KH = H
        # HF's residual is parallel whenever new_decoder_architecture OR
        # parallel_attn; new_arch with parallel_attn=False is not a
        # constructible HF layout (its forward would crash)
        if new_arch and not bool(getattr(hf, "parallel_attn", True)):
            raise ValueError(
                "falcon config: new_decoder_architecture=True with "
                "parallel_attn=False is not a valid HF layout "
                "(FalconDecoderLayer cannot run it); fix the config")
        parallel = new_arch or bool(getattr(hf, "parallel_attn", True))
        use_bias = bool(getattr(hf, "bias", False))
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=getattr(hf, "max_position_embeddings", 2048),
            n_embd=E, n_layer=L, n_head=H, n_kv_head=KH,
            intermediate_size=getattr(hf, "ffn_hidden_size", None),
            positional=("alibi" if alibi else "rotary"),
            rotary_dim=(0 if alibi else D),
            rotary_base=getattr(hf, "rope_theta", 10000.0),
            activation="gelu", parallel_attn_mlp=parallel,
            layer_norm_eps=hf.layer_norm_epsilon,
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", True)),
            # Falcon scales (scores + alibi) jointly by 1/sqrt(D): its
            # effective alibi slopes carry the attention scale (BLOOM's
            # don't)
            alibi_scale=(D ** -0.5 if alibi else 1.0),
            dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.word_embeddings.weight, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        dev = params["wte"].device
        q_per = H // KH

        def split_grouped(at):
            """[E, KH*(q_per+2)*D] kv-grouped fused qkv → q/k/v (+biases)."""
            W = _linear_w(at.query_key_value, dtype)
            Wr = W.reshape(E, KH, q_per + 2, D)
            wq = Wr[:, :, :q_per].reshape(E, H, D)
            wk = Wr[:, :, q_per]
            wv = Wr[:, :, q_per + 1]
            if use_bias:
                br = _t2j(at.query_key_value.bias, dtype).reshape(
                    KH, q_per + 2, D)
                bq = br[:, :q_per].reshape(H, D)
                bk, bv = br[:, q_per], br[:, q_per + 1]
            else:
                bq, bk, bv = (_zeros((H, D), dtype, dev),
                              _zeros((KH, D), dtype, dev),
                              _zeros((KH, D), dtype, dev))
            return wq, wk, wv, bq, bk, bv

        for b in tr.h:
            at = b.self_attention
            wq, wk, wv, bq, bk, bv = split_grouped(at)
            bo = (_t2j(at.dense.bias, dtype) if use_bias
                  else _zeros((E,), dtype, dev))
            layer = {
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(at.dense, dtype).reshape(H, D, E), bo),
                "mlp": {
                    "wi": _linear_w(b.mlp.dense_h_to_4h, dtype),
                    "bi": (_t2j(b.mlp.dense_h_to_4h.bias, dtype)
                           if use_bias else _zeros((cfg.ffn,), dtype, dev)),
                    "wo": _linear_w(b.mlp.dense_4h_to_h, dtype),
                    "bo": (_t2j(b.mlp.dense_4h_to_h.bias, dtype)
                           if use_bias else _zeros((E,), dtype, dev)),
                },
            }
            if hasattr(b, "ln_attn"):
                # new-arch dual-LN parallel block (num_ln_in_parallel_attn
                # == 2); Falcon2-11B-style new-arch layers carry only
                # input_layernorm (shared-LN parallel) and land below
                layer["ln1"] = _ln(b.ln_attn, dtype)
                layer["ln2"] = _ln(b.ln_mlp, dtype)
            else:
                layer["ln1"] = _ln(b.input_layernorm, dtype)
                if not parallel:   # falcon-rw sequential block
                    layer["ln2"] = _ln(b.post_attention_layernorm, dtype)
            params["layers"].append(layer)
        return cfg, params


@register_policy
class GPTBigCodePolicy(HFPolicy):
    """GPT-BigCode / StarCoder family: GPT-2 block with nn.Linear
    projections (transposed vs Conv1D), gelu_pytorch_tanh, and packed
    attention of either flavor — multi-query ``[E q | D k | D v]`` blocks,
    or per-head ``[q|k|v]`` triples when multi_query=False — mirroring
    GPTBigCodeAttention's view/split."""
    model_types = ("gpt_bigcode",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.n_embd, hf.n_head, hf.n_layer
        D = E // H
        KH = 1 if bool(getattr(hf, "multi_query", True)) else H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.n_positions, n_embd=E,
            n_layer=L, n_head=H, n_kv_head=KH,
            activation=getattr(hf, "activation_function",
                               "gelu_pytorch_tanh"),
            layer_norm_eps=hf.layer_norm_epsilon,
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", True)),
            dtype=dtype)
        tr = model.transformer if hasattr(model, "transformer") else model
        params = {"wte": _t2j(tr.wte.weight, dtype),
                  "wpe": _t2j(tr.wpe.weight, dtype),
                  "ln_f": _ln(tr.ln_f, dtype), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        for b in tr.h:
            W = _linear_w(b.attn.c_attn, dtype)
            bias = _t2j(b.attn.c_attn.bias, dtype)
            if KH == 1:          # multi-query: [E q | D k | D v] blocks
                wq = W[:, :E].reshape(E, H, D)
                wk = W[:, E:E + D].reshape(E, 1, D)
                wv = W[:, E + D:].reshape(E, 1, D)
                bq = bias[:E].reshape(H, D)
                bk = bias[E:E + D].reshape(1, D)
                bv = bias[E + D:].reshape(1, D)
            else:                # per-head [q|k|v] triples
                wq, wk, wv, bq, bk, bv = _split_fused_per_head(
                    W, bias, E, H, D)
            params["layers"].append({
                "ln1": _ln(b.ln_1, dtype), "ln2": _ln(b.ln_2, dtype),
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(b.attn.c_proj, dtype).reshape(H, D, E),
                    _t2j(b.attn.c_proj.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.c_fc, dtype),
                        "bi": _t2j(b.mlp.c_fc.bias, dtype),
                        "wo": _linear_w(b.mlp.c_proj, dtype),
                        "bo": _t2j(b.mlp.c_proj.bias, dtype)}})
        return cfg, params


@register_policy
class PhiPolicy(HFPolicy):
    """Phi-1/1.5/2: GPT-J-style parallel attn+MLP sharing one LayerNorm,
    separate biased q/k/v/dense, PARTIAL non-interleaved rotary
    (``partial_rotary_factor``), biased untied LM head."""
    model_types = ("phi",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, \
            hf.num_hidden_layers
        D = E // H
        KH = getattr(hf, "num_key_value_heads", H) or H
        if getattr(hf, "qk_layernorm", False):
            raise NotImplementedError(
                "phi qk_layernorm=True (per-head q/k LayerNorms) is not "
                "supported by the fused transformer — refusing rather "
                "than silently diverging")
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, n_kv_head=KH,
            intermediate_size=hf.intermediate_size,
            positional="rotary",
            rotary_dim=int(D * getattr(hf, "partial_rotary_factor", 0.5)),
            rotary_base=getattr(hf, "rope_theta", 10000.0),
            activation=getattr(hf, "hidden_act", "gelu_new"),
            parallel_attn_mlp=True,
            layer_norm_eps=hf.layer_norm_eps,
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", False)),
            dtype=dtype)
        base = model.model if hasattr(model, "model") else model
        params = {"wte": _t2j(base.embed_tokens.weight, dtype),
                  "ln_f": _ln(base.final_layernorm, dtype), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        # lm_head's bias is unconditional in PhiForCausalLM — tying the
        # embeddings ties only the weight
        if getattr(model.lm_head, "bias", None) is not None:
            params["lm_head_bias"] = _t2j(model.lm_head.bias, dtype)
        for b in base.layers:
            at = b.self_attn
            params["layers"].append({
                "ln1": _ln(b.input_layernorm, dtype),  # shared (parallel)
                "attn": _attn_params(
                    _linear_w(at.q_proj, dtype).reshape(E, H, D),
                    _linear_w(at.k_proj, dtype).reshape(E, KH, D),
                    _linear_w(at.v_proj, dtype).reshape(E, KH, D),
                    _t2j(at.q_proj.bias, dtype).reshape(H, D),
                    _t2j(at.k_proj.bias, dtype).reshape(KH, D),
                    _t2j(at.v_proj.bias, dtype).reshape(KH, D),
                    _linear_w(at.dense, dtype).reshape(H, D, E),
                    _t2j(at.dense.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.fc1, dtype),
                        "bi": _t2j(b.mlp.fc1.bias, dtype),
                        "wo": _linear_w(b.mlp.fc2, dtype),
                        "bo": _t2j(b.mlp.fc2.bias, dtype)}})
        return cfg, params


@register_policy
class BertPolicy(HFPolicy):
    model_types = ("bert",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, hf.num_hidden_layers
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H,
            intermediate_size=hf.intermediate_size, pre_layer_norm=False,
            activation=hf.hidden_act, layer_norm_eps=hf.layer_norm_eps,
            dtype=dtype)
        base = model.bert if hasattr(model, "bert") else model
        emb = base.embeddings
        dev = emb.word_embeddings.weight.device
        params = {"wte": _t2j(emb.word_embeddings.weight, dtype),
                  "wpe": _t2j(emb.position_embeddings.weight, dtype),
                  "wtte": _t2j(emb.token_type_embeddings.weight, dtype),
                  "ln_emb": _ln(emb.LayerNorm, dtype),
                  "ln_f": {"scale": torch.ones((E,), dtype=dtype,
                                               device=dev),
                           "bias": _zeros((E,), dtype, dev)},
                  "layers": []}
        for b in base.encoder.layer:
            sa = b.attention.self
            params["layers"].append({
                "ln1": _ln(b.attention.output.LayerNorm, dtype),
                "ln2": _ln(b.output.LayerNorm, dtype),
                "attn": _attn_params(
                    _linear_w(sa.query, dtype).reshape(E, H, D),
                    _linear_w(sa.key, dtype).reshape(E, H, D),
                    _linear_w(sa.value, dtype).reshape(E, H, D),
                    _t2j(sa.query.bias, dtype).reshape(H, D),
                    _t2j(sa.key.bias, dtype).reshape(H, D),
                    _t2j(sa.value.bias, dtype).reshape(H, D),
                    _linear_w(b.attention.output.dense,
                              dtype).reshape(H, D, E),
                    _t2j(b.attention.output.dense.bias, dtype)),
                "mlp": {"wi": _linear_w(b.intermediate.dense, dtype),
                        "bi": _t2j(b.intermediate.dense.bias, dtype),
                        "wo": _linear_w(b.output.dense, dtype),
                        "bo": _t2j(b.output.dense.bias, dtype)}})
        return cfg, params


@register_policy
class DistilBertPolicy(HFPolicy):
    model_types = ("distilbert",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.dim, hf.n_heads, hf.n_layers
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, intermediate_size=hf.hidden_dim,
            pre_layer_norm=False, activation=hf.activation,
            layer_norm_eps=1e-12, dtype=dtype)
        base = (model.distilbert if hasattr(model, "distilbert") else model)
        emb = base.embeddings
        dev = emb.word_embeddings.weight.device
        params = {"wte": _t2j(emb.word_embeddings.weight, dtype),
                  "wpe": _t2j(emb.position_embeddings.weight, dtype),
                  "ln_emb": _ln(emb.LayerNorm, dtype),
                  "ln_f": {"scale": torch.ones((E,), dtype=dtype,
                                               device=dev),
                           "bias": _zeros((E,), dtype, dev)},
                  "layers": []}
        for b in base.transformer.layer:
            at = b.attention
            params["layers"].append({
                "ln1": _ln(b.sa_layer_norm, dtype),
                "ln2": _ln(b.output_layer_norm, dtype),
                "attn": _attn_params(
                    _linear_w(at.q_lin, dtype).reshape(E, H, D),
                    _linear_w(at.k_lin, dtype).reshape(E, H, D),
                    _linear_w(at.v_lin, dtype).reshape(E, H, D),
                    _t2j(at.q_lin.bias, dtype).reshape(H, D),
                    _t2j(at.k_lin.bias, dtype).reshape(H, D),
                    _t2j(at.v_lin.bias, dtype).reshape(H, D),
                    _linear_w(at.out_lin, dtype).reshape(H, D, E),
                    _t2j(at.out_lin.bias, dtype)),
                "mlp": {"wi": _linear_w(b.ffn.lin1, dtype),
                        "bi": _t2j(b.ffn.lin1.bias, dtype),
                        "wo": _linear_w(b.ffn.lin2, dtype),
                        "bo": _t2j(b.ffn.lin2.bias, dtype)}})
        return cfg, params


@register_policy
class CLIPTextPolicy(HFPolicy):
    """CLIP text encoder: causal pre-LN trunk, quick_gelu, learned
    positions, no LM head — forward returns final hidden states."""
    model_types = ("clip", "clip_text_model")

    def convert(self, model, dtype):
        hf = model.config
        if getattr(hf, "model_type", None) == "clip":
            # full CLIPModel: take the text tower
            tc = hf.text_config
            if isinstance(tc, dict):
                tc = SimpleNamespace(**tc)
            hf = tc
        E = hf.hidden_size
        H = hf.num_attention_heads
        L = hf.num_hidden_layers
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings, n_embd=E, n_layer=L,
            n_head=H, intermediate_size=hf.intermediate_size,
            activation=getattr(hf, "hidden_act", "quick_gelu"),
            layer_norm_eps=getattr(hf, "layer_norm_eps", 1e-5),
            head="none", tied_lm_head=True, dtype=dtype)
        base = model.text_model if hasattr(model, "text_model") else model
        emb = base.embeddings
        params = {"wte": _t2j(emb.token_embedding.weight, dtype),
                  "wpe": _t2j(emb.position_embedding.weight, dtype),
                  "ln_f": _ln(base.final_layer_norm, dtype),
                  "layers": []}
        for b in base.encoder.layers:
            at = b.self_attn
            params["layers"].append({
                "ln1": _ln(b.layer_norm1, dtype),
                "ln2": _ln(b.layer_norm2, dtype),
                "attn": _attn_params(
                    _linear_w(at.q_proj, dtype).reshape(E, H, D),
                    _linear_w(at.k_proj, dtype).reshape(E, H, D),
                    _linear_w(at.v_proj, dtype).reshape(E, H, D),
                    _t2j(at.q_proj.bias, dtype).reshape(H, D),
                    _t2j(at.k_proj.bias, dtype).reshape(H, D),
                    _t2j(at.v_proj.bias, dtype).reshape(H, D),
                    _linear_w(at.out_proj, dtype).reshape(H, D, E),
                    _t2j(at.out_proj.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.fc1, dtype),
                        "bi": _t2j(b.mlp.fc1.bias, dtype),
                        "wo": _linear_w(b.mlp.fc2, dtype),
                        "bo": _t2j(b.mlp.fc2.bias, dtype)}})
        return cfg, params


@register_policy
class LlamaPolicy(HFPolicy):
    """LLaMA / Mistral / Qwen2-style decoders: RMSNorm, SwiGLU gated MLP,
    non-interleaved full-dim rotary at ``rope_theta``, GQA via
    ``num_key_value_heads``, untied LM head. Qwen2's always-on q/k/v
    biases come through the module-level bias reader."""
    model_types = ("llama", "mistral", "qwen2")

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, \
            hf.num_hidden_layers
        # head_dim may be decoupled from E // H (Mistral-Nemo: 128-dim
        # heads on a 5120/32 trunk)
        D = getattr(hf, "head_dim", None) or E // H
        KH = getattr(hf, "num_key_value_heads", H) or H
        # Mistral's sliding-window attention maps onto the per-layer
        # local_windows (GPT-Neo uses the same); Qwen2 carries a
        # sliding_window value that is INERT unless use_sliding_window,
        # and even then only layers >= max_window_layers slide — newer
        # configs expose that per-layer plan as layer_types
        window = getattr(hf, "sliding_window", None)
        if not getattr(hf, "use_sliding_window", True):
            window = None
        local_windows = None
        if window is not None:
            layer_types = getattr(hf, "layer_types", None)
            if layer_types is not None:
                local_windows = tuple(
                    int(window) if t == "sliding_attention" else None
                    for t in layer_types)
            else:
                # older configs without layer_types: honor
                # max_window_layers (layers below it run full attention)
                mwl = getattr(hf, "max_window_layers", 0) or 0
                local_windows = tuple(
                    None if i < mwl else int(window) for i in range(L))
            if not any(w is not None for w in local_windows):
                local_windows = None
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, n_kv_head=KH,
            explicit_head_dim=(D if D != E // H else None),
            intermediate_size=hf.intermediate_size,
            positional="rotary", rotary_dim=D,
            rotary_base=getattr(hf, "rope_theta", 10000.0),
            activation="silu", norm_type="rmsnorm", gated_mlp=True,
            layer_norm_eps=hf.rms_norm_eps,
            local_windows=local_windows,
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", False)),
            dtype=dtype, **self._cfg_overrides(hf))
        base = model.model if hasattr(model, "model") else model
        params = {
            "wte": _t2j(base.embed_tokens.weight, dtype),
            "ln_f": {"scale": _t2j(base.norm.weight, dtype)},
            "layers": [],
        }
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)

        def bias(mod, shape):
            # attention_bias/mlp_bias checkpoints carry real bias
            # tensors; the common bias-less case maps to zeros
            return _bias_or_zeros(mod, shape, dtype)

        for b in base.layers:
            params["layers"].append({
                "ln1": {"scale": _t2j(b.input_layernorm.weight, dtype)},
                "ln2": {"scale": _t2j(b.post_attention_layernorm.weight,
                                      dtype)},
                "attn": _separate_proj_attn(b.self_attn, E, H, KH, D,
                                            dtype),
                **self._ffn_params(b, cfg, dtype, bias)})
        return cfg, params

    @staticmethod
    def _cfg_overrides(hf) -> dict:
        return {}

    @staticmethod
    def _ffn_params(b, cfg, dtype, bias) -> dict:
        E = cfg.n_embd
        return {"mlp": {"wg": _linear_w(b.mlp.gate_proj, dtype),
                        "bg": bias(b.mlp.gate_proj, (cfg.ffn,)),
                        "wi": _linear_w(b.mlp.up_proj, dtype),
                        "bi": bias(b.mlp.up_proj, (cfg.ffn,)),
                        "wo": _linear_w(b.mlp.down_proj, dtype),
                        "bo": bias(b.mlp.down_proj, (E,))}}


@register_policy
class MptPolicy(HFPolicy):
    """MPT: ALiBi decoder with bias-less everything — fused Wqkv in
    [q|k|v] blocks, bias-less LayerNorms, exact-gelu MLP. MPT adds the
    (unscaled) alibi AFTER the score scale, i.e. BLOOM semantics
    (alibi_scale=1.0); its slope formula equals BLOOM's for power-of-two
    head counts (all released MPT models), so other head counts are
    refused."""
    model_types = ("mpt",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.d_model, hf.n_heads, hf.n_layers
        D = E // H
        if H & (H - 1):
            raise NotImplementedError(
                "mpt with a non-power-of-two head count uses a different "
                "ALiBi slope cut than BLOOM — unsupported")
        ac = getattr(hf, "attn_config", None)
        if getattr(ac, "clip_qkv", None):
            raise NotImplementedError("mpt attn_config.clip_qkv is not "
                                      "supported by the fused transformer")
        tr = model.transformer if hasattr(model, "transformer") else model
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=getattr(hf, "max_seq_len", 2048),
            n_embd=E, n_layer=L, n_head=H, positional="alibi",
            # the ffn width from the module, not hf.expansion_ratio:
            # transformers' MptMLP hardcodes 4E and ignores the field
            intermediate_size=int(
                tr.blocks[0].ffn.up_proj.weight.shape[0]),
            activation="gelu",
            # HF honors attn_config.softmax_scale when set
            attn_scale=getattr(ac, "softmax_scale", None),
            layer_norm_eps=getattr(hf, "layer_norm_epsilon", 1e-5),
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", True)),
            dtype=dtype)

        def ln(mod):   # MPT LayerNorms typically carry no bias
            return {"scale": _t2j(mod.weight, dtype),
                    "bias": _bias_or_zeros(mod, (E,), dtype)}

        params = {"wte": _t2j(tr.wte.weight, dtype),
                  "ln_f": ln(tr.norm_f), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        dev = params["wte"].device
        zeros3 = _zeros((3 * E,), dtype, dev)
        for b in tr.blocks:
            W = _linear_w(b.attn.Wqkv, dtype)           # [E, 3E] blocks
            wq, wk, wv, bq, bk, bv = _split_fused_stacked(
                W, zeros3, E, H, D)
            params["layers"].append({
                "ln1": ln(b.norm_1), "ln2": ln(b.norm_2),
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(b.attn.out_proj, dtype).reshape(H, D, E),
                    _zeros((E,), dtype, dev)),
                "mlp": {"wi": _linear_w(b.ffn.up_proj, dtype),
                        "bi": _zeros((cfg.ffn,), dtype, dev),
                        "wo": _linear_w(b.ffn.down_proj, dtype),
                        "bo": _zeros((E,), dtype, dev)}})
        return cfg, params


@register_policy
class Starcoder2Policy(HFPolicy):
    """StarCoder2: rotary + GQA with plain LayerNorms and a biased
    non-gated gelu_pytorch_tanh MLP — the llama attention layout with
    gpt-style norms/FFN."""
    model_types = ("starcoder2",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, \
            hf.num_hidden_layers
        D = getattr(hf, "head_dim", None) or E // H
        KH = getattr(hf, "num_key_value_heads", H) or H
        window = getattr(hf, "sliding_window", None)
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, n_kv_head=KH,
            explicit_head_dim=(D if D != E // H else None),
            intermediate_size=hf.intermediate_size,
            positional="rotary", rotary_dim=D,
            rotary_base=getattr(hf, "rope_theta", 10000.0),
            activation=getattr(hf, "hidden_act", "gelu_pytorch_tanh"),
            layer_norm_eps=getattr(hf, "norm_epsilon", 1e-5),
            local_windows=((int(window),) * L if window else None),
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", True)),
            dtype=dtype)
        base = model.model if hasattr(model, "model") else model
        params = {"wte": _t2j(base.embed_tokens.weight, dtype),
                  "ln_f": _ln(base.norm, dtype), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        for b in base.layers:
            params["layers"].append({
                "ln1": _ln(b.input_layernorm, dtype),
                "ln2": _ln(b.post_attention_layernorm, dtype),
                "attn": _separate_proj_attn(b.self_attn, E, H, KH, D,
                                            dtype),
                "mlp": {"wi": _linear_w(b.mlp.c_fc, dtype),
                        "bi": _bias_or_zeros(b.mlp.c_fc, (cfg.ffn,),
                                             dtype),
                        "wo": _linear_w(b.mlp.c_proj, dtype),
                        "bo": _bias_or_zeros(b.mlp.c_proj, (E,),
                                             dtype)}})
        return cfg, params


@register_policy
class GemmaPolicy(HFPolicy):
    """Gemma: a llama-shaped decoder with three quirks, each folded in at
    conversion — input embeddings scale by sqrt(E) (the tied head reads
    the RAW table → ``embed_scale``), GemmaRMSNorm multiplies by (1 + w)
    (the +1 folds into the stored scale), and head_dim is a config field
    of its own (``explicit_head_dim``; Gemma-7b runs 256-dim heads on a
    3072/16 trunk). Gated gelu_pytorch_tanh MLP."""
    model_types = ("gemma",)

    def convert(self, model, dtype):
        hf = model.config
        E, H, L = hf.hidden_size, hf.num_attention_heads, \
            hf.num_hidden_layers
        D = getattr(hf, "head_dim", E // H)
        KH = getattr(hf, "num_key_value_heads", H) or H
        # transformers' GemmaMLP reads hidden_act (the hidden_activation
        # field is legacy and ignored there)
        act = (getattr(hf, "hidden_act", None)
               or getattr(hf, "hidden_activation", "gelu_pytorch_tanh"))
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings,
            n_embd=E, n_layer=L, n_head=H, n_kv_head=KH,
            explicit_head_dim=(D if D != E // H else None),
            intermediate_size=hf.intermediate_size,
            positional="rotary", rotary_dim=D,
            rotary_base=getattr(hf, "rope_theta", 10000.0),
            activation=act, norm_type="rmsnorm", gated_mlp=True,
            layer_norm_eps=hf.rms_norm_eps,
            tied_lm_head=bool(getattr(hf, "tie_word_embeddings", True)),
            embed_scale=float(E) ** 0.5,
            dtype=dtype)
        base = model.model if hasattr(model, "model") else model

        def rms(mod):
            # GemmaRMSNorm computes x * (1 + w) with the add in fp32: fold
            # the +1 in fp32 and store fp32, as JAX does
            return {"scale": _t2j(mod.weight, torch.float32) + 1.0}

        params = {"wte": _t2j(base.embed_tokens.weight, dtype),
                  "ln_f": rms(base.norm), "layers": []}
        if not cfg.tied_lm_head:
            params["lm_head"] = _linear_w(model.lm_head, dtype)
        dev = params["wte"].device
        for b in base.layers:
            params["layers"].append({
                "ln1": rms(b.input_layernorm),
                "ln2": rms(b.post_attention_layernorm),
                "attn": _separate_proj_attn(b.self_attn, E, H, KH, D,
                                            dtype),
                "mlp": {"wg": _linear_w(b.mlp.gate_proj, dtype),
                        "bg": _zeros((cfg.ffn,), dtype, dev),
                        "wi": _linear_w(b.mlp.up_proj, dtype),
                        "bi": _zeros((cfg.ffn,), dtype, dev),
                        "wo": _linear_w(b.mlp.down_proj, dtype),
                        "bo": _zeros((E,), dtype, dev)}})
        return cfg, params


@register_policy
class MixtralPolicy(LlamaPolicy):
    """Mixtral sparse-MoE decoders: the LLaMA attention/norm layout with
    top-k gated-SwiGLU experts in every FFN slot
    (``block_sparse_moe.gate`` + per-expert ``w1/w2/w3``). It converts;
    the engine refuses MoE layers until they are ported (ROADMAP.md queue
    C, A8)."""
    model_types = ("mixtral",)

    @staticmethod
    def _cfg_overrides(hf) -> dict:
        return {"num_experts": hf.num_local_experts,
                "moe_top_k": getattr(hf, "num_experts_per_tok", 2)}

    @staticmethod
    def _ffn_params(b, cfg, dtype, bias) -> dict:
        moe = b.block_sparse_moe

        def stack(ws):   # per-expert [out, in] Linears → [X, in, out]
            return torch.stack([_linear_w(w, dtype) for w in ws])
        return {"moe": {
            "gate": _linear_w(moe.gate, dtype),
            "experts": {
                "wg": stack([e.w1 for e in moe.experts]),
                "wo": stack([e.w2 for e in moe.experts]),
                "wi": stack([e.w3 for e in moe.experts]),
            }}}


@register_policy
class MegatronGPT2Policy(HFPolicy):
    """Megatron-LM GPT-2: pre-LN, per-head fused QKV, learned positions.
    Megatron release checkpoints carry no config.json — serve them through
    the state-dict loader with a config ``{"model_type": "megatron-gpt2",
    "hidden_size": ..., "num_layers": ..., "num_attention_heads": ...,
    "vocab_size": ..., "max_position_embeddings": ...}``."""
    model_types = ("megatron-gpt2", "megatron_gpt2")

    def convert(self, model, dtype):
        hf = model.config
        E = hf.hidden_size
        H = hf.num_attention_heads
        L = getattr(hf, "num_layers", None) or hf.num_hidden_layers
        D = E // H
        cfg = InferenceTransformerConfig(
            vocab_size=hf.vocab_size,
            n_positions=hf.max_position_embeddings, n_embd=E, n_layer=L,
            n_head=H,
            intermediate_size=getattr(hf, "ffn_hidden_size", None) or 4 * E,
            activation="gelu", layer_norm_eps=getattr(
                hf, "layernorm_epsilon", 1e-5),
            tied_lm_head=True, dtype=dtype)
        base = (model.language_model if hasattr(model, "language_model")
                else model)
        emb = base.embedding
        trunk = (base.transformer if hasattr(base, "transformer")
                 else base.encoder)
        params = {"wte": _t2j(emb.word_embeddings.weight, dtype),
                  "wpe": _t2j(emb.position_embeddings.weight, dtype),
                  "ln_f": _ln(trunk.final_layernorm, dtype),
                  "layers": []}
        # the fused-QKV layout changed at Megatron checkpoint_version 2.0:
        # older checkpoints stack [3, H, D] on the out dim (q block, k
        # block, v block), newer interleave per head [H, 3, D]
        v2 = float(getattr(hf, "checkpoint_version", 2.0)) >= 2.0
        split = _split_fused_per_head if v2 else _split_fused_stacked
        for b in trunk.layers:
            at = b.attention if hasattr(b, "attention") else b.self_attention
            W = _linear_w(at.query_key_value, dtype)      # [E, 3E]
            bias = _t2j(at.query_key_value.bias, dtype)
            wq, wk, wv, bq, bk, bv = split(W, bias, E, H, D)
            params["layers"].append({
                "ln1": _ln(b.input_layernorm, dtype),
                "ln2": _ln(b.post_attention_layernorm, dtype),
                "attn": _attn_params(
                    wq, wk, wv, bq, bk, bv,
                    _linear_w(at.dense, dtype).reshape(H, D, E),
                    _t2j(at.dense.bias, dtype)),
                "mlp": {"wi": _linear_w(b.mlp.dense_h_to_4h, dtype),
                        "bi": _t2j(b.mlp.dense_h_to_4h.bias, dtype),
                        "wo": _linear_w(b.mlp.dense_4h_to_h, dtype),
                        "bo": _t2j(b.mlp.dense_4h_to_h.bias, dtype)}})
        return cfg, params
