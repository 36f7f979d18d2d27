"""Train-here → serve-here bridge.

Counterpart of ``deepspeed_tpu/module_inject/from_training.py``. The
reference's ``init_inference(model)`` injects fused kernels into the SAME
torch module that was trained; here the training GPT-2 keeps a flat dict
of weights and the inference engine a nested one, so the bridge is a tree
conversion: ``convert_trained_model(model, params)`` maps a
``GPT2LMModel`` or ``LlamaLMModel`` and its trained params onto
``(InferenceTransformerConfig, params)``, which ``init_inference`` takes
as it is. Every leaf is a copy on the params' device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig)
from deepspeed_tpu_torch.utils.unported import not_ported


def _f(x: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy in ``dtype``, detached from the training
    tensor (a later step must not move the served weights)."""
    return torch.empty(x.shape, dtype=dtype, device=x.device).copy_(
        x.detach())


def convert_trained_model(model, params, dtype=None
                          ) -> Tuple[InferenceTransformerConfig,
                                     Dict[str, Any]]:
    """Dispatch on the training-model wrapper type."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel
    from deepspeed_tpu_torch.models.llama import LlamaLMModel
    if isinstance(model, GPT2LMModel):
        return gpt2_to_inference(model.config, params, dtype)
    if isinstance(model, LlamaLMModel):
        return llama_to_inference(model.config, params, dtype)
    raise NotImplementedError(
        f"no training->inference conversion for {type(model).__name__}; "
        "supported: GPT2LMModel, LlamaLMModel")


def gpt2_to_inference(cfg, params, dtype=None):
    """The port's flat GPT-2 training params (``h_{i}.attn.c_attn.kernel``,
    ...) → the inference tree (GPT2Policy layout: the fused c_attn [C, 3C]
    splits into q|k|v thirds; the tied LM head is wte). The padded
    vocabulary rows are stripped, and ``layer_norm_eps`` is the training
    model's 1e-6 (flax's LayerNorm default), not HF's 1e-5."""
    if getattr(cfg, "num_experts", 0) > 0:
        raise NotImplementedError(not_ported("converting an MoE GPT-2", "A8"))
    dt = dtype or cfg.dtype
    E, H = cfg.n_embd, cfg.n_head
    D = E // H
    V = cfg.vocab_size
    icfg = InferenceTransformerConfig(
        vocab_size=V, n_positions=cfg.n_positions, n_embd=E,
        n_layer=cfg.n_layer, n_head=H, activation="gelu_new",
        layer_norm_eps=1e-6, dtype=dt)
    out: Dict[str, Any] = {
        # strip the padding rows: inference sizes from vocab_size
        "wte": _f(params["wte"][:V], dt),
        "wpe": _f(params["wpe"], dt),
        "ln_f": {"scale": _f(params["ln_f.scale"], dt),
                 "bias": _f(params["ln_f.bias"], dt)},
        "layers": [],
    }
    for i in range(cfg.n_layer):
        h = f"h_{i}."
        W = params[h + "attn.c_attn.kernel"]     # [C, 3C]
        b = params[h + "attn.c_attn.bias"]
        out["layers"].append({
            "ln1": {"scale": _f(params[h + "ln_1.scale"], dt),
                    "bias": _f(params[h + "ln_1.bias"], dt)},
            "ln2": {"scale": _f(params[h + "ln_2.scale"], dt),
                    "bias": _f(params[h + "ln_2.bias"], dt)},
            "attn": {
                "wq": _f(W[:, :E], dt).reshape(E, H, D),
                "wk": _f(W[:, E:2 * E], dt).reshape(E, H, D),
                "wv": _f(W[:, 2 * E:], dt).reshape(E, H, D),
                "bq": _f(b[:E], dt).reshape(H, D),
                "bk": _f(b[E:2 * E], dt).reshape(H, D),
                "bv": _f(b[2 * E:], dt).reshape(H, D),
                "wo": _f(params[h + "attn.c_proj.kernel"], dt
                         ).reshape(H, D, E),
                "bo": _f(params[h + "attn.c_proj.bias"], dt),
            },
            "mlp": {"wi": _f(params[h + "mlp.c_fc.kernel"], dt),
                    "bi": _f(params[h + "mlp.c_fc.bias"], dt),
                    "wo": _f(params[h + "mlp.c_proj.kernel"], dt),
                    "bo": _f(params[h + "mlp.c_proj.bias"], dt)},
        })
    return icfg, out


def llama_to_inference(cfg, params, dtype=None):
    """The port's flat LLaMA training params (``layers_{i}.attn.wq.kernel``,
    ...) → the inference tree (LlamaPolicy layout): zero biases, ``wk`` /
    ``wv`` as ``[E, KH, D]``, the untied head transposed to ``[C, V]``
    (training keeps it ``[V, C]``), rotary at the full head dim."""
    if cfg.num_experts > 0:
        raise NotImplementedError(not_ported("converting an MoE LLaMA", "A8"))
    dt = dtype or cfg.dtype
    E, H, KH = cfg.n_embd, cfg.n_head, cfg.n_kv_head
    D = cfg.head_dim
    Fh = cfg.intermediate_size
    icfg = InferenceTransformerConfig(
        vocab_size=cfg.vocab_size, n_positions=cfg.n_positions, n_embd=E,
        n_layer=cfg.n_layer, n_head=H, n_kv_head=KH,
        intermediate_size=Fh, positional="rotary", rotary_dim=D,
        rotary_base=cfg.rope_theta, activation="silu",
        norm_type="rmsnorm", gated_mlp=True,
        layer_norm_eps=cfg.rms_eps,
        tied_lm_head=cfg.tie_embeddings,
        # inert without experts; set as JAX sets them
        moe_top_k=cfg.moe_top_k, moe_renormalize=cfg.moe_top_k != 1,
        dtype=dt)
    dev = params["embed"].device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    out: Dict[str, Any] = {
        "wte": _f(params["embed"], dt),
        "ln_f": {"scale": _f(params["ln_f"], dt)},
        "layers": [],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _f(params["lm_head"].t(), dt)
    for i in range(cfg.n_layer):
        p = f"layers_{i}."
        out["layers"].append({
            "ln1": {"scale": _f(params[p + "ln_attn"], dt)},
            "ln2": {"scale": _f(params[p + "ln_mlp"], dt)},
            "attn": {
                "wq": _f(params[p + "attn.wq.kernel"], dt).reshape(E, H, D),
                "wk": _f(params[p + "attn.wk.kernel"], dt).reshape(E, KH, D),
                "wv": _f(params[p + "attn.wv.kernel"], dt).reshape(E, KH, D),
                "bq": zeros(H, D), "bk": zeros(KH, D), "bv": zeros(KH, D),
                "wo": _f(params[p + "attn.wo.kernel"], dt).reshape(H, D, E),
                "bo": zeros(E),
            },
            "mlp": {"wg": _f(params[p + "mlp.gate.kernel"], dt),
                    "bg": zeros(Fh),
                    "wi": _f(params[p + "mlp.up.kernel"], dt),
                    "bi": zeros(Fh),
                    "wo": _f(params[p + "mlp.down.kernel"], dt),
                    "bo": zeros(E)},
        })
    return icfg, out
