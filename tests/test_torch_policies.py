"""The port's policy table (``deepspeed_tpu_torch/module_inject/policies.py``)
against the JAX package's on the CPU.

Each architecture of JAX's ``tests/test_module_inject.py`` is built as a
tiny random-init ``transformers`` model (no download; seeded, 2 layers,
widths of 32) and converted by both packages in float32:

* the port's tree equals ``params_from_numpy`` of JAX's exactly (the
  conversion is copies, transposes and casts of the same values), and its
  config equals JAX's field for field;
* the same tree reached through a ``CheckpointModelView`` over the model's
  state dict (the route of checkpoint files) equals the live model's;
* ``causal_forward`` / ``encoder_forward`` on T = 32 seeded tokens (so a
  wrong rotary base shows) agree with JAX's within 1e-4 x max(1, max
  |logit|): the same float32 function summed in another order;
* greedy ``generate`` gives JAX's tokens for GPT-2, Llama with 2 KV heads,
  Falcon 40b, BLOOM and GPT-Neo (local + global).

Mixtral converts to JAX's tree and the engine refuses its MoE layers; an
unknown ``model_type`` and ``injection_policy`` raise JAX's errors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.module_inject import policies as jpol
from deepspeed_tpu.module_inject.state_dict_loader import (
    CheckpointModelView as JaxView)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.module_inject import policies as tpol
from deepspeed_tpu_torch.module_inject.state_dict_loader import (
    CheckpointModelView)

V, T = 128, 32
REL_TOL = 1e-4


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))


def _gpt_neo():
    return transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        num_layers=2, num_heads=4, attention_types=[[["global", "local"], 1]],
        window_size=4, resid_dropout=0.0, embed_dropout=0.0,
        attention_dropout=0.0))


def _opt():
    return transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, ffn_dim=64,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0))


def _gptj():
    return transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        rotary_dim=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))


def _neox(parallel):
    return transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        rotary_pct=0.5, use_parallel_residual=parallel,
        hidden_dropout=0.0, attention_dropout=0.0))


def _bloom():
    return transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=V, hidden_size=32, n_layer=2, n_head=4,
        hidden_dropout=0.0, attention_dropout=0.0))


def _bert():
    return transformers.BertModel(transformers.BertConfig(
        vocab_size=V, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))


def _distilbert():
    return transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=V, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0))


def _clip():
    return transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64))


def _llama(kv_heads, **kw):
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, rms_norm_eps=1e-6,
        attention_dropout=0.0, tie_word_embeddings=False, **kw))


def _llama_bias():
    hf = _llama(4, attention_bias=True, mlp_bias=True)
    with torch.no_grad():   # HF zero-inits biases: make them count
        for lyr in hf.model.layers:
            lyr.self_attn.q_proj.bias.normal_()
            lyr.mlp.gate_proj.bias.normal_()
    return hf


def _mistral(**kw):
    kw = {"num_key_value_heads": 2, "sliding_window": None, **kw}
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        attention_dropout=0.0, **kw))


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2,
        attention_dropout=0.0, sliding_window=None,
        tie_word_embeddings=False))


def _falcon(layout, bias=False):
    kw = dict(vocab_size=V, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, bias=bias, max_position_embeddings=64,
              attention_dropout=0.0, hidden_dropout=0.0)
    if layout == "7b":
        kw.update(multi_query=True, parallel_attn=True,
                  new_decoder_architecture=False, alibi=False)
    elif layout == "40b":
        kw.update(new_decoder_architecture=True, num_kv_heads=2,
                  alibi=False)
    elif layout == "11b":   # new arch, one shared LayerNorm
        kw.update(new_decoder_architecture=True, num_kv_heads=2,
                  num_ln_in_parallel_attn=1, parallel_attn=True,
                  alibi=False)
    else:
        kw.update(multi_query=False, parallel_attn=False,
                  new_decoder_architecture=False, alibi=True)
    hf = transformers.FalconForCausalLM(transformers.FalconConfig(**kw))
    if bias:
        with torch.no_grad():
            for blk in hf.transformer.h:
                for m in (blk.self_attention.query_key_value,
                          blk.self_attention.dense, blk.mlp.dense_h_to_4h,
                          blk.mlp.dense_4h_to_h):
                    m.bias.normal_(0, 0.1)
    return hf


def _qwen2():
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-6, use_sliding_window=False,
        sliding_window=4, attention_dropout=0.0,
        tie_word_embeddings=False))
    with torch.no_grad():
        for layer in hf.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0, 0.1)
    return hf


def _phi(**kw):
    return transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        partial_rotary_factor=0.5, resid_pdrop=0.0, embd_pdrop=0.0,
        attention_dropout=0.0, tie_word_embeddings=False, **kw))


def _bigcode(mq):
    return transformers.GPTBigCodeForCausalLM(transformers.GPTBigCodeConfig(
        vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        multi_query=mq, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))


def _gemma(head_dim):
    return transformers.GemmaForCausalLM(transformers.GemmaConfig(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=head_dim, rms_norm_eps=1e-6,
        attention_dropout=0.0))


def _starcoder2():
    hf = transformers.Starcoder2ForCausalLM(transformers.Starcoder2Config(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, sliding_window=None, use_bias=True,
        embedding_dropout=0.0, residual_dropout=0.0,
        attention_dropout=0.0))
    with torch.no_grad():
        for layer in hf.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj, layer.self_attn.o_proj,
                         layer.mlp.c_fc, layer.mlp.c_proj):
                if proj.bias is not None:
                    proj.bias.normal_(0, 0.1)
    return hf


def _mpt(**kw):
    return transformers.MptForCausalLM(transformers.MptConfig(
        vocab_size=V, d_model=32, n_layers=2, n_heads=4, max_seq_len=64,
        attn_config={"attn_pdrop": 0.0}, emb_pdrop=0.0, resid_pdrop=0.0,
        **kw))


class _Megatron:
    """A Megatron-LM GPT-2 state dict (numpy, as a Megatron checkpoint
    merges) with the config a user writes for it; per-head fused QKV."""

    def __init__(self):
        E, H, L, P = 32, 4, 2, 64
        rs = np.random.RandomState(0)

        def w(*shape):
            return (rs.randn(*shape) * 0.2).astype(np.float32)
        sd = {"language_model.embedding.word_embeddings.weight": w(V, E),
              "language_model.embedding.position_embeddings.weight":
                  w(P, E),
              "language_model.transformer.final_layernorm.weight":
                  1 + w(E), "language_model.transformer.final_layernorm"
                            ".bias": w(E)}
        for i in range(L):
            p = f"language_model.transformer.layers.{i}."
            sd.update({
                p + "input_layernorm.weight": 1 + w(E),
                p + "input_layernorm.bias": w(E),
                p + "post_attention_layernorm.weight": 1 + w(E),
                p + "post_attention_layernorm.bias": w(E),
                p + "attention.query_key_value.weight": w(3 * E, E),
                p + "attention.query_key_value.bias": w(3 * E),
                p + "attention.dense.weight": w(E, E),
                p + "attention.dense.bias": w(E),
                p + "mlp.dense_h_to_4h.weight": w(4 * E, E),
                p + "mlp.dense_h_to_4h.bias": w(4 * E),
                p + "mlp.dense_4h_to_h.weight": w(E, 4 * E),
                p + "mlp.dense_4h_to_h.bias": w(E)})
        self.sd = sd
        self.config = transformers.PretrainedConfig()
        for k, v in dict(model_type="megatron-gpt2", hidden_size=E,
                         num_attention_heads=H, num_layers=L, vocab_size=V,
                         max_position_embeddings=P).items():
            setattr(self.config, k, v)


# name -> (model constructor, torch seed): the JAX test file's cases
ARCHS = {
    "gpt2": (_gpt2, 0),
    "gpt_neo": (_gpt_neo, 0),
    "opt": (_opt, 0),
    "gptj": (_gptj, 0),
    "gpt_neox-parallel": (functools.partial(_neox, True), 0),
    "gpt_neox-sequential": (functools.partial(_neox, False), 0),
    "bloom": (_bloom, 0),
    "bert": (_bert, 0),
    "distilbert": (_distilbert, 0),
    "clip_text": (_clip, 0),
    "megatron-gpt2": (_Megatron, 0),
    "llama-kv4": (functools.partial(_llama, 4), 0),
    "llama-kv2": (functools.partial(_llama, 2), 0),
    "llama-bias": (_llama_bias, 3),
    "mistral": (_mistral, 1),
    "mistral-rope1e6": (functools.partial(_mistral, rope_theta=1e6), 1),
    "mistral-window": (functools.partial(_mistral, sliding_window=8), 2),
    "mistral-nemo-head16": (functools.partial(_mistral, head_dim=16), 12),
    "mixtral": (_mixtral, 4),
    "falcon-7b": (functools.partial(_falcon, "7b"), 5),
    "falcon-40b": (functools.partial(_falcon, "40b"), 5),
    "falcon-11b": (functools.partial(_falcon, "11b"), 6),
    "falcon-rw": (functools.partial(_falcon, "rw"), 5),
    "falcon-rw-bias": (functools.partial(_falcon, "rw", True), 5),
    "qwen2": (_qwen2, 7),
    "phi": (_phi, 8),
    "phi-kv2": (functools.partial(_phi, num_key_value_heads=2), 9),
    "gpt_bigcode-mq": (functools.partial(_bigcode, True), 10),
    "gpt_bigcode-mha": (functools.partial(_bigcode, False), 10),
    "gemma-head8": (functools.partial(_gemma, 8), 11),
    "gemma-head16": (functools.partial(_gemma, 16), 11),
    "starcoder2": (_starcoder2, 13),
    "mpt": (_mpt, 14),
    "mpt-ratio2": (functools.partial(_mpt, expansion_ratio=2), 15),
}
ENCODERS = ("bert", "distilbert")
GENERATE = ("gpt2", "llama-kv2", "falcon-40b", "bloom", "gpt_neo")


@pytest.fixture(scope="module")
def models():
    """Each architecture's model and both conversions, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            build, seed = ARCHS[name]
            with torch.random.fork_rng():   # leave the global RNG as it was
                torch.manual_seed(seed)
                hf = build()
            if isinstance(hf, _Megatron):
                j = jpol.convert_hf_model(JaxView(hf.sd, hf.config),
                                          dtype=jnp.float32)
                t = tpol.convert_hf_model(
                    CheckpointModelView(hf.sd, hf.config),
                    dtype=torch.float32)
            else:
                hf.eval()
                j = jpol.convert_hf_model(hf, dtype=jnp.float32)
                t = tpol.convert_hf_model(hf, dtype=torch.float32)
            cache[name] = (hf, j, t)
        return cache[name]
    return get


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _assert_same_tree(port, ref):
    fp, fr = _flat(port), _flat(ref)
    assert set(fp) == set(fr)
    for k in fr:
        assert fp[k].dtype == fr[k].dtype and fp[k].shape == fr[k].shape, k
        assert fp[k].is_contiguous(), k
        assert torch.equal(fp[k], fr[k]), k


def _same_fields(tcfg, jcfg):
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, V, (2, T))


@pytest.mark.parametrize("name", list(ARCHS))
def test_converted_tree_equals_jax(models, name):
    _, (jcfg, jp), (tcfg, tp) = models(name)
    _same_fields(tcfg, jcfg)
    assert tcfg.dtype == torch.float32
    _assert_same_tree(tp, params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "megatron-gpt2"])
def test_state_dict_view_equals_live_model(models, name):
    """The route of checkpoint files: the same policy over a flat state
    dict (``bias`` absent beside a ``weight`` reads as None, as on a
    live module) gives the live model's tree and config."""
    hf, _, (tcfg, tp) = models(name)
    cfg, params = tpol.convert_hf_model(
        CheckpointModelView(hf.state_dict(), hf.config), torch.float32)
    assert cfg == tcfg
    _assert_same_tree(params, tp)


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "mixtral"])
def test_logits_match_jax(models, name):
    _, (jcfg, jp), (tcfg, tp) = models(name)
    ids = _ids()
    if name in ENCODERS:
        mask = np.ones((2, T), np.int32)
        mask[1, T - 5:] = 0          # a padded row: the key mask bites
        ref = np.asarray(jt.encoder_forward(jp, jcfg, jnp.asarray(ids),
                                            jnp.asarray(mask)))
        out = tt.encoder_forward(tp, tcfg, torch.as_tensor(ids),
                                 torch.as_tensor(mask))
    else:
        ref = np.asarray(jt.causal_forward(jp, jcfg, jnp.asarray(ids)))
        out = tt.causal_forward(tp, tcfg, torch.as_tensor(ids))
    assert out.shape == ref.shape
    tol = REL_TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("name", GENERATE)
def test_greedy_generate_matches_jax(models, name):
    hf, _, _ = models(name)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 23, 12)]
    ref = deepspeed_tpu.init_inference(hf, dtype="float32").generate(
        prompts, max_new_tokens=8)
    out = deepspeed_tpu_torch.init_inference(
        hf, dtype="float32", device="cpu").generate(prompts,
                                                    max_new_tokens=8)
    assert out == ref


def test_encoder_engine_forward_and_token_types(models):
    """The engine runs ``encoder_forward`` for a post-LN config (and
    ignores ``triangular_masking``); token-type ids reach BERT's table."""
    hf, (jcfg, jp), _ = models("bert")
    eng = deepspeed_tpu_torch.init_inference(
        hf, dtype="float32", device="cpu", triangular_masking=False)
    ids = _ids(1)
    ref = np.asarray(jt.encoder_forward(jp, jcfg, jnp.asarray(ids)))
    out = eng.forward(ids)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * max(1.0, np.abs(ref).max()))
    tt_ids = np.random.RandomState(2).randint(0, 2, (2, T))
    ref = np.asarray(jt.encoder_forward(jp, jcfg, jnp.asarray(ids),
                                        token_type_ids=jnp.asarray(tt_ids)))
    out = tt.encoder_forward(eng.params, eng.model_config,
                             torch.as_tensor(ids),
                             token_type_ids=torch.as_tensor(tt_ids))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * max(1.0, np.abs(ref).max()))
    with torch.no_grad():
        theirs = hf(torch.as_tensor(ids), token_type_ids=torch.as_tensor(
            tt_ids)).last_hidden_state.numpy()
    np.testing.assert_allclose(out.numpy(), theirs, rtol=2e-3, atol=2e-3)


def test_mixtral_converts_and_the_engine_refuses_moe(models):
    hf, _, (tcfg, tp) = models("mixtral")
    assert tcfg.num_experts == 4 and tcfg.moe_top_k == 2
    assert tp["layers"][0]["moe"]["experts"]["wg"].shape == (4, 32, 64)
    with pytest.raises(NotImplementedError, match=r"MoE .*queue C"):
        deepspeed_tpu_torch.init_inference(hf, dtype="float32",
                                           device="cpu")


def test_policy_table_matches_jax():
    assert [p.__name__ for p in tpol.POLICIES] == \
        [p.__name__ for p in jpol.POLICIES]
    assert [p.model_types for p in tpol.POLICIES] == \
        [p.model_types for p in jpol.POLICIES]
    assert len(tpol.POLICIES) == 18


def test_unknown_model_type_and_missing_config_raise_jax_errors():
    class Fake:
        class config:
            model_type = "made-up"
    with pytest.raises(NotImplementedError) as port:
        tpol.convert_hf_model(Fake())
    with pytest.raises(NotImplementedError) as ref:
        jpol.convert_hf_model(Fake())
    assert str(port.value) == str(ref.value) and "made-up" in str(ref.value)
    with pytest.raises(ValueError, match="with .config"):
        deepspeed_tpu_torch.init_inference(object(), device="cpu")


def test_refusals_match_jax():
    """The layouts both packages refuse rather than serve wrongly."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        qk = _phi(qk_layernorm=True)
    for conv, dt in ((tpol.convert_hf_model, torch.float32),
                     (jpol.convert_hf_model, jnp.float32)):
        with pytest.raises(NotImplementedError, match="qk_layernorm"):
            conv(qk, dtype=dt)
    with torch.random.fork_rng():
        opt = transformers.OPTForCausalLM(transformers.OPTConfig(
            vocab_size=V, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, ffn_dim=64, do_layer_norm_before=False))
    with pytest.raises(NotImplementedError, match="do_layer_norm_before"):
        tpol.convert_hf_model(opt, dtype=torch.float32)


def test_injection_policy_raises_jax_message(models):
    hf, _, _ = models("gpt2")
    with pytest.raises(NotImplementedError,
                       match="register a conversion policy instead"):
        deepspeed_tpu_torch.init_inference(
            hf, dtype="float32", device="cpu",
            injection_policy={"GPT2Block": ("attn.c_proj",)})
    with pytest.raises(NotImplementedError,
                       match="register a conversion policy instead"):
        deepspeed_tpu.init_inference(
            hf, dtype="float32",
            injection_policy={"GPT2Block": ("attn.c_proj",)})


def test_fp16_checkpoint_lands_on_jax_bf16_bits(models):
    """An fp16 model converts to bf16 through float32 in both packages:
    the same bits."""
    hf, _, _ = models("gpt2")
    with torch.random.fork_rng():
        half = _gpt2()
    half.load_state_dict(hf.state_dict())
    half = half.half()
    _, jp = jpol.convert_hf_model(half, dtype=jnp.bfloat16)
    _, tp = tpol.convert_hf_model(half, dtype=torch.bfloat16)
    _assert_same_tree(tp, params_from_numpy(jax.device_get(jp), "cpu"))
    assert tp["wte"].dtype == torch.bfloat16


def test_int8_weights_apply_to_a_converted_tree(models):
    """The int8 options act on a converted tree as on any other:
    ``dtype="int8"`` converts in bf16 and quantizes on placement to JAX's
    int8 leaves bit for bit; ``quant.enabled`` at float32 serves JAX's
    tokens."""
    hf, _, _ = models("llama-kv2")
    jeng = deepspeed_tpu.init_inference(hf, dtype="int8")
    teng = deepspeed_tpu_torch.init_inference(hf, dtype="int8", device="cpu")
    for k in ("wq", "wk", "wo"):
        got = teng.params["layers"][1]["attn"][k]
        ref = jax.device_get(jeng.params["layers"][1]["attn"][k])
        assert got["q"].dtype == torch.int8
        assert torch.equal(got["q"], torch.as_tensor(np.asarray(ref["q"])))
        assert torch.equal(got["scale"],
                           torch.as_tensor(np.asarray(ref["scale"])))
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    quant = {"quant": {"enabled": True}}
    ref = deepspeed_tpu.init_inference(hf, dtype="float32", **quant
                                       ).generate(prompts, max_new_tokens=6)
    out = deepspeed_tpu_torch.init_inference(
        hf, dtype="float32", device="cpu", **quant).generate(
            prompts, max_new_tokens=6)
    assert out == ref
