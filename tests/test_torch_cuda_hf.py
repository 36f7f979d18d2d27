"""HF checkpoints converted and served on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX, no
``transformers`` and no ``safetensors`` (nor the tests' conftest, which
imports JAX), so it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hf.py -q

Two HF-named state dicts are made from a seed: a Mistral layout (2
layers, 4 heads of 128 over 2 KV heads, rope_theta 1e6) and a GPT-2 layout
(2 layers, 4 heads of 64, fused Conv1D ``c_attn``).

* A ``CheckpointModelView`` over the tensors on the card converts there,
  to the host conversion's tree bit for bit (copies, transposes and casts
  of the same values).
* ``generate`` over the card's conversion (B1, B4, the decode graph)
  serves the host's greedy tokens (the host conversion on the plain
  attention path, bf16), up to near-ties: where the two part, both
  tokens' logits lie within ``TIE_TOL`` of each other in a float32 host
  forward, and every token the card served lies within it of that
  forward's maximum.
* A sharded safetensors directory written by the port's writer loads with
  ``init_inference(path)`` on the card into the in-memory tree bit for
  bit; the port's reader reads every bf16 bit pattern onto the card.
"""
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.model_implementations.transformer import \
    causal_forward
from deepspeed_tpu_torch.module_inject.policies import convert_hf_model
from deepspeed_tpu_torch.module_inject.state_dict_loader import \
    CheckpointModelView
from deepspeed_tpu_torch.utils.safetensors_io import (SafetensorsReader,
                                                      save_file,
                                                      save_sharded)

V = 1000
NEW = 16
# bf16 GEMMs and attention summed in other orders on the card and on the
# host: 2-layer logits of magnitude ~2-4 land a few bf16 steps (1/64 there)
# apart; a wrong weight slot or rotary base moves them by O(1)
TIE_TOL = 0.125

MISTRAL = {"model_type": "mistral", "vocab_size": V, "hidden_size": 512,
           "intermediate_size": 1024, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 1024, "rms_norm_eps": 1e-5,
           "rope_theta": 1e6, "sliding_window": None,
           "tie_word_embeddings": False}
GPT2 = {"model_type": "gpt2", "vocab_size": V, "n_positions": 512,
        "n_embd": 256, "n_layer": 2, "n_head": 4,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _state_dict(layout, seed=0):
    """HF-named bf16 weights on the host from a seeded generator."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale or 1 / math.sqrt(shape[-1])
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    def ln(n):
        return (1 + 0.1 * torch.randn(n, generator=g)).to(torch.bfloat16)
    if layout == "mistral":
        c = MISTRAL
        E, F, H, KH = (c["hidden_size"], c["intermediate_size"],
                       c["num_attention_heads"], c["num_key_value_heads"])
        D = E // H
        sd = {"model.embed_tokens.weight": w(V, E),
              "model.norm.weight": ln(E), "lm_head.weight": w(V, E)}
        for i in range(c["num_hidden_layers"]):
            p = f"model.layers.{i}."
            sd.update({p + "input_layernorm.weight": ln(E),
                       p + "post_attention_layernorm.weight": ln(E),
                       p + "self_attn.q_proj.weight": w(H * D, E),
                       p + "self_attn.k_proj.weight": w(KH * D, E),
                       p + "self_attn.v_proj.weight": w(KH * D, E),
                       p + "self_attn.o_proj.weight": w(E, H * D),
                       p + "mlp.gate_proj.weight": w(F, E),
                       p + "mlp.up_proj.weight": w(F, E),
                       p + "mlp.down_proj.weight": w(E, F)})
        return sd, c
    c = GPT2
    E = c["n_embd"]
    sd = {"transformer.wte.weight": w(V, E),   # tied head: logits ~1
          "transformer.wpe.weight": w(c["n_positions"], E, scale=0.1),
          "transformer.ln_f.weight": ln(E),
          "transformer.ln_f.bias": w(E, scale=0.1)}
    for i in range(c["n_layer"]):
        p = f"transformer.h.{i}."
        # Conv1D stores [in, out]
        sd.update({p + "ln_1.weight": ln(E), p + "ln_1.bias": w(E, scale=.1),
                   p + "ln_2.weight": ln(E), p + "ln_2.bias": w(E, scale=.1),
                   p + "attn.c_attn.weight": w(E, 3 * E, scale=E ** -0.5),
                   p + "attn.c_attn.bias": w(3 * E, scale=0.1),
                   p + "attn.c_proj.weight": w(E, E),
                   p + "attn.c_proj.bias": w(E, scale=0.1),
                   p + "mlp.c_fc.weight": w(E, 4 * E, scale=E ** -0.5),
                   p + "mlp.c_fc.bias": w(4 * E, scale=0.1),
                   p + "mlp.c_proj.weight": w(4 * E, E),
                   p + "mlp.c_proj.bias": w(E, scale=0.1)})
    return sd, c


def _view(sd, config, device=None):
    return CheckpointModelView({k: v.to(device) if device else v
                                for k, v in sd.items()},
                               SimpleNamespace(**config))


def _same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.cpu(), b.cpu()), path


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["mistral", "gpt2"])
def test_view_converts_on_the_card_as_on_the_host(cuda_device, layout):
    sd, config = _state_dict(layout)
    cfg_h, host = convert_hf_model(_view(sd, config), torch.bfloat16)
    cfg_d, dev = convert_hf_model(_view(sd, config, cuda_device),
                                  torch.bfloat16)
    assert cfg_d == cfg_h
    assert all(t.is_cuda for t in _leaves(dev))
    _same_tree(dev, host)
    if layout == "mistral":
        assert cfg_d.kv_heads == 2 and cfg_d.rotary_base == 1e6
        assert dev["layers"][0]["attn"]["wk"].shape == (512, 2, 128)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n).tolist() for n in (7, 40, 129, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["mistral", "gpt2"])
def test_converted_view_serves_the_host_tokens(cuda_device, layout):
    sd, config = _state_dict(layout)
    prompts = _prompts()
    eng = deepspeed_tpu_torch.init_inference(
        _view(sd, config, cuda_device), dtype="bf16", max_out_tokens=512)
    out = eng.generate(prompts, max_new_tokens=NEW)
    assert eng._kept[2] is not None and eng._kept[2].replays > 0
    host = deepspeed_tpu_torch.init_inference(
        _view(sd, config), dtype="bf16", device="cpu", max_out_tokens=512)
    ref = host.generate(prompts, max_new_tokens=NEW)
    ref32 = deepspeed_tpu_torch.init_inference(
        _view(sd, config), dtype="float32", device="cpu")
    for p, a, b in zip(prompts, out, ref):
        assert len(a) == len(b) == len(p) + NEW and a[:len(p)] == p
        with torch.inference_mode():
            lg = causal_forward(ref32.params, ref32.model_config,
                                torch.as_tensor([a[:-1]]))[0]
        served = torch.as_tensor(a[len(p):])
        top = lg[len(p) - 1:].max(-1).values
        gap = top - lg[len(p) - 1:].gather(1, served[:, None])[:, 0]
        assert float(gap.max()) <= TIE_TOL, (layout, gap)
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   None)
        if pos is not None:    # a near-tie, not a wrong path
            assert abs(float(lg[pos - 1, a[pos]] - lg[pos - 1, b[pos]])) \
                <= TIE_TOL, (layout, pos)


@pytest.mark.cuda
def test_sharded_safetensors_load_on_the_card(cuda_device, tmp_path):
    sd, config = _state_dict("mistral", seed=1)
    files = save_sharded(sd, str(tmp_path), 2 * 2**20)
    assert len(files) >= 2
    (tmp_path / "config.json").write_text(json.dumps(config))
    eng = deepspeed_tpu_torch.init_inference(str(tmp_path), dtype="bf16")
    _, ref = convert_hf_model(_view(sd, config, cuda_device),
                              torch.bfloat16)
    assert all(t.is_cuda for t in _leaves(eng.params))
    _same_tree(eng.params, ref)


@pytest.mark.cuda
def test_reader_reads_every_bf16_pattern_onto_the_card(cuda_device,
                                                       tmp_path):
    words = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    t = words.view(torch.bfloat16).reshape(256, 256)
    path = str(tmp_path / "bits.safetensors")
    save_file({"w": t}, path)
    got = SafetensorsReader(path).get_tensor("w", device=cuda_device)
    assert got.is_cuda and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16).cpu(), words.reshape(256, 256))
