"""Serving an HF checkpoint directory with the port
(``deepspeed_tpu_torch/module_inject/state_dict_loader.py``) against the
JAX package on the CPU.

A tiny random GPT-2 and a tiny Llama with 2 KV heads (of 4 query heads)
are saved by ``transformers`` as ``model.safetensors``, as sharded
safetensors with an index, and as ``pytorch_model.bin``, one file or
sharded:

* each layout, read by the port's own safetensors reader or by
  ``torch.load``, converts to the live model's tree exactly, and to the
  JAX file route's;
* ``init_inference(path)`` and ``config.checkpoint`` (a string, a one-item
  list, a dict, under ``base_dir``) serve JAX's greedy tokens; the
  ``checkpoint`` errors are JAX's;
* the lazy reader reads nothing until a tensor is asked for, then exactly
  that tensor; ``dtype="int8"`` loads in bf16 and quantizes as JAX does;
* the port's sharded writer makes a directory both packages read;
* missing files raise JAX's errors.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.module_inject.state_dict_loader import (
    load_inference_checkpoint as jax_load)
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.module_inject.policies import convert_hf_model
from deepspeed_tpu_torch.module_inject.state_dict_loader import (
    load_inference_checkpoint, load_state_dict)
from deepspeed_tpu_torch.utils import safetensors_io
from test_torch_policies import _assert_same_tree

V = 96
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]]
LAYOUTS = ("safetensors", "sharded", "torchbin", "torchbin-sharded")


def _models():
    with torch.random.fork_rng():   # leave the global RNG as it was
        torch.manual_seed(0)
        gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4))
        torch.manual_seed(1)
        llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=V, max_position_embeddings=64, hidden_size=32,
            intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=1e6,
            tie_word_embeddings=False))
    return {"gpt2": gpt2.eval(), "llama": llama.eval()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Both models saved in the four layouts: {(model, layout): path}."""
    base = tmp_path_factory.mktemp("hf_ckpts")
    models = _models()
    paths = {}
    for name, m in models.items():
        for layout in LAYOUTS:
            p = base / name / layout
            kw = {"sharded": {"max_shard_size": "40KB"},
                  "torchbin": {"safe_serialization": False},
                  "torchbin-sharded": {"safe_serialization": False,
                                       "max_shard_size": "40KB"}
                  }.get(layout, {})
            m.save_pretrained(p, **kw)
            paths[name, layout] = str(p)
    return models, paths


def test_layouts_written(ckpts):
    _, paths = ckpts
    for name in ("gpt2", "llama"):
        assert os.path.exists(os.path.join(paths[name, "safetensors"],
                                           "model.safetensors"))
        sharded = paths[name, "sharded"]
        index = json.load(open(os.path.join(
            sharded, "model.safetensors.index.json")))
        assert len(set(index["weight_map"].values())) >= 2
        assert os.path.exists(os.path.join(paths[name, "torchbin"],
                                           "pytorch_model.bin"))
        assert os.path.exists(os.path.join(paths[name, "torchbin-sharded"],
                                           "pytorch_model.bin.index.json"))


@pytest.mark.parametrize("name", ["gpt2", "llama"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_file_route_equals_live_model_and_jax(ckpts, name, layout):
    models, paths = ckpts
    cfg_live, live = convert_hf_model(models[name], dtype=torch.float32)
    cfg, params = load_inference_checkpoint(paths[name, layout],
                                            dtype=torch.float32)
    assert cfg == cfg_live
    _assert_same_tree(params, live)
    _, jp = jax_load(paths[name, layout], dtype=jnp.float32)
    _assert_same_tree(params, params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def jax_tokens(ckpts):
    _, paths = ckpts
    return {name: deepspeed_tpu.init_inference(
        paths[name, "safetensors"], dtype="float32").generate(
            PROMPTS, max_new_tokens=6) for name in ("gpt2", "llama")}


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_init_inference_from_a_path_serves_jax_tokens(ckpts, jax_tokens,
                                                      name):
    _, paths = ckpts
    eng = deepspeed_tpu_torch.init_inference(paths[name, "sharded"],
                                             dtype="float32", device="cpu")
    assert eng.params["wte"].device.type == "cpu"
    assert eng.generate(PROMPTS, max_new_tokens=6) == jax_tokens[name]


@pytest.mark.parametrize("form", ["str", "list", "dict", "base_dir"])
def test_config_checkpoint_forms(ckpts, jax_tokens, form):
    _, paths = ckpts
    path = paths["llama", "safetensors"]
    config = {"str": {"checkpoint": path},
              "list": {"checkpoint": [path]},
              "dict": {"checkpoint": {"checkpoint": path}},
              "base_dir": {"checkpoint": os.path.basename(path),
                           "base_dir": os.path.dirname(path)}}[form]
    eng = deepspeed_tpu_torch.init_inference(
        config={**config, "dtype": "float32"}, device="cpu")
    assert eng.generate(PROMPTS, max_new_tokens=6) == jax_tokens["llama"]


def test_config_checkpoint_errors_match_jax(ckpts):
    models, paths = ckpts
    path = paths["gpt2", "safetensors"]
    cases = [
        ((models["gpt2"],), {"checkpoint": path}, ValueError,
         "ONE weight source"),
        ((), {"checkpoint": [path, path]}, NotImplementedError,
         "model-parallel"),
        ((), {"checkpoint": {"other": path}}, ValueError,
         "must be a path"),
    ]
    for args, config, err, match in cases:
        with pytest.raises(err, match=match):
            deepspeed_tpu_torch.init_inference(*args, config=config,
                                               device="cpu")
        with pytest.raises(err, match=match):
            deepspeed_tpu.init_inference(*args, config=config)


def test_lazy_reads_touch_one_tensor_at_a_time(ckpts, monkeypatch):
    """Opening a checkpoint reads headers only; each tensor asked for is
    one read of its own bytes."""
    _, paths = ckpts
    reads = []
    real = safetensors_io.SafetensorsReader.get_tensor

    def counting(self, name, device=None):
        t = real(self, name, device)
        reads.append(t.numel() * t.element_size())
        return t
    monkeypatch.setattr(safetensors_io.SafetensorsReader, "get_tensor",
                        counting)
    for layout in ("safetensors", "sharded"):
        reads.clear()
        sd = load_state_dict(paths["gpt2", layout])
        assert "transformer.wte.weight" in sd and len(list(sd.keys())) > 10
        assert reads == []
        w = sd["transformer.wte.weight"]
        assert w.shape == (V, 32) and reads == [V * 32 * 4]


def test_int8_loads_in_bf16_and_quantizes_as_jax(ckpts):
    _, paths = ckpts
    path = paths["llama", "safetensors"]
    t = deepspeed_tpu_torch.init_inference(path, dtype="int8", device="cpu")
    j = deepspeed_tpu.init_inference(path, dtype="int8")
    assert t.model_config.dtype == torch.bfloat16
    got = t.params["layers"][0]["mlp"]["wg"]
    ref = jax.device_get(j.params["layers"][0]["mlp"]["wg"])
    assert torch.equal(got["q"], torch.from_numpy(np.array(ref["q"])))
    assert torch.equal(got["scale"], torch.from_numpy(np.array(ref["scale"])))


def test_port_sharded_writer_reads_in_both_packages(ckpts, tmp_path):
    """``safetensors_io.save_sharded`` writes HF's sharded layout: bf16
    shards and an index that the port's reader, the ``safetensors``
    package and the JAX loader all read to the same values."""
    models, _ = ckpts
    m = models["llama"]
    sd = {k: v.to(torch.bfloat16) for k, v in m.state_dict().items()}
    files = safetensors_io.save_sharded(sd, str(tmp_path), 20_000)
    assert len(files) >= 2
    m.config.to_json_file(str(tmp_path / "config.json"))
    got = load_state_dict(str(tmp_path))
    for k, v in sd.items():
        assert torch.equal(got[k].view(torch.int16), v.view(torch.int16)), k
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    for k, fname in index["weight_map"].items():
        pkg = safetensors.torch.load_file(str(tmp_path / fname))[k]
        assert torch.equal(pkg.view(torch.int16), sd[k].view(torch.int16))
    _, tp = load_inference_checkpoint(str(tmp_path), dtype=torch.float32)
    _, jp = jax_load(str(tmp_path), dtype=jnp.float32)
    _assert_same_tree(tp, params_from_numpy(jax.device_get(jp), "cpu"))


def test_reader_reads_bf16_bit_for_bit(tmp_path):
    """bf16 comes in as raw 16-bit words: every bit pattern survives,
    NaN payloads and subnormals included."""
    words = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    t = {"w": words.view(torch.bfloat16).reshape(256, 256),
         "f16": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                            ).half(), "i64": torch.arange(7)}
    path = str(tmp_path / "x.safetensors")
    safetensors.torch.save_file(t, path)
    reader = safetensors_io.SafetensorsReader(path)
    assert set(reader.keys()) == set(t)
    for k, v in t.items():
        got = reader.get_tensor(k)
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(got.view(torch.uint8), v.view(torch.uint8)), k


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        load_inference_checkpoint(str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        load_inference_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        deepspeed_tpu_torch.init_inference(str(tmp_path), device="cpu")
