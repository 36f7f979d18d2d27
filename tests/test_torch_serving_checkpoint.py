"""From a trained GPT-2 to the server through a serving checkpoint: the
port against the JAX package, on the CPU.

* ``gpt2_to_inference`` on the port's flat training params gives the JAX
  converter's tree leaf for leaf, with the padded vocabulary rows
  stripped (200 of 256), and the same logits (f32: 1e-5, the same f32
  function in another order); the training model's own logits agree
  with the converted model's (its vocabulary columns; 2e-4, the LayerNorm
  variance formulas differ).
* A serving checkpoint written by the JAX package and loaded by the port
  gives the JAX engine's greedy tokens, and one written by the port and
  loaded by the JAX package the port's (f32, token for token); a bf16
  round trip within the port gives the same logits bit for bit.
* The port's ``.safetensors`` files read back with the ``safetensors``
  package (bf16 included) and the package's files with the port's reader.
* ``save_16bit_model`` writes JAX's names, shapes and dtypes.
* The refusals name their queue: LLaMA (A5), MoE (A8). Int8 leaves
  (``{"q", "scale"}`` nodes) are no longer refused: they are written and
  read as JAX's layout names them (``.../wi/q``, ``.../wi/scale``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from safetensors import safe_open

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.engine import \
    load_serving_checkpoint as jax_load_serving
from deepspeed_tpu.inference.engine import \
    save_serving_checkpoint as jax_save_serving
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.module_inject.from_training import \
    gpt2_to_inference as jax_gpt2_to_inference
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import (load_serving_checkpoint,
                                                  save_serving_checkpoint)
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.module_inject import (convert_trained_model,
                                               gpt2_to_inference,
                                               llama_to_inference)
from deepspeed_tpu_torch.module_inject.from_jax import gpt2_params_from_flax
from deepspeed_tpu_torch.utils.safetensors_io import (load_file, read_header,
                                                      save_file)

TINY = dict(vocab_size=200, n_positions=64, n_embd=64, n_layer=2, n_head=4)
PROMPTS = [[5, 17, 3, 99, 42, 7], [150, 2, 8], list(range(20, 40))]
NEW = 8


@pytest.fixture(scope="module")
def flax_params():
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(3), batch_size=1,
                                     seq_len=64))


def _jax_converted(flax_params):
    cfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32)
    return jax_gpt2_to_inference(cfg, flax_params, jnp.float32)


def _port_converted(flax_params, dtype=torch.float32):
    cfg = port_gpt2.GPT2Config(**TINY, dtype=dtype)
    return gpt2_to_inference(cfg, gpt2_params_from_flax(flax_params), dtype)


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_engine(model):
    return deepspeed_tpu_torch.init_inference(
        model, dtype="float32", device="cpu", max_out_tokens=64)


def _jax_engine(model):
    return JaxEngine(model, JaxInferenceConfig(dtype="float32",
                                               max_out_tokens=64))


def test_gpt2_to_inference_matches_jax(flax_params):
    jcfg, jp = _jax_converted(flax_params)
    tcfg, tp = _port_converted(flax_params)
    assert tcfg.vocab_size == jcfg.vocab_size == 200
    assert tcfg.layer_norm_eps == jcfg.layer_norm_eps == 1e-6
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert set(jl) == set(tl)
    assert tl["wte"].shape[0] == 200   # padded rows (to 256) stripped
    for k, v in jl.items():
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(v),
                                      err_msg=k)
    ids = np.asarray([PROMPTS[2]], np.int32)
    want = np.asarray(_jax_engine((jcfg, jp)).forward(jnp.asarray(ids)),
                      np.float32)
    got = _port_engine((tcfg, tp)).forward(ids).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the training model's own logits (its first 200 columns)
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **TINY, dtype=torch.float32))
    train = model.apply(gpt2_params_from_flax(flax_params),
                        torch.as_tensor(ids)).detach()[..., :200]
    np.testing.assert_allclose(got, train.numpy(), rtol=2e-4, atol=2e-4)
    # a converted leaf is a copy: a later training step cannot move it
    src = gpt2_params_from_flax(flax_params)
    icfg, ip = convert_trained_model(model, src)
    src["wpe"].add_(1.0)
    assert not torch.equal(ip["wpe"], src["wpe"])


def test_conversion_refusals_name_their_queue(flax_params):
    # an MoE LLaMA converts with A8; a model of no training family is
    # refused with the list of those that convert
    moe_llama = port_llama.config_for("mixtral-tiny")
    with pytest.raises(NotImplementedError, match="A8"):
        llama_to_inference(moe_llama, {})
    with pytest.raises(NotImplementedError,
                       match="supported: GPT2LMModel, LlamaLMModel"):
        convert_trained_model(object(), {})
    moe = port_gpt2.GPT2Config(**TINY, num_experts=2)
    with pytest.raises(NotImplementedError, match="A8"):
        gpt2_to_inference(moe, {})


def test_jax_written_serving_checkpoint_serves_jax_tokens_in_the_port(
        flax_params, tmp_path):
    jeng = _jax_engine(_jax_converted(flax_params))
    want = jeng.generate(PROMPTS, max_new_tokens=NEW)
    jax_save_serving(jeng, str(tmp_path))
    teng = load_serving_checkpoint(
        str(tmp_path), DeepSpeedInferenceConfig(dtype="float32",
                                                max_out_tokens=64),
        device="cpu")
    assert teng.model_config.layer_norm_eps == 1e-6
    assert teng.generate(PROMPTS, max_new_tokens=NEW) == want


def test_port_written_serving_checkpoint_serves_port_tokens_in_jax(
        flax_params, tmp_path):
    teng = _port_engine(_port_converted(flax_params))
    want = teng.generate(PROMPTS, max_new_tokens=NEW)
    save_serving_checkpoint(teng, str(tmp_path))
    with open(tmp_path / "serving_config.json") as f:
        assert json.load(f)["dtype"] == "float32"
    jeng = jax_load_serving(str(tmp_path), JaxInferenceConfig(
        dtype="float32", max_out_tokens=64))
    assert jeng.generate(PROMPTS, max_new_tokens=NEW) == want


def test_bf16_round_trip_is_bit_identical(flax_params, tmp_path):
    model = _port_converted(flax_params, torch.bfloat16)
    eng = deepspeed_tpu_torch.init_inference(model, dtype="bfloat16",
                                             device="cpu", max_out_tokens=64)
    save_serving_checkpoint(eng, str(tmp_path))
    back = load_serving_checkpoint(str(tmp_path), device="cpu")
    assert back.model_config == eng.model_config
    ids = np.asarray([PROMPTS[2]], np.int32)
    assert torch.equal(back.forward(ids), eng.forward(ids))
    assert back.generate(PROMPTS, max_new_tokens=NEW) == \
        eng.generate(PROMPTS, max_new_tokens=NEW)
    # the safetensors package reads the port's bf16 file as written
    pkg = safetensors.torch.load_file(str(tmp_path / "serving.safetensors"))
    for name, t in _leaves(eng.params):
        assert pkg[name].dtype == torch.bfloat16
        assert torch.equal(pkg[name], t), name


def test_int8_leaves_refused_naming_a4(flax_params, tmp_path):
    """Int8 leaves, refused before they were ported, now round-trip: the
    port writes a ``{"q", "scale"}`` node as two tensors under JAX's names
    and reads a JAX-layout file's node back as stored (int8, f32)."""
    eng = _port_engine(_port_converted(flax_params))
    node = {"q": torch.arange(64 * 256, dtype=torch.int32).remainder(
        255).sub(127).to(torch.int8).reshape(64, 256),
        "scale": torch.full((64, 1), 0.01)}
    eng.params["layers"][0]["mlp"]["wi"] = node
    save_serving_checkpoint(eng, str(tmp_path / "a"))
    flat = load_file(str(tmp_path / "a" / "serving.safetensors"))
    assert "layers/0/mlp/wi" not in flat
    assert torch.equal(flat["layers/0/mlp/wi/q"], node["q"])
    assert torch.equal(flat["layers/0/mlp/wi/scale"], node["scale"])
    jeng = _jax_engine(_jax_converted(flax_params))
    jax_save_serving(jeng, str(tmp_path / "b"))
    flat = load_file(str(tmp_path / "b" / "serving.safetensors"))
    w = flat.pop("layers/0/mlp/wi")
    flat["layers/0/mlp/wi/q"] = w.to(torch.int8)
    flat["layers/0/mlp/wi/scale"] = torch.ones(w.shape[0], 1)
    save_file(flat, str(tmp_path / "b" / "serving.safetensors"))
    back = load_serving_checkpoint(str(tmp_path / "b"), device="cpu")
    wi = back.params["layers"][0]["mlp"]["wi"]
    assert set(wi) == {"q", "scale"}
    assert wi["q"].dtype == torch.int8 and wi["scale"].dtype == torch.float32
    assert torch.equal(wi["q"], w.to(torch.int8))


SAMPLES = {
    "bf16": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16),
    "f16": torch.arange(7, dtype=torch.float16),
    "f32": torch.randn(2, 2, 2, generator=torch.Generator().manual_seed(1)),
    "f64": torch.tensor([1.5, -2.25], dtype=torch.float64),
    "i64": torch.arange(-3, 3, dtype=torch.int64),
    "i32": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
    "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
    "u8": torch.tensor([0, 255], dtype=torch.uint8),
    "bool": torch.tensor([True, False, True]),
    "scalar": torch.tensor(3.0),
    "empty": torch.zeros(0, 4),
}


def test_safetensors_files_read_both_ways(tmp_path):
    mine = str(tmp_path / "port.safetensors")
    save_file(SAMPLES, mine, metadata={"format": "pt"})
    assert not os.path.exists(mine + ".tmp")
    pkg = safetensors.torch.load_file(mine)
    assert set(pkg) == set(SAMPLES)
    for k, v in SAMPLES.items():
        assert pkg[k].dtype == v.dtype and torch.equal(pkg[k], v), k
    assert read_header(mine)["__metadata__"] == {"format": "pt"}
    theirs = str(tmp_path / "pkg.safetensors")
    safetensors.torch.save_file(SAMPLES, theirs)
    for path in (mine, theirs):
        got = load_file(path)
        assert set(got) == set(SAMPLES)
        for k, v in SAMPLES.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the numpy reader the JAX package uses sees the same values
    with safe_open(mine, framework="numpy") as h:
        np.testing.assert_array_equal(h.get_tensor("f32"),
                                      SAMPLES["f32"].numpy())
    with pytest.raises(TypeError, match="safetensors name"):
        save_file({"c": torch.zeros(2, dtype=torch.complex64)},
                  str(tmp_path / "c.safetensors"))


def test_save_16bit_model_matches_jax(flax_params, tmp_path):
    cfg = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                      dtype=jnp.bfloat16))
    jeng = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=flax_params, config=dict(cfg),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]
    tmodel = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    teng = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=gpt2_params_from_flax(flax_params),
        config=dict(cfg), device="cpu")[0]
    jpath = jeng.save_16bit_model(str(tmp_path / "jax"))
    tpath = teng.save_16bit_model(str(tmp_path / "port"))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    jh, th = read_header(jpath), read_header(tpath)
    strip = {"__data_start__", "__metadata__"}
    assert {k: (v["dtype"], v["shape"]) for k, v in jh.items()
            if k not in strip} == \
        {k: (v["dtype"], v["shape"]) for k, v in th.items()
         if k not in strip}
    assert th["wte"]["dtype"] == "BF16"
    # the same bf16 weights: both cast the same f32 initial params
    got = safetensors.torch.load_file(tpath)
    for k, v in safetensors.numpy.load_file(jpath).items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


def test_port_imports_neither_safetensors_nor_orbax():
    """The card's machine has neither package: the port writes the
    safetensors format itself (``utils/safetensors_io.py``) and its
    checkpoints with ``torch.save``."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    found = []
    for path in sorted((root / "deepspeed_tpu_torch").rglob("*.py")) + \
            [root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in ("safetensors", "orbax")]
    assert found == []
