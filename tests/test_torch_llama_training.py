"""Training the port's LLaMA against the JAX engine on the CPU, then
serving what it trained.

Both engines start from the same numpy-drawn weights of a tiny GQA LLaMA
(2 layers, n_embd 64, 4 heads over 2 KV heads, T = 32) and take the same
numpy batches for 3 ``train_batch`` steps; the JAX engine runs on a
one-device mesh. Tolerances, each with its reason (as
``tests/test_torch_training.py`` holds GPT-2):

* fp32 (AdamW, WarmupLR, clipping, gas 2): losses and gradient norms to
  1e-5 relative (the same f32 function, summed in another order); the
  final f32 master to ``lr / 10`` absolute (Adam divides each gradient
  element by its own running magnitude, so last-bit differences of
  near-zero gradients reach the update at up to ``lr`` scale).
* bf16: losses to 1e-2 relative, gradient norms to 5e-2; each leaf's
  update of the f32 master (final minus initial) to 0.1 relative L2
  (activations and gradients round to bf16 at different places in the two
  frameworks; an engine that leaves the master alone reads 1).

Then the port's trained f32 master goes through ``convert_trained_model``
and, as numpy, through JAX's ``llama_to_inference``: the two trees are
equal leaf for leaf, and the port's ``generate`` and paged server serve
JAX's greedy tokens from them exactly (f32 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.module_inject.from_training import \
    llama_to_inference as jax_llama_to_inference
from deepspeed_tpu_torch.inference import ContinuousBatchingServer
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.module_inject import convert_trained_model
from deepspeed_tpu_torch.module_inject.from_jax import (gpt2_params_to_numpy,
                                                        llama_params_from_flax)
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            n_kv_head=2, intermediate_size=96)
T = 32
STEPS = 3
LR = 1e-3
PROMPTS = [[5, 17, 3, 90, 42, 7], [60, 2, 8], list(range(20, 40))]
NEW = 8


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def init_params():
    """JAX's tree drawn with numpy: kernels N(0, 1/fan_in), tables
    N(0, 0.02), norms 1."""
    cfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32, remat=False)
    shapes = jax.eval_shape(jax_llama.LlamaLMModel(cfg).module.init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        if "embed" in name or "lm_head" in name:
            return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
        return np.ones(s.shape, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 0.5,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": 2,
                                 "warmup_type": "linear"}}}


def _batches():
    rng = np.random.default_rng(4)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"], (4, T)
                                       ).astype(np.int32)}
            for _ in range(STEPS)]


def _run_both(init_params, ds_config, jdtype, tdtype):
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jax_llama.LlamaLMModel(jax_llama.LlamaConfig(
            **TINY, dtype=jdtype, remat=False)),
        model_parameters=init_params, config=dict(ds_config),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    tmodel = port_llama.LlamaLMModel(port_llama.LlamaConfig(**TINY,
                                                            dtype=tdtype))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=llama_params_from_flax(init_params),
        config=dict(ds_config), device="cpu")
    jm, tm = [], []
    for b in _batches():
        jm.append({k: np.asarray(v) for k, v in jeng.train_batch(
            {k: jnp.asarray(x) for k, x in b.items()}).items()})
        tm.append({k: (v.detach().numpy() if torch.is_tensor(v)
                       else np.asarray(v))
                   for k, v in teng.train_batch(b).items()})
    return jeng, tmodel, teng, jm, tm


@pytest.fixture(scope="module")
def fp32_run(init_params):
    return _run_both(init_params, BASE, jnp.float32, torch.float32)


def test_fp32_trajectory_matches_jax(fp32_run):
    jeng, _, teng, jm, tm = fp32_run
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    assert tm[0]["grad_norm"] > BASE["gradient_clipping"]   # clip engaged
    jmaster = _flatten(jeng.fp32_master_params())
    tmaster = _flatten(gpt2_params_to_numpy(teng.fp32_master_params()))
    assert set(jmaster) == set(tmaster)
    for k in jmaster:
        np.testing.assert_allclose(tmaster[k], jmaster[k], atol=LR / 10,
                                   err_msg=k)
    assert teng.global_steps == jeng.global_steps == STEPS


def test_bf16_trajectory_matches_jax(init_params):
    cfg = dict(BASE, bf16={"enabled": True})
    jeng, _, teng, jm, tm = _run_both(init_params, cfg, jnp.bfloat16,
                                      torch.bfloat16)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-2)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=5e-2)
    assert all(p.dtype == torch.bfloat16 for p in teng.params.values())
    init = _flatten(init_params)
    jmaster = _flatten(jeng.fp32_master_params())
    tmaster = _flatten(gpt2_params_to_numpy(teng.fp32_master_params()))
    assert set(jmaster) == set(tmaster) == set(init)
    for k in jmaster:
        dj, dt = jmaster[k] - init[k], tmaster[k] - init[k]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= 0.1, (k, rel)


def _leaves(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def converted(fp32_run):
    """The port's trained master through both packages' conversions."""
    _, tmodel, teng, _, _ = fp32_run
    master = teng.fp32_master_params()
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32)
    jicfg, jtree = jax_llama_to_inference(
        jcfg, jax.tree.map(jnp.asarray, gpt2_params_to_numpy(master)),
        jnp.float32)
    ticfg, ttree = convert_trained_model(tmodel, master)
    return (jicfg, jtree), (ticfg, ttree), master


def test_llama_to_inference_matches_jax(converted):
    (jicfg, jtree), (ticfg, ttree), master = converted
    jf = {f.name: getattr(jicfg, f.name) for f in dataclasses.fields(jicfg)}
    tf = {f.name: getattr(ticfg, f.name) for f in dataclasses.fields(ticfg)}
    assert jf.pop("dtype") == jnp.float32 and tf.pop("dtype") == torch.float32
    assert tf == jf
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert set(jl) == set(tl)
    for k, v in jl.items():
        assert tl[k].dtype == torch.float32 and tl[k].is_contiguous(), k
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert tuple(tl["lm_head"].shape) == (64, 96)            # [C, V]
    assert tuple(tl["layers/0/attn/wk"].shape) == (64, 2, 16)  # [E, KH, D]
    # copies: a later training step cannot move the served weights
    master["embed"].add_(1.0)
    assert not torch.equal(ttree["wte"], master["embed"])
    master["embed"].sub_(1.0)


def test_trained_llama_serves_jax_tokens(converted):
    """Greedy ``generate`` and the paged server, from the converted
    trees: the port's tokens equal JAX's."""
    (jicfg, jtree), (ticfg, ttree), _ = converted
    conf = dict(dtype="float32", max_out_tokens=64, block_size=16)
    jeng = JaxEngine((jicfg, jtree), JaxConfig(**conf))
    teng = deepspeed_tpu_torch.init_inference((ticfg, ttree), device="cpu",
                                              **conf)
    want = [list(map(int, r)) for r in jeng.generate(PROMPTS,
                                                     max_new_tokens=NEW)]
    got = teng.generate(PROMPTS, max_new_tokens=NEW)
    assert [list(map(int, r)) for r in got] == want
    served = []
    for srv in (JaxServer(jeng), ContinuousBatchingServer(teng)):
        ids = [srv.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        srv.drain()
        served.append([list(map(int, srv.result(i))) for i in ids])
    # prompt + generated, as generate returns them
    assert served[1] == served[0] == want
