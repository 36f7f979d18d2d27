"""ZeRO-3 parameter offload (``offload_param: {device: cpu}``) in the port's
training engine on the CPU.

Between steps the 16-bit params live in host memory. GPT-2 with
``offload_params=True`` declares ``handles_param_offload`` and fetches
each block's weights inside its checkpointed block through the engine's
fetch, whose backward hands each gradient to the engine's accumulator;
any other model gets the whole tree staged for the step. Either way the
step's numbers are those of the same engine without parameter offload, bit
for bit (the same values reach the same kernels; autograd sums a fetched
weight's uses as it sums a leaf's). Against JAX: stage 3 with both offload
tiers on a tiny GPT-2 in bf16 follows JAX's engine within
``tests/test_torch_training.py``'s bf16 tolerances (losses to 1e-2
relative, each leaf's update of the master to 0.1 relative L2), and the
refusals carry JAX's words.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.module_inject.from_jax import gpt2_params_from_flax
from deepspeed_tpu_torch.runtime.zero import param_offload
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)
from test_torch_offload import BASE, LR, TINY, _batches, _draw

HOST_OPT = {"device": "cpu"}
PARAM = {"device": "cpu"}


@pytest.fixture(scope="module")
def params():
    model = jax_gpt2.GPT2(jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    return _draw(shapes, 3)


def _engine(params, zero, fetch=False, remat=True, dtype=torch.bfloat16):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **TINY, dtype=dtype, offload_params=fetch, remat=remat))
    ds = dict(BASE, zero_optimization=zero)
    if dtype == torch.bfloat16:
        ds["bf16"] = {"enabled": True}
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=gpt2_params_from_flax(params),
        config=ds, device="cpu")[0]
    return eng, model


def _run(eng, n=3):
    return [eng.train_batch(b)["loss"] for b in _batches(n)]


def _same(a, b):
    la, lb = _run(a), _run(b)
    assert all(torch.equal(x, y) for x, y in zip(la, lb)), (la, lb)
    ma, mb = a.fp32_master_params(), b.fp32_master_params()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_gpt2_layer_fetch_equals_no_offload(params, remat):
    """Stage 3 with both tiers and the per-layer fetch against stage 1
    with the host optimizer only."""
    ref, _ = _engine(params, {"stage": 1, "offload_optimizer": HOST_OPT},
                     remat=remat)
    eng, model = _engine(params, {"stage": 3, "offload_optimizer": HOST_OPT,
                                  "offload_param": PARAM}, fetch=True,
                         remat=remat)
    assert eng._fetcher is not None and model.module.fetch is eng._fetcher
    _same(ref, eng)
    # no gradient crossed to the host tensors
    assert all(p.grad is None for p in eng.params.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gpt2_layer_fetch_with_the_device_optimizer_equals_stage_0(params,
                                                                   dtype):
    """The f32 master stays on the card (in fp32 too, where without
    offload the params are the master)."""
    ref, _ = _engine(params, {"stage": 0}, dtype=dtype)
    eng, _ = _engine(params, {"stage": 3, "offload_param": PARAM},
                     fetch=True, dtype=dtype)
    assert eng.host_opt is None and eng.master is not None
    _same(ref, eng)


@pytest.mark.parametrize("opt", [None, HOST_OPT], ids=["device-opt",
                                                       "host-opt"])
def test_staged_tree_equals_no_offload(params, opt, monkeypatch):
    """A model that does not fetch its own layers (GPT-2 without
    ``offload_params``): the whole tree is staged for the step."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    base = {"stage": 3} if opt is None else {"stage": 3,
                                             "offload_optimizer": opt}
    ref, _ = _engine(params, base)
    eng, _ = _engine(params, dict(base, offload_param=PARAM))
    assert eng._fetcher is None
    staged = []

    def spy(p, device):
        staged.append(p is eng.params)
        return param_offload.stage(p, device)
    monkeypatch.setattr(engine_mod, "stage", spy)
    _same(ref, eng)
    assert staged == [True] * 3   # once a step, from the host params
    assert eng._staged is None    # dropped after the step


def test_fetches_per_step_and_params_between_steps(params):
    """Under remat a block's weights are fetched twice a micro-batch
    (forward and the backward's recompute), ``wte`` (embedding and tied
    logits), ``wpe`` and ``ln_f`` once; the params stay the engine's host
    tensors."""
    eng, model = _engine(params, {"stage": 3, "offload_optimizer": HOST_OPT,
                                  "offload_param": PARAM}, fetch=True)
    seen = []
    fetch = eng._fetcher

    def counting(name, host):
        seen.append(name)
        assert host is eng.params[name]
        return fetch(name, host)
    model.set_param_fetch(counting)
    before = dict(eng.params)
    eng.train_batch(_batches(1)[0])
    gas = BASE["gradient_accumulation_steps"]
    for name in eng.params:
        want = 2 * gas if name.startswith("h_") else gas
        assert seen.count(name) == want, (name, seen.count(name))
    assert all(eng.params[k] is v for k, v in before.items())
    # a forward without gradients fetches each weight once
    seen.clear()
    eng.forward({k: v[:2] for k, v in _batches(1)[0].items()})
    assert sorted(seen) == sorted(eng.params)
    model.set_param_fetch(None)
    assert model.module.fetch is None


def test_llama_staged_with_both_tiers_trains(params):
    cfg = port_llama.LlamaConfig(vocab_size=96, n_positions=32, n_embd=32,
                                 n_layer=2, n_head=4, n_kv_head=2,
                                 intermediate_size=48, dtype=torch.bfloat16)
    runs = []
    for zero in ({"stage": 1, "offload_optimizer": HOST_OPT},
                 {"stage": 3, "offload_optimizer": HOST_OPT,
                  "offload_param": PARAM}):
        model = port_llama.LlamaLMModel(cfg)
        assert not getattr(model, "handles_param_offload", False)
        eng = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=model.init(
                torch.Generator().manual_seed(0)),
            config=dict(BASE, bf16={"enabled": True},
                        zero_optimization=zero), device="cpu")[0]
        runs.append((_run(eng), eng.fp32_master_params()))
    (la, ma), (lb, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_both_tiers_match_jax(params):
    ds = dict(BASE, bf16={"enabled": True},
              zero_optimization={"stage": 3, "offload_optimizer": HOST_OPT,
                                 "offload_param": PARAM})
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **TINY, dtype=jnp.bfloat16, offload_params=True))
    jeng = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config=dict(ds),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]
    teng, _ = _engine(params, ds["zero_optimization"], fetch=True)
    for b in _batches():
        j = jeng.train_batch({k: jnp.asarray(x) for k, x in b.items()})
        t = teng.train_batch(b)
        np.testing.assert_allclose(t["loss"].item(), float(j["loss"]),
                                   rtol=1e-2)
    init = {k: v.numpy().reshape(-1)
            for k, v in gpt2_params_from_flax(params).items()}
    jm = {k.replace("/", "."): v for k, v in jeng.host_opt.master.items()}
    tm = {k: v.reshape(-1).numpy()
          for k, v in teng.fp32_master_params().items()}
    C = TINY["n_embd"]
    for k in init:
        dj, dt = jm[k] - init[k], tm[k] - init[k]
        if k.endswith("c_attn.bias"):
            # the key third's exact gradient is zero: Adam's bound only
            assert np.abs(dt[C:2 * C]).max() <= 2 * LR * 1.01, k
            dj, dt = np.delete(dj, np.s_[C:2 * C]), np.delete(dt,
                                                              np.s_[C:2 * C])
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= 0.1, (k, rel)


def _both_raise(params, zero, dtype="fp16"):
    ds = {"train_micro_batch_size_per_gpu": 1, dtype: {"enabled": True},
          "zero_optimization": zero}
    with pytest.raises(ValueError) as je:
        deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY)),
            model_parameters=params, config=dict(ds),
            mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    with pytest.raises(ValueError) as te:
        deepspeed_tpu_torch.initialize(
            model=model, model_parameters=gpt2_params_from_flax(params),
            config=dict(ds), device="cpu")
    return str(je.value), str(te.value)


def test_refusals_carry_jax_words(params):
    """offload_param below stage 3: JAX's message word for word. The
    streamed offload's refusals keep JAX's sentences with the card's
    memory in place of the TPU host's."""
    j, t = _both_raise(params, {"stage": 2, "offload_param": PARAM})
    assert t == j and "requires ZeRO stage 3" in t
    j, t = _both_raise(params, {"stage": 1, "offload_optimizer": {
        "device": "cpu", "implementation": "stream"}})
    for words in ("streamed offload supports bf16/fp32 training",
                  "use implementation='host' for fp16"):
        assert words in j and words in t
    j, t = _both_raise(params, {"stage": 1, "offload_optimizer": {
        "device": "nvme", "nvme_path": "swap", "implementation": "stream"}},
        "bf16")
    for words in ("offload_optimizer.implementation='stream' holds state in",
                  "the nvme tier needs implementation='host' (aio swap "
                  "files)"):
        assert words in j and words in t
