"""ZeRO on one device and ZeRO-Offload's host optimizer in the port's
training engine, against the JAX engine on the CPU.

* The memory estimators give JAX's numbers and tables.
* ``offload_optimizer: {device: cpu}`` (``auto`` resolves to ``host`` on
  the CPU, as in JAX) against JAX's offloaded engine on a one-device mesh,
  3 steps from the same weights on the same batches, with
  ``tests/test_torch_training.py``'s trajectory tolerances: a tiny GPT-2
  in fp32 (losses and gradient norms to 1e-5 relative, the host master to
  ``lr / 10`` absolute) and a tiny LLaMA in bf16 with
  ``grad_accum_dtype: bf16`` (the gradients accumulate and leave the
  device in bf16: losses to 1e-2 relative, gradient norms to 5e-2, each
  leaf's update of the master to 0.1 relative L2), whose metrics have
  JAX's keys; fp16 with overflowing batches: the skipped steps and the
  loss-scale sequence exactly.
* ZeRO stages 1-3 give stage 0's numbers bit for bit (one device).
* JAX's refusals, with JAX's words (the NVMe tier: ``tests/test_torch_nvme.py``).
* Checkpoints of the offloaded engine: ``host_optimizer.npz`` with JAX's
  keys, a resume bit for bit, ``load_module_only`` re-seeding the master,
  ``zero_to_fp32`` reading the host master, the DeepSpeed importer.

JAX's engines are compiled with XLA's CPU optimisations off
(``xla_fast_compiles``).
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
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.zero import memory_estimators as jax_est
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.module_inject.from_jax import (gpt2_params_from_flax,
                                                        llama_params_from_flax)
from deepspeed_tpu_torch.runtime.zero import memory_estimators as port_est
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)

TINY = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=2)
LTINY = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2, intermediate_size=48)
T = 32
STEPS = 3
LR = 1e-3
HOST = {"stage": 1, "offload_optimizer": {"device": "cpu"}}
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 0.5,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": 2,
                                 "warmup_type": "linear"}}}


def _draw(tree, seed):
    """numpy weights in JAX's tree: kernels N(0, 1/fan_in), tables
    N(0, 0.02), scales 1, biases 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        if "scale" in name or "norm" in name:
            return np.ones(s.shape, np.float32)
        if "bias" in name:
            return np.zeros(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def gpt2_params():
    model = jax_gpt2.GPT2(jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    return _draw(shapes, 1)


@pytest.fixture(scope="module")
def llama_params():
    cfg = jax_llama.LlamaConfig(**LTINY, dtype=jnp.float32, remat=False)
    shapes = jax.eval_shape(jax_llama.LlamaLMModel(cfg).module.init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    return _draw(shapes, 2)


def _batches(n=STEPS, weights=None):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        b = {"input_ids": rng.integers(0, TINY["vocab_size"], (4, T)
                                       ).astype(np.int32)}
        if weights is not None:
            b["w"] = np.full((4,), weights[i], np.float32)
        out.append(b)
    return out


def _weighted(loss_fn):
    def fn(params, batch, rng=None):
        return loss_fn(params, batch, rng) * batch["w"].mean()
    return fn


def _jax_engine(model, params, ds, weighted=False):
    return deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=dict(ds),
        loss_fn=_weighted(model.loss_fn) if weighted else None,
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


def _gpt2_engine(params, ds, dtype=torch.float32, weighted=False, **cfg):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY, dtype=dtype,
                                                       **cfg))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=gpt2_params_from_flax(params),
        config=dict(ds), device="cpu",
        loss_fn=_weighted(model.loss_fn) if weighted else None)[0]


def _metrics(m):
    return {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in m.items()}


def _train(jeng, teng, batches):
    jm, tm = [], []
    for b in batches:
        jm.append(_metrics(jeng.train_batch(
            {k: jnp.asarray(x) for k, x in b.items()})))
        tm.append(_metrics(teng.train_batch(b)))
    return jm, tm


def _host_master(eng):
    """The JAX engine's host master by the port's dotted names."""
    return {k.replace("/", "."): v for k, v in eng.host_opt.master.items()}


# ------------------------------------------------------------ estimators

@pytest.mark.parametrize("stage,off_opt,off_par,acc", [
    (0, False, False, 4), (1, True, False, 4), (2, False, False, 2),
    (3, True, True, 4), (3, False, True, 2)])
def test_memory_estimators_equal_jax(stage, off_opt, off_par, acc):
    kw = dict(total_params=5_496_836_096, largest_layer_params=131_072_000,
              stage=stage, num_chips=4 if stage else 1,
              offload_optimizer=off_opt, offload_param=off_par,
              grad_accum_bytes=acc)
    assert port_est.estimate_zero_model_states_mem_needs(**kw) == \
        jax_est.estimate_zero_model_states_mem_needs(**kw)


def test_memory_tables_equal_jax(capsys, gpt2_params):
    """The ``*_all_live`` tables over a live tree (the port's dict of
    tensors, JAX's pytree) and the ``*_all_cold`` ones print the same
    text."""
    tree = gpt2_params_from_flax(gpt2_params)
    out = []
    for est, arg in ((port_est, tree), (jax_est, gpt2_params)):
        est.estimate_zero2_model_states_mem_needs_all_live(arg, num_chips=2)
        est.estimate_zero3_model_states_mem_needs_all_live(arg)
        est.estimate_zero2_model_states_mem_needs_all_cold(10**9)
        est.estimate_zero3_model_states_mem_needs_all_cold(10**9, 10**7)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and "offload_param=True" in out[0]


# ------------------------------------------------- engine against JAX

def test_host_offload_fp32_gpt2_matches_jax(gpt2_params):
    ds = dict(BASE, zero_optimization=HOST)
    jeng = _jax_engine(jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **TINY, dtype=jnp.float32)), gpt2_params, ds)
    teng = _gpt2_engine(gpt2_params, ds)
    assert teng.host_opt is not None and teng._stream_opt is None
    assert teng.master is None and teng.opt_state is None
    jm, tm = _train(jeng, teng, _batches())
    for j, t in zip(jm, tm):
        assert set(t) == set(j) == {"loss", "grad_norm", "lr", "loss_scale",
                                    "skipped"}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
        assert t["loss_scale"] == j["loss_scale"] == 1.0
        assert not t["skipped"] and not j["skipped"]
    assert tm[0]["grad_norm"] > BASE["gradient_clipping"]   # clip engaged
    jmaster = _host_master(jeng)
    tmaster = teng.fp32_master_params()
    assert set(jmaster) == set(tmaster)
    for k, v in tmaster.items():
        np.testing.assert_allclose(v.numpy().reshape(-1), jmaster[k],
                                   atol=LR / 10, err_msg=k)
    assert teng.host_opt.adam.step_count == jeng.host_opt.adam.step_count
    # fp32: the params are the host master's values
    for k, p in teng.params.items():
        assert torch.equal(p.detach(), tmaster[k])
    for fn in ("zero_optimization", "zero_optimization_stage",
               "zero_cpu_offload"):
        assert getattr(teng, fn)() == getattr(jeng, fn)(), fn
    assert teng.zero_offload_optimizer().device == "cpu"


def test_host_offload_bf16_llama_bf16_accumulation_matches_jax(
        llama_params):
    """``grad_accum_dtype: bf16``: the accumulators are bf16 and the
    gradients reach the host optimizer in bf16 (JAX ``native_acc_out``);
    the metrics have JAX's keys and values within the bf16 tolerances."""
    ds = dict(BASE, zero_optimization=HOST, bf16={"enabled": True},
              data_types={"grad_accum_dtype": "bf16"})
    jeng = _jax_engine(jax_llama.LlamaLMModel(jax_llama.LlamaConfig(
        **LTINY, dtype=jnp.bfloat16, remat=False)), llama_params, ds)
    tmodel = port_llama.LlamaLMModel(port_llama.LlamaConfig(
        **LTINY, dtype=torch.bfloat16))
    teng = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=llama_params_from_flax(llama_params),
        config=ds, device="cpu")[0]
    jm, tm = _train(jeng, teng, _batches())
    assert teng._native_out
    assert all(a.dtype == torch.bfloat16 for a in teng._acc)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-2)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=5e-2)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
        assert not t["skipped"] and not j["skipped"]
    init = {k: v.numpy().reshape(-1) for k, v in
            llama_params_from_flax(llama_params).items()}
    jmaster = _host_master(jeng)
    tmaster = {k: v.numpy().reshape(-1)
               for k, v in teng.fp32_master_params().items()}
    assert set(jmaster) == set(tmaster) == set(init)
    for k in init:
        dj, dt = jmaster[k] - init[k], tmaster[k] - init[k]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= 0.1, (k, rel)
    # the bf16 params are the RNE cast of the host master, bit for bit
    for k, p in teng.params.items():
        assert torch.equal(p.detach(), teng.fp32_master_params()[k].to(
            torch.bfloat16)), k


def test_host_offload_fp16_skips_match_jax(gpt2_params):
    """fp16 stays on the host path (``auto``); steps 2 and 3 overflow: the
    first spends the hysteresis, the second halves the scale, and both
    still advance the schedule."""
    ds = dict(BASE, zero_optimization=HOST,
              fp16={"enabled": True, "initial_scale_power": 8,
                    "loss_scale_window": 2, "hysteresis": 2})
    jeng = _jax_engine(jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **TINY, dtype=jnp.float16)), gpt2_params, ds, weighted=True)
    teng = _gpt2_engine(gpt2_params, ds, torch.float16, weighted=True)
    assert teng.host_opt is not None
    jm, tm = _train(jeng, teng, _batches(4, [1, 1e9, 1e9, 1]))
    assert [bool(t["skipped"]) for t in tm] == \
        [bool(j["skipped"]) for j in jm] == [False, True, True, False]
    assert [float(t["loss_scale"]) for t in tm] == \
        [float(j["loss_scale"]) for j in jm] == [256.0, 256.0, 256.0, 128.0]
    assert [float(t["lr"]) for t in tm] == pytest.approx(
        [float(j["lr"]) for j in jm])
    assert teng.skipped_steps == 2 and teng.global_steps == 4
    assert teng.host_opt.adam.step_count == jeng.host_opt.adam.step_count \
        == 2
    for i in (0, 3):
        np.testing.assert_allclose(tm[i]["loss"], jm[i]["loss"], rtol=1e-2)


# ------------------------------------------------------- one device

@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_equal_stage_0(gpt2_params, stage):
    ds = dict(BASE, bf16={"enabled": True})
    runs = []
    for z in ({"stage": 0}, {"stage": stage}):
        eng = _gpt2_engine(gpt2_params, dict(ds, zero_optimization=z),
                           torch.bfloat16)
        losses = [eng.train_batch(b)["loss"] for b in _batches()]
        runs.append((losses, eng.fp32_master_params(), eng))
    (l0, m0, e0), (ls, ms, es) = runs
    assert es.zero_optimization_stage() == stage
    assert all(torch.equal(a, b) for a, b in zip(l0, ls))
    assert all(torch.equal(m0[k], ms[k]) for k in m0)


# ------------------------------------------------------------ refusals

def _port(ds, dtype=torch.bfloat16):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY, dtype=dtype))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=model.init(
            torch.Generator().manual_seed(0)),
        config=dict({"train_micro_batch_size_per_gpu": 1}, **ds),
        device="cpu")[0]


def _off(**kw):
    return {"zero_optimization": {"stage": 1, "offload_optimizer": kw}}


def test_auto_resolves_to_host_on_the_cpu():
    eng = _port(_off(device="cpu"))
    assert eng.host_opt is not None and not eng._offload_stream
    eng = _port(_off(device="cpu", implementation="host"))
    assert eng.host_opt is not None


@pytest.mark.parametrize("kw,dtype,match", [
    (dict(device="cpu", implementation="stream"), torch.bfloat16,
     "needs a CUDA device"),
    (dict(device="nvme", nvme_path="swap", implementation="stream"),
     torch.bfloat16, "nvme"),
    (dict(device="cpu", implementation="stream"), torch.float16, "fp16")],
    ids=["stream-on-cpu", "stream-nvme", "stream-fp16"])
def test_stream_refusals_match_jax(kw, dtype, match):
    ds = _off(**kw)
    if dtype == torch.float16:
        ds["fp16"] = {"enabled": True}
    with pytest.raises(ValueError, match=match):
        _port(ds, dtype)


def test_offload_refuses_non_adam():
    ds = dict(_off(device="cpu"), optimizer={"type": "SGD",
                                             "params": {"lr": 1e-3}})
    with pytest.raises(ValueError, match="Adam-family"):
        _port(ds)


# ---------------------------------------------------------- checkpoints

def test_host_optimizer_checkpoint_resumes_bit_for_bit(gpt2_params,
                                                       tmp_path):
    """Run A takes 3 steps; run B 2 steps, saves and is dropped; run C
    starts from other weights, loads and takes step 3: C's loss, host
    master, moments and params equal A's bit for bit. The tag holds
    ``host_optimizer.npz`` under JAX's keys (``flatten_with_names``
    paths) and no master in its state."""
    ds = dict(BASE, zero_optimization=HOST, bf16={"enabled": True})
    batches = _batches()
    a = _gpt2_engine(gpt2_params, ds, torch.bfloat16)
    la = [a.train_batch(b)["loss"] for b in batches]
    b = _gpt2_engine(gpt2_params, ds, torch.bfloat16)
    for x in batches[:2]:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path))
    tag = tmp_path / "global_step2"
    blob = np.load(tag / "host_optimizer.npz")
    from deepspeed_tpu.utils.tree import flatten_with_names
    paths = list(flatten_with_names(gpt2_params))
    assert set(blob.files) == {"step"} | {f"master::{p}" for p in paths} | {
        f"state::{p}::{m}" for p in paths for m in ("m", "v")}
    assert int(blob["step"]) == 2
    assert sorted(f.name for f in (tag / "state").iterdir()) == [
        "loss_scale.pt", "params.pt"]
    other = jax.tree.map(lambda x: x + 1.0, gpt2_params)
    c = _gpt2_engine(other, ds, torch.bfloat16)
    c.load_checkpoint(str(tmp_path))
    assert c.global_steps == 2 and c.host_opt.adam.step_count == 2
    lc = c.train_batch(batches[2])["loss"]
    assert torch.equal(lc, la[2])
    for k in a.params:
        assert torch.equal(c.host_opt.master[k], a.host_opt.master[k]), k
        assert torch.equal(c.host_opt.state[k]["v"], a.host_opt.state[k]["v"])
        assert torch.equal(c.params[k], a.params[k]), k
    # zero_to_fp32 reads the host master, in the leaves' shapes
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    for k, v in b.fp32_master_params().items():
        assert torch.equal(sd[k], v), k
    # an engine without the host offload cannot take this layout
    d = _gpt2_engine(gpt2_params, dict(ds, zero_optimization={"stage": 1}),
                     torch.bfloat16)
    with pytest.raises(ValueError, match="no 'master' group"):
        d.load_checkpoint(str(tmp_path))


def test_load_module_only_resyncs_the_master(gpt2_params, tmp_path):
    ds = dict(BASE, zero_optimization=HOST, bf16={"enabled": True})
    eng = _gpt2_engine(gpt2_params, ds, torch.bfloat16)
    for b in _batches(2):
        eng.train_batch(b)
    eng.save_checkpoint(str(tmp_path))
    trained = {k: v.clone() for k, v in eng.host_opt.master.items()}
    for only in (dict(load_module_only=True),
                 dict(load_optimizer_states=False)):
        eng2 = _gpt2_engine(gpt2_params, ds, torch.bfloat16)
        eng2.load_checkpoint(str(tmp_path), **only)
        for k, p in eng2.params.items():
            # the master is the restored (trained) bf16 params, in f32
            assert torch.equal(eng2.host_opt.master[k],
                               p.detach().float().reshape(-1)), k
            torch.testing.assert_close(eng2.host_opt.master[k], trained[k],
                                       rtol=1e-2, atol=1e-2)
        assert eng2.host_opt.adam.step_count == 0
        assert float(eng2.host_opt.state["wte"]["v"].abs().max()) == 0.0


def test_import_and_module_state_resync_the_host_master(gpt2_params):
    from deepspeed_tpu_torch.checkpoint.import_deepspeed import \
        import_into_engine
    ds = dict(BASE, zero_optimization=HOST, bf16={"enabled": True})
    eng = _gpt2_engine(gpt2_params, ds, torch.bfloat16)
    tree = {k: torch.full(v.shape, 0.5) for k, v in eng.params.items()}
    import_into_engine(eng, tree)
    assert all(float(m.min()) == float(m.max()) == 0.5
               for m in eng.host_opt.master.values())
    eng.load_module_state_dict({k: torch.full(v.shape, 0.25)
                                for k, v in eng.params.items()})
    assert all(float(m.min()) == float(m.max()) == 0.25
               for m in eng.host_opt.master.values())
    assert np.isfinite(eng.train_batch(_batches(1)[0])["loss"].item())
