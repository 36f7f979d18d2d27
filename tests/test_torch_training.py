"""Single-device training of the port against the JAX package on the CPU.

Both engines start from the same flax-initialised weights of a tiny GPT-2
(2 layers, n_embd 64, 4 heads, vocabulary 96 padded to 128, T = 64) and
take the same numpy batches for 4 ``train_batch`` steps; the JAX engine
runs on a one-device mesh. Tolerances, each with its reason:

* fp32 (AdamW, WarmupLR, clipping, gas 2): losses and gradient norms to
  1e-5 relative (the same f32 function, summed in another order); the
  final f32 master to ``lr / 10`` absolute: Adam divides each gradient
  element by its own running magnitude, so where an element's gradient is
  near the f32 noise of its sums the last-bit differences reach the update
  at up to ``lr`` scale.
* bf16: losses to 1e-2 relative; the 4 steps' update of the f32 master
  (final master minus the initial weights) to 0.1 relative L2 per leaf
  (activations and gradients are rounded to bf16 at different places in
  the two frameworks; the worst leaf read 2.2e-2 on the CPU, an engine
  that leaves the master alone reads 1). The key third of ``c_attn.bias``
  is held only to Adam's bound: its exact gradient is zero (a bias on
  every key shifts a row's scores by one constant), so both engines
  update it from rounding noise.
* fp16 with dynamic loss scaling and batches that overflow: the skipped
  steps, ``skipped_steps`` and the loss-scale trajectory exactly; losses
  of the steps taken to 1e-2.

The pure parts (schedules, optimizers, loss-scale updates, data-loader
order, config errors) are compared directly.
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
from deepspeed_tpu_torch.module_inject.from_jax import (gpt2_params_from_flax,
                                                        gpt2_params_to_numpy)

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
STEPS = 4
LR = 1e-3


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def flax_params():
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(1), batch_size=2,
                                     seq_len=64))


def _batches(n, rows, weights=None):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        b = {"input_ids": rng.integers(0, TINY["vocab_size"],
                                       (rows, 64)).astype(np.int32)}
        if weights is not None:
            b["w"] = np.full((rows,), weights[i], np.float32)
        out.append(b)
    return out


def _weighted(loss_fn):
    """A loss scaled by the batch's weight ``w`` (1 normally; a huge
    weight makes the fp16 gradients overflow on both sides)."""
    def fn(params, batch, rng=None):
        return loss_fn(params, batch, rng) * batch["w"].mean()
    return fn


def _run_both(flax_params, ds_config, jdtype, tdtype, batches,
              weighted=False):
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY, dtype=jdtype))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=flax_params, config=dict(ds_config),
        loss_fn=_weighted(jmodel.loss_fn) if weighted else None,
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    tmodel = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY, dtype=tdtype))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=gpt2_params_from_flax(flax_params),
        config=dict(ds_config), device="cpu",
        loss_fn=_weighted(tmodel.loss_fn) if weighted else None)
    jm, tm = [], []
    for b in batches:
        jm.append({k: np.asarray(v) for k, v in jeng.train_batch(
            {k: jnp.asarray(x) for k, x in b.items()}).items()})
        tm.append({k: (v.detach().numpy() if torch.is_tensor(v)
                       else np.asarray(v))
                   for k, v in teng.train_batch(b).items()})
    return jeng, teng, jm, tm


BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 0.5,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": 3,
                                 "warmup_type": "linear"}}}


def test_fp32_trajectory_matches_jax(flax_params):
    jeng, teng, jm, tm = _run_both(flax_params, BASE, jnp.float32,
                                   torch.float32, _batches(STEPS, 4))
    for j, t in zip(jm, tm):
        assert set(t) == {"loss", "grad_norm", "lr", "loss_scale", "skipped"}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
        assert t["loss_scale"] == j["loss_scale"] == 1.0
        assert not t["skipped"] and not j["skipped"]
    assert tm[0]["grad_norm"] > BASE["gradient_clipping"]   # clip engaged
    assert tm[-1]["loss"] < tm[0]["loss"]
    jmaster = _flatten(jeng.fp32_master_params())
    tmaster = _flatten(gpt2_params_to_numpy(teng.fp32_master_params()))
    assert set(jmaster) == set(tmaster)
    for k in jmaster:
        np.testing.assert_allclose(tmaster[k], jmaster[k], atol=LR / 10,
                                   err_msg=k)
    assert teng.global_steps == jeng.global_steps == STEPS
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.skipped_steps == 0
    assert teng.gradient_accumulation_steps() == 2
    assert teng.train_micro_batch_size_per_gpu() == 2
    assert teng.zero_optimization_stage() == 0


def test_bf16_trajectory_matches_jax(flax_params):
    cfg = dict(BASE, bf16={"enabled": True})
    jeng, teng, jm, tm = _run_both(flax_params, cfg, jnp.bfloat16,
                                   torch.bfloat16, _batches(STEPS, 4))
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-2)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=5e-2)
    assert all(p.dtype == torch.bfloat16 for p in teng.params.values())
    init = _flatten(flax_params)
    jmaster = _flatten(jeng.fp32_master_params())
    tmaster = _flatten(gpt2_params_to_numpy(teng.fp32_master_params()))
    assert set(jmaster) == set(tmaster) == set(init)
    C = TINY["n_embd"]
    for k in jmaster:
        dj, dt = jmaster[k] - init[k], tmaster[k] - init[k]
        if k.endswith("c_attn.bias"):
            # warm-up lrs 0, LR/3, 2LR/3, LR: Adam moves a weight <= 2 LR
            assert np.abs(dt[C:2 * C]).max() <= 2 * LR * 1.01, k
            dj, dt = np.delete(dj, np.s_[C:2 * C]), np.delete(dt, np.s_[C:2 * C])
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= 0.1, (k, rel)
    # the compute params are the master cast to bf16
    for k, p in teng.params.items():
        assert torch.equal(p.detach(), teng.master[k].to(torch.bfloat16))


def test_fp16_overflow_skips_match_jax(flax_params):
    cfg = dict(BASE, fp16={"enabled": True, "initial_scale_power": 8,
                           "loss_scale_window": 2, "hysteresis": 2})
    cfg.pop("scheduler")
    # steps 2 and 3 overflow: the first spends the hysteresis, the second
    # halves the scale; step 4 trains at the new scale
    jeng, teng, jm, tm = _run_both(flax_params, cfg, jnp.float16,
                                   torch.float16,
                                   _batches(STEPS, 4, [1, 1e9, 1e9, 1]),
                                   weighted=True)
    assert [bool(t["skipped"]) for t in tm] == \
        [bool(j["skipped"]) for j in jm] == [False, True, True, False]
    assert [float(t["loss_scale"]) for t in tm] == \
        [float(j["loss_scale"]) for j in jm] == [256.0, 256.0, 256.0, 128.0]
    assert teng.skipped_steps == jeng.skipped_steps == 2
    assert teng.get_loss_scale() == jeng.get_loss_scale() == 128.0
    for i in (0, 3):
        np.testing.assert_allclose(tm[i]["loss"], jm[i]["loss"], rtol=1e-2)


def test_micro_batch_api_equals_train_batch(flax_params):
    """forward/backward/step over the gas micro-batches gives the same
    step as train_batch (the same f32 sums in the same order)."""
    cfg = dict(BASE)
    engines = []
    for _ in range(2):
        model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
            **TINY, dtype=torch.float32))
        engines.append(deepspeed_tpu_torch.initialize(
            model=model, model_parameters=gpt2_params_from_flax(flax_params),
            config=cfg, device="cpu")[0])
    fused, split = engines
    for b in _batches(2, 4):
        m = fused.train_batch(b)
        losses = []
        for i in range(2):
            mb = {k: v[2 * i:2 * i + 2] for k, v in b.items()}
            f = split.forward(mb)
            losses.append(split.backward(mb))
            assert torch.equal(f, losses[-1])
            assert (split.step() is None) == (i == 0)
        assert split.global_steps == fused.global_steps
    assert torch.equal(m["loss"], sum(losses) / 2)
    for k, v in fused.params.items():
        assert torch.equal(v, split.params[k]), k


def test_dataloader_order_matches_jax():
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JDL
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)
    data = [{"input_ids": np.full((3,), i, np.int32)} for i in range(10)]
    jl, tl = JDL(data, batch_size=4, seed=7), DeepSpeedDataLoader(
        data, batch_size=4, seed=7)
    assert len(tl) == len(jl) == 2
    for _ in range(5):   # across epochs, through __next__
        np.testing.assert_array_equal(next(tl)["input_ids"],
                                      next(jl)["input_ids"])
    rep = RepeatingLoader([1, 2])
    assert [next(rep) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_engine_takes_batches_from_its_loader(flax_params):
    data = [{"input_ids": np.full((64,), i, np.int32)} for i in range(8)]
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY,
                                                       dtype=torch.float32))
    eng, _, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=gpt2_params_from_flax(flax_params),
        config=BASE, training_data=data, device="cpu")
    assert len(loader) == 2 and sched(3) == pytest.approx(LR)
    out = eng.train_batch()
    assert np.isfinite(out["loss"].item())
    with pytest.raises(ValueError, match="leading dim"):
        eng.train_batch(_batches(1, 3)[0])


def test_config_errors_match_jax():
    from deepspeed_tpu.config.config import DeepSpeedConfig as JCfg
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig as TCfg
    for bad in ({"train_batch_sizee": 8}, {"zero_optimizatoin": {}}):
        with pytest.raises(ValueError) as je:
            JCfg(bad)
        with pytest.raises(ValueError) as te:
            TCfg(bad)
        assert str(te.value) == str(je.value)
        assert "did you mean" in str(te.value)
    triad = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
             "gradient_accumulation_steps": 2}
    with pytest.raises(ValueError, match="Check batch related"):
        TCfg(triad, dp_world_size=1)
    for pd, ws in (({"train_batch_size": 16,
                     "gradient_accumulation_steps": 4}, 1),
                   ({"train_micro_batch_size_per_gpu": 2}, 1),
                   ({"train_batch_size": 12,
                     "train_micro_batch_size_per_gpu": 3}, 2)):
        j, t = JCfg(pd, dp_world_size=ws), TCfg(pd, dp_world_size=ws)
        assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
                t.gradient_accumulation_steps) == (
            j.train_batch_size, j.train_micro_batch_size_per_gpu,
            j.gradient_accumulation_steps)
    for pd in ({}, {"bf16": {"enabled": True}}, {"fp16": {"enabled": True}},
               {"amp": {"enabled": True}}):
        assert TCfg(pd).precision_dtype == JCfg(pd).precision_dtype


@pytest.mark.parametrize("extra", [
    # ZeRO stages 1-3 and the cpu and nvme offload tiers run
    # (test_torch_offload.py, test_torch_param_offload.py,
    # test_torch_nvme.py), and so do the data, fsdp, tensor and seq axes
    # and sparse_gradients over ranks (test_torch_dist_parity.py,
    # test_torch_tp_training.py); the pipe axis, beside the seq or tensor
    # axis too, does not
    {"zero_optimization": {"stage": 3}, "mesh": {"seq": 2, "pipe": 2}},
    {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}},
    {"mesh": {"pipe": 2}},
    {"mesh": {"tensor": 2, "pipe": 2}},
    {"curriculum_learning": {"enabled": True}},
    {"compression_training": {"weight_quantization": {}}},
    {"eigenvalue": {"enabled": True, "layer_name": "h"}},
    {"flops_profiler": {"enabled": True}},
])
def test_queue_c_options_raise(flax_params, extra):
    cfg = {"train_micro_batch_size_per_gpu": 2, **extra}
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    with pytest.raises(NotImplementedError, match="queue C"):
        deepspeed_tpu_torch.initialize(model=model, model_parameters={},
                                       config=cfg, device="cpu")


def test_checkpoints_pipelines_and_device_default(flax_params, tmp_path):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    params = gpt2_params_from_flax(flax_params)
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 1}, device="cpu")[0]
    # checkpoints are ported (tests/test_torch_checkpoint.py): an empty
    # directory loads nothing, and a save publishes a verified tag
    assert eng.load_checkpoint(str(tmp_path / "none")) == (None, {})
    path = eng.save_checkpoint(str(tmp_path / "ck"))
    assert (tmp_path / "ck" / "latest").read_text() == "global_step0"
    assert eng.load_checkpoint(str(tmp_path / "ck"))[0] == path
    # (loss, aux) loss functions are ported: aux scalars join the metrics
    aux = deepspeed_tpu_torch.initialize(
        loss_fn=lambda p, b, r: (model.loss_fn(p, b, r), {"x": 1.0}),
        model_parameters=params, config={"train_batch_size": 1},
        device="cpu")[0]
    assert float(aux.train_batch(_batches(1, 1)[0])["x"]) == 1.0

    class TwoStages:
        num_stages = 2
        loss_fn = model.loss_fn
    with pytest.raises(NotImplementedError, match="pipeline"):
        deepspeed_tpu_torch.initialize(model=TwoStages(),
                                       model_parameters=params,
                                       config={"train_batch_size": 1},
                                       device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                       config={"train_batch_size": 1})


# ------------------------------------------------------------- pure parts

def test_schedules_match_jax():
    from deepspeed_tpu.runtime import lr_schedules as J
    from deepspeed_tpu_torch.runtime import lr_schedules as T
    cases = [("WarmupLR", dict(warmup_max_lr=0.01, warmup_num_steps=10)),
             ("WarmupLR", dict(warmup_max_lr=0.01, warmup_num_steps=10,
                               warmup_type="linear", warmup_min_lr=1e-4)),
             ("WarmupDecayLR", dict(total_num_steps=30, warmup_max_lr=0.01,
                                    warmup_num_steps=10)),
             ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                               cycle_first_step_size=5, decay_step_size=3,
                               decay_lr_rate=0.5)),
             ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                               cycle_first_step_size=5,
                               cycle_second_step_size=7)),
             ("LRRangeTest", dict(lr_range_test_step_size=4,
                                  lr_range_test_staircase=True)),
             ("ConstantLR", dict(lr=3e-4))]
    # 1e-5: the JAX schedules compute in f32 (max - (max - min) loses
    # ~2e-6 of min by cancellation), the port's in Python floats
    for name, kw in cases:
        j, t = J.SCHEDULE_REGISTRY[name](**kw), T.SCHEDULE_REGISTRY[name](**kw)
        for step in range(0, 40):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-5,
                                            abs=1e-12), (name, step)
    assert T.build_schedule(None, {"lr": 0.2})(5) == 0.2


@pytest.mark.parametrize("name,params", [
    ("AdamW", {"weight_decay": 0.1}),
    ("Adam", {"adam_w_mode": False, "weight_decay": 0.1}),
    ("Lamb", {"weight_decay": 0.01}),
    ("SGD", {"momentum": 0.9, "weight_decay": 0.01}),
    ("Adagrad", {}),
])
def test_optimizers_match_jax(name, params):
    from deepspeed_tpu.ops import adam as J
    from deepspeed_tpu_torch.ops import adam as T
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    jo, to = J.build_optimizer(name, dict(params)), T.build_optimizer(
        name, dict(params))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           1e-2)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, 1e-2)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
    assert ts.count == 3
    with pytest.raises(NotImplementedError, match="queue C"):
        T.build_optimizer("ZeroOneAdam")


def test_loss_scale_trajectory_matches_jax():
    from deepspeed_tpu.config.config import FP16Config as JF
    from deepspeed_tpu.runtime import precision as J
    from deepspeed_tpu_torch.config.config import FP16Config as TF
    from deepspeed_tpu_torch.runtime import precision as T
    kw = dict(enabled=True, initial_scale_power=4, loss_scale_window=3,
              hysteresis=2, min_loss_scale=2.0)
    js, ts = J.make_loss_scale(JF(**kw)), T.make_loss_scale(TF(**kw))
    flags = [1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1]
    for f in flags:
        js = J.update_loss_scale(js, jnp.bool_(f))
        ts = T.update_loss_scale(ts, torch.tensor(bool(f)))
        assert float(ts.scale) == float(js.scale)
        assert int(ts.hysteresis) == int(js.hysteresis)
        assert int(ts.growth_tracker) == int(js.growth_tracker)
    static = T.make_loss_scale(TF(enabled=True, loss_scale=64.0))
    assert T.update_loss_scale(static, torch.tensor(False)) is static
    assert not T.grads_finite([torch.ones(2), torch.tensor([1.0, np.inf])])


def test_clip_coef_guards_nan():
    from deepspeed_tpu.runtime.utils import clip_coef as jclip
    from deepspeed_tpu_torch.runtime.utils import (clip_coef,
                                                   clip_grad_norm_,
                                                   global_norm)
    for g in (0.5, 3.0, float("inf"), float("nan")):
        assert float(clip_coef(1.0, torch.tensor(g))) == pytest.approx(
            float(jclip(1.0, jnp.float32(g))))
    grads = [torch.full((4,), 3.0), torch.full((9,), 4.0)]
    assert float(global_norm(grads)) == pytest.approx(np.sqrt(36 + 144))
    grads, norm = clip_grad_norm_(grads, 1.0)
    assert float(global_norm(grads)) == pytest.approx(1.0, rel=1e-5)
