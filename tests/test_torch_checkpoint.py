"""Checkpoints of the port's training engine, against itself and against
the JAX engine, on the CPU.

* Resume: save at step 2, load into a fresh engine built from OTHER
  weights (so a load that does nothing fails), take steps 3-4: losses,
  the master and the compute params equal an uninterrupted 4-step run
  bit for bit, in fp32, bf16 and fp16 with an overflow skip before the
  save (the loss scale's hysteresis must survive the round trip).
* The commit protocol: ``load_optimizer_states=False`` and
  ``load_module_only``, ``keep_last`` and its reclaimed-bytes counter,
  the async engine's "completed means durable", a failed finalize
  surfacing at the next save and in ``destroy``, no ``.tmp`` debris.
* The corruption matrix of ``tests/test_resilience.py`` (a flipped byte,
  a truncated state file, a missing manifest, a missing file, a stale
  ``latest``, a corrupt pinned tag, every tag corrupt): the port and the
  JAX engine land on the same tag with the same reason class, or raise
  the same refusal.
* ``(loss, aux)`` metrics and the engine accessors against the JAX
  engine (fp32: 1e-5 relative, the same f32 function summed in another
  order).
* Across packages: the JAX engine trains 2 steps, its state (as numpy)
  goes into a port engine through ``load_engine_state_from_numpy``, and
  both take steps 3-4 within ``tests/test_torch_training.py``'s fp32
  tolerances (losses 1e-5 relative, the master ``lr / 10`` absolute) —
  not bit for bit: Adam's bias corrections are host f64 in the port and
  f32 in JAX.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.telemetry import FaultInjector
from deepspeed_tpu.telemetry import get_event_ring as jax_event_ring
from deepspeed_tpu_torch.checkpoint.integrity import (committed_tags,
                                                      verify_checkpoint)
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject.from_jax import (
    gpt2_params_from_flax, gpt2_params_to_numpy, load_engine_state_from_numpy)
from deepspeed_tpu_torch.telemetry import MetricRegistry
from deepspeed_tpu_torch.telemetry.events import \
    get_event_ring as port_event_ring

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
LR = 1e-3
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 0.5,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": LR,
                                 "warmup_num_steps": 3,
                                 "warmup_type": "linear"}}}
FP16 = {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 2,
        "hysteresis": 2}
PRECISIONS = {
    "fp32": (torch.float32, {}, [1, 1, 1, 1]),
    "bf16": (torch.bfloat16, {"bf16": {"enabled": True}}, [1, 1, 1, 1]),
    # step 2 overflows (spends the hysteresis), step 3 overflows again
    # (halves the scale): the save at step 2 must carry the hysteresis
    "fp16_skip": (torch.float16, {"fp16": FP16}, [1, 1e9, 1e9, 1]),
}


def _batches(weights, rows=4, seed=4):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"],
                                       (rows, 64)).astype(np.int32),
             "w": np.full((rows,), w, np.float32)} for w in weights]


def _weighted(loss_fn):
    def fn(params, batch, rng=None):
        return loss_fn(params, batch, rng) * batch["w"].mean()
    return fn


def _port(dtype=torch.float32, extra=None, seed=1, params=None):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY, dtype=dtype))
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed))
    cfg = {**BASE, **(extra or {})}
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=cfg, device="cpu",
        loss_fn=_weighted(model.loss_fn))[0]


def _f(x):
    return float(x)


def _state_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    ma, mb = a.fp32_master_params(), b.fp32_master_params()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_resume_is_bit_identical(tmp_path, precision):
    dtype, extra, weights = PRECISIONS[precision]
    batches = _batches(weights)
    a = _port(dtype, extra)
    ma = [a.train_batch(b) for b in batches]
    b = _port(dtype, extra)
    for x in batches[:2]:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path))
    b.destroy()
    c = _port(dtype, extra, seed=7)   # other weights: a no-op load fails
    path, client = c.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "global_step2" and client == {}
    assert (c.global_steps, c._micro_steps) == (2, 4)
    mc = [c.train_batch(x) for x in batches[2:]]
    for x, y in zip(ma[2:], mc):
        for k in ("loss", "grad_norm", "lr", "loss_scale", "skipped"):
            # bit for bit; an overflow step's norm is NaN on both
            assert np.array_equal(_f(x[k]), _f(y[k]), equal_nan=True), \
                (k, x[k], y[k])
    _state_equal(a, c)
    assert c.global_steps == a.global_steps == 4
    assert c.skipped_steps == a.skipped_steps
    assert c.get_loss_scale() == a.get_loss_scale()
    assert c.opt_state.count == a.opt_state.count
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], c.opt_state.mu[k])
        assert torch.equal(a.opt_state.nu[k], c.opt_state.nu[k])
    if precision == "fp16_skip":
        assert [bool(m["skipped"]) for m in ma] == [False, True, True, False]
        assert a.skipped_steps == 2 and a.get_loss_scale() == 128.0


@pytest.mark.parametrize("how", ["load_optimizer_states", "load_module_only"])
def test_partial_loads_keep_the_optimizer(tmp_path, how):
    batches = _batches([1, 1])
    b = _port()
    for x in batches:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path))
    c = _port(seed=7)
    fresh_mu = {k: v.clone() for k, v in c.opt_state.mu.items()}
    kw = ({"load_optimizer_states": False} if how == "load_optimizer_states"
          else {"load_module_only": True})
    c.load_checkpoint(str(tmp_path), **kw)
    _state_equal(b, c)                  # the weights come back
    assert c.global_steps == 2          # the counters too (as in JAX)
    assert c.opt_state.count == 0       # the optimizer stays as it was
    for k, v in fresh_mu.items():
        assert torch.equal(c.opt_state.mu[k], v)


def test_keep_last_bounds_tags_and_counts_reclaimed_bytes(tmp_path):
    port_event_ring().clear()
    e = _port(extra={"checkpoint": {"keep_last": 2}})
    e.telemetry = MetricRegistry()
    for x in _batches([1] * 4):
        e.train_batch(x)
        e.save_checkpoint(str(tmp_path))
    assert [t for _, t in committed_tags(str(tmp_path))] == \
        ["global_step4", "global_step3"]
    gc = e.telemetry.snapshot()["ckpt_gc_reclaimed_total"]["series"][0]
    assert gc["value"] > 0
    assert any(ev["kind"] == "ckpt_gc" for ev in port_event_ring().snapshot())
    path, _ = e.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "global_step4"


def test_save_leaves_no_tmp_debris_and_a_verified_manifest(tmp_path):
    e = _port()
    e.train_batch(_batches([1])[0])
    ckpt = e.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    for dirpath, _, names in os.walk(str(tmp_path)):
        assert not [n for n in names if n.endswith(".tmp")], dirpath
    assert verify_checkpoint(ckpt) == (True, "ok")
    assert sorted(os.listdir(os.path.join(ckpt, "state"))) == \
        ["loss_scale.pt", "master.pt", "optimizer.pt"]
    assert e.load_checkpoint(str(tmp_path))[1] == {"epoch": 3}
    with pytest.raises(TypeError, match="not JSON-serializable"):
        e.save_checkpoint(str(tmp_path), tag="bad",
                          client_state={"t": torch.ones(1)})


def test_async_completed_means_durable_and_snapshot_is_the_save_step(
        tmp_path):
    batches = _batches([1] * 4)
    e = _port(extra={"checkpoint": {"engine": "async"}})
    for x in batches[:2]:
        e.train_batch(x)
    at_save = {k: v.clone() for k, v in e.fp32_master_params().items()}
    e.save_checkpoint(str(tmp_path))
    for x in batches[2:]:            # in-place steps while it may write
        e.train_batch(x)
    e.destroy()                      # joins: 'latest' durable afterwards
    assert e._ckpt_finalize_thread is None and e._ckpt_engine is None
    assert (tmp_path / "latest").read_text() == "global_step2"
    assert verify_checkpoint(str(tmp_path / "global_step2"))[0]
    f = _port(seed=7, extra={"checkpoint": {"engine": "async"}})
    f.load_checkpoint(str(tmp_path))
    got = f.fp32_master_params()
    for k, v in at_save.items():
        assert torch.equal(got[k], v), k
    assert f.global_steps == 2
    f.destroy()


class _FailOnce:
    """The chaos hook the engine calls before it commits a tag."""

    def __init__(self):
        self.armed = True

    def check_ckpt_write(self, tag):
        if self.armed:
            self.armed = False
            raise OSError(f"injected checkpoint write failure for {tag!r}")


def test_failed_async_finalize_surfaces_at_next_save(tmp_path):
    e = _port(extra={"checkpoint": {"engine": "async"}})
    e.fault_injector = _FailOnce()
    e.train_batch(_batches([1])[0])
    e.save_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="finalize failed"):
        e.save_checkpoint(str(tmp_path))
    path = e.save_checkpoint(str(tmp_path))   # the retry publishes
    e.destroy()
    assert verify_checkpoint(path)[0]
    assert (tmp_path / "latest").read_text() == "global_step1"


def test_failed_async_finalize_surfaces_in_destroy(tmp_path):
    e = _port(extra={"checkpoint": {"engine": "async"}})
    e.fault_injector = _FailOnce()
    e.train_batch(_batches([1])[0])
    e.save_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="finalize failed"):
        e.destroy()
    assert not (tmp_path / "latest").exists()
    assert e._ckpt_engine is None   # the raise came after the teardown
    e.destroy()                     # one-shot: a second destroy is clean


# ------------------------------------------------- the corruption matrix

D_IN, D_OUT, ROWS = 8, 4, 4


def _mlp_init():
    rng = np.random.default_rng(3)
    return (rng.normal(0, 0.1, (D_IN, D_IN)).astype(np.float32),
            rng.normal(0, 0.1, (D_IN, D_OUT)).astype(np.float32))


def _mlp_batch(step):
    rng = np.random.default_rng(500 + step)
    return {"x": rng.normal(size=(ROWS, D_IN)).astype(np.float32),
            "y": rng.normal(size=(ROWS, D_OUT)).astype(np.float32)}


_MLP_CFG = {"train_micro_batch_size_per_gpu": ROWS,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}


def _jax_mlp():
    w0, w1 = _mlp_init()

    def loss_fn(p, b, rng_):
        h = jnp.tanh(b["x"] @ p["blk0"]["w"])
        return jnp.mean((h @ p["blk1"]["w"] - b["y"]) ** 2)
    return deepspeed_tpu.initialize(
        loss_fn=loss_fn, model_parameters={"blk0": {"w": jnp.asarray(w0)},
                                           "blk1": {"w": jnp.asarray(w1)}},
        config=dict(_MLP_CFG),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


def _port_mlp():
    w0, w1 = _mlp_init()

    def loss_fn(p, b, rng_):
        h = torch.tanh(b["x"] @ p["blk0.w"])
        return torch.mean((h @ p["blk1.w"] - b["y"]) ** 2)
    return deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, model_parameters={"blk0.w": torch.from_numpy(w0),
                                           "blk1.w": torch.from_numpy(w1)},
        config=dict(_MLP_CFG), device="cpu")[0]


def _flip(tag_dir):
    FaultInjector(seed=1).corrupt_checkpoint(tag_dir)


def _truncate(tag_dir):
    files = []
    for dirpath, _, names in os.walk(os.path.join(tag_dir, "state")):
        files += [os.path.join(dirpath, f) for f in names]
    victim = max(files, key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(max(os.path.getsize(victim) // 2, 1))


CORRUPTIONS = {
    "flipped_byte": lambda good, new: _flip(new),
    "truncated_state_file": lambda good, new: _truncate(new),
    "missing_manifest": lambda good, new: os.unlink(
        os.path.join(new, "manifest.json")),
    "missing_file": lambda good, new: os.unlink(
        os.path.join(new, "client_state.json")),
    "stale_latest": lambda good, new: shutil.rmtree(new),
    "explicit_corrupt_tag": lambda good, new: _flip(new),
    "every_tag_corrupt": lambda good, new: (_flip(good), _flip(new)),
}


def _outcome(engine, save_dir, ring, case):
    """(tag landed on, global_steps, reason classes of the rejected
    tags) or ("raised", the refusal's key phrase)."""
    ring.clear()
    tag = "global_step2" if case == "explicit_corrupt_tag" else None
    try:
        path, _ = engine.load_checkpoint(save_dir, tag=tag)
    except RuntimeError as e:
        msg = str(e)
        return ("raised", [p for p in ("silently substitute",
                                       "refusing to restore") if p in msg])
    reasons = [ev["data"]["reason"].split(":", 1)[0]
               for ev in ring.snapshot() if ev["kind"] == "ckpt_fallback"]
    return (os.path.basename(path), engine.global_steps, reasons)


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_matrix_lands_where_jax_does(tmp_path, case):
    outcomes = []
    for name, make, ring in (("jax", _jax_mlp, jax_event_ring()),
                             ("port", _port_mlp, port_event_ring())):
        engine = make()
        d = str(tmp_path / name)
        engine.train_batch(_mlp_batch(0))
        good = engine.save_checkpoint(d)
        engine.train_batch(_mlp_batch(1))
        new = engine.save_checkpoint(d)
        CORRUPTIONS[case](good, new)
        outcomes.append(_outcome(engine, d, ring, case))
        engine.destroy()
    jax_out, port_out = outcomes
    assert port_out == jax_out, (port_out, jax_out)
    if case.startswith(("explicit", "every")):
        assert port_out[0] == "raised" and len(port_out[1]) == 1
    else:
        assert port_out[:2] == ("global_step1", 1) and port_out[2]


def test_corruption_fallback_restores_the_good_tag_weights(tmp_path):
    e = _port_mlp()
    e.train_batch(_mlp_batch(0))
    e.save_checkpoint(str(tmp_path))
    at_good = e.fp32_master_params()
    e.train_batch(_mlp_batch(1))
    new = e.save_checkpoint(str(tmp_path))
    reg = MetricRegistry()
    e.telemetry = reg
    _flip(new)
    e.load_checkpoint(str(tmp_path))
    for k, v in e.fp32_master_params().items():
        assert torch.equal(v, at_good[k])
    series = reg.snapshot()["ckpt_verify_failures_total"]["series"]
    assert [(s["labels"], s["value"]) for s in series] == \
        [({"reason": "checksum_mismatch"}, 1.0)]


# --------------------------------------- against the JAX engine (GPT-2)

@pytest.fixture(scope="module")
def flax_params():
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(1), batch_size=2,
                                     seq_len=64))


def _jax_gpt2(flax_params, loss_fn=None, cfg=None):
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return deepspeed_tpu.initialize(
        model=model, model_parameters=flax_params,
        config=dict(cfg or BASE),
        loss_fn=loss_fn(model.loss_fn) if loss_fn else None,
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


def _port_gpt2(flax_params, loss_fn=None, cfg=None):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY,
                                                       dtype=torch.float32))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=gpt2_params_from_flax(flax_params),
        config=dict(cfg or BASE), device="cpu",
        loss_fn=loss_fn(model.loss_fn) if loss_fn else None)[0]


def _with_aux(loss_fn):
    def fn(params, batch, rng=None):
        loss = loss_fn(params, batch, rng)
        return loss, {"double": 2.0 * loss, "tokens": 64.0}
    return fn


def test_loss_aux_metrics_match_jax(flax_params):
    jeng = _jax_gpt2(flax_params, _with_aux)
    teng = _port_gpt2(flax_params, _with_aux)
    for b in _batches([1, 1]):
        b = {"input_ids": b["input_ids"]}
        j = jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        t = teng.train_batch(b)
        assert {"double", "tokens"} <= set(t) & set(j)
        for k in ("loss", "double", "tokens", "grad_norm"):
            np.testing.assert_allclose(_f(t[k]), _f(j[k]), rtol=1e-5,
                                       err_msg=k)
        assert _f(t["double"]) == pytest.approx(2 * _f(t["loss"]),
                                                rel=1e-6)


@pytest.mark.parametrize("aux,err,match", [
    ([1.0], TypeError, "aux_dict"),
    ({"lr": 1.0}, ValueError, "collide"),
    ({"v": [1.0, 2.0]}, ValueError, "non-scalar"),
])
def test_loss_aux_refusals_match_jax(aux, err, match):
    from deepspeed_tpu.runtime.engine import _split_loss_out as jax_split
    from deepspeed_tpu_torch.runtime.engine import _split_loss_out
    for split in (jax_split, _split_loss_out):
        with pytest.raises(err, match=match):
            split((1.0, aux))


def test_accessors_match_jax(flax_params):
    cfg = dict(BASE, fp16=dict(FP16), steps_per_print=7,
               wall_clock_breakdown=True)
    cfg.pop("scheduler")
    jeng = _jax_gpt2(flax_params, _weighted, cfg)
    teng = _port_gpt2(flax_params, _weighted, cfg)
    for name, e in (("jax", jeng), ("port", teng)):
        assert not e.was_step_applied() and e.get_global_grad_norm() is None
    for b in _batches([1, 1e9]):
        jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        teng.train_batch(b)
    for fn in ("get_batch_info", "optimizer_name", "optimizer_params",
               "scheduler_name", "scheduler_params", "get_mom",
               "gradient_clipping", "loss_scale", "get_loss_scale",
               "dynamic_loss_scale", "steps_per_print",
               "wall_clock_breakdown", "memory_breakdown",
               "communication_data_type", "zero_optimization",
               "zero_optimization_stage", "zero_cpu_offload",
               "zero_offload_optimizer", "zero_offload_param",
               "sparse_gradients_enabled", "curriculum_enabled",
               "train_micro_batch_size_per_gpu",
               "gradient_accumulation_steps", "was_step_applied"):
        assert getattr(teng, fn)() == getattr(jeng, fn)(), fn
    assert teng.global_samples == jeng.global_samples == 8
    assert teng.get_lr() == pytest.approx(jeng.get_lr())
    # step 2 overflowed: its norm is NaN on both sides
    assert np.isnan(teng.get_global_grad_norm())
    assert np.isnan(jeng.get_global_grad_norm())
    teng.train(False)
    assert not teng._train_mode
    teng.eval()
    teng.train()
    # module weights: the JAX engine's dict loads into the port engine
    jsd = jeng.module_state_dict()
    tsd = teng.module_state_dict()
    assert {k.replace("/", "."): tuple(v.shape) for k, v in jsd.items()} \
        == {k: tuple(v.shape) for k, v in tsd.items()}
    other = _port_gpt2(jax.device_get(jax_gpt2.GPT2LMModel(
        jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32)).init(
            jax.random.PRNGKey(9), batch_size=2, seq_len=64)))
    other.load_module_state_dict({k: np.asarray(v) for k, v in jsd.items()})
    for k, v in other.module_state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jsd[k.replace(".", "/")]))
    with pytest.raises(KeyError, match="missing"):
        other.load_module_state_dict({})


def test_cross_package_resume_within_tolerance(flax_params):
    batches = [{"input_ids": b["input_ids"]} for b in _batches([1] * 4)]
    jeng = _jax_gpt2(flax_params)
    jm = [jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
          for b in batches[:2]]
    st = jax.device_get(jeng.state)
    state = {"master": st.params,   # fp32: the params are the master
             "opt_state": {"count": st.opt_state.count,
                           "mu": st.opt_state.mu, "nu": st.opt_state.nu},
             "loss_scale": {"scale": st.loss_scale.scale,
                            "growth_tracker": st.loss_scale.growth_tracker,
                            "hysteresis": st.loss_scale.hysteresis},
             "global_steps": jeng.global_steps,
             "skipped_steps": jeng.skipped_steps,
             "micro_steps": jeng._micro_steps}
    # the port engine starts from other weights: the bridge must move all
    teng = _port_gpt2(jax.device_get(jax_gpt2.GPT2LMModel(
        jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32)).init(
            jax.random.PRNGKey(9), batch_size=2, seq_len=64)))
    load_engine_state_from_numpy(teng, state)
    assert (teng.global_steps, teng.opt_state.count) == (2, 2)
    jm += [jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
           for b in batches[2:]]
    tm = [teng.train_batch(b) for b in batches[2:]]
    for j, t in zip(jm[2:], tm):
        np.testing.assert_allclose(_f(t["loss"]), _f(j["loss"]), rtol=1e-5)
        np.testing.assert_allclose(_f(t["lr"]), _f(j["lr"]), rtol=1e-6)
    jmaster = jax.tree_util.tree_leaves_with_path(
        jax.device_get(jeng.state.params))
    tmaster = gpt2_params_to_numpy(teng.fp32_master_params())
    for path, leaf in jmaster:
        node = tmaster
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=LR / 10,
                                   err_msg=str(path))
    assert teng.global_steps == jeng.global_steps == 4
