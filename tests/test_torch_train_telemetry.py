"""The training flight recorder, numerics, goodput and activation
checkpointing of the port against the JAX package's on the CPU.

* Block names: the port's ``block_spec`` over its flat trees equals JAX's
  over JAX's trees (GPT-2, LLaMA, BERT; depths 1 and 2), names and order.
* Numerics on: 3 fp32 steps of the tiny GPT-2 of
  ``tests/test_torch_offload.py`` on the in-HBM path and on the host
  offload path; each block's grad, param and update norms (the offload
  path has no update norm, as in JAX) within 1e-5 relative of the JAX
  engine's; an injected NaN names JAX's first block; the same loss
  sequence fires the same anomalies in both packages' ``NumericsWatch``.
* Goodput: per step against the caller's clock and the host Adam's and
  the param swaps' own timers (in-HBM, host, NVMe params); the buckets
  sum to the wall; off, nothing is recorded.
* The watchdog on a fake clock dumps the ring once a stall; the fault
  dump writes the ring; ``MemoryMonitor``'s owner-matched unregister and
  sampler stop, and its buckets by component.
* Numerics off runs no numerics function.
* Activation checkpointing: ``configure``/``reset``, the refusals,
  ``partition_activations``' saved block (a seq group of 2 faked),
  ``checkpoint`` gradients against ``jax.checkpoint`` (1e-5 in fp32) and
  a plain backward's bit for bit, ``checkpoint_sequential``'s segment bounds, the CPU fallback's
  one warning, ``model_parallel_seed`` by tensor and data rank.
"""
import json
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime import activation_checkpointing as jax_ac
from deepspeed_tpu.telemetry import numerics as jax_num
from deepspeed_tpu.telemetry import watchdog as jax_wd
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject.from_jax import (bert_params_from_jax,
                                                        gpt2_params_from_flax,
                                                        llama_params_from_flax)
from deepspeed_tpu_torch.runtime import activation_checkpointing as port_ac
from deepspeed_tpu_torch.telemetry import events as port_ev
from deepspeed_tpu_torch.telemetry import memory as port_mem
from deepspeed_tpu_torch.telemetry import numerics as port_num
from deepspeed_tpu_torch.telemetry import watchdog as port_wd
from deepspeed_tpu_torch.telemetry.registry import MetricRegistry
from test_torch_bert import _draw as bert_draw
from test_torch_bert import TINY as BTINY
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)
from test_torch_offload import (BASE, TINY, _batches,  # noqa: F401
                                _jax_engine, gpt2_params, llama_params)

NUMERICS = {"telemetry": {"numerics_enabled": True}}
HOST = {"stage": 1, "offload_optimizer": {"device": "cpu"}}


def _port_engine(params, ds, weighted=False):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **TINY, dtype=torch.float32))
    loss_fn = None
    if weighted:
        def loss_fn(p, b, rng=None):
            return model.loss_fn(p, b, rng) + 0 * p["wpe"].sum() * \
                b["w"].mean()
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=gpt2_params_from_flax(params),
        config=dict(ds), device="cpu", loss_fn=loss_fn)[0]


def _jax_gpt2(params, ds, weighted=False):
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    loss_fn = None
    if weighted:
        def loss_fn(p, b, rng=None):
            return model.loss_fn(p, b, rng) + 0 * p["wpe"].sum() * \
                b["w"].mean()
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
    return deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=dict(ds),
        loss_fn=loss_fn,
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


# ---------------------------------------------------------- block names

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kind", ["gpt2", "llama", "bert"])
def test_block_names_equal_jax(gpt2_params, llama_params, kind, depth):
    if kind == "gpt2":
        tree, flat = gpt2_params, gpt2_params_from_flax(gpt2_params)
    elif kind == "llama":
        tree, flat = llama_params, llama_params_from_flax(llama_params)
    else:
        jm = jax_bert.BertPreTrainingModel(jax_bert.BertConfig(**BTINY))
        tree = jax.device_get(bert_draw(np.random.default_rng(5),
                                        jax.eval_shape(jm._build_params,
                                                       jax.random.PRNGKey(0))))
        flat = bert_params_from_jax(tree)
    want = jax_num.block_spec(tree, depth)
    got = port_num.block_spec(flat, depth)
    assert got.names == want.names
    assert len(got.leaf_block) == len(want.leaf_block)
    if kind == "bert" and depth == 2:
        assert "layers/0" in got.names and "pooler/w" in got.names


# ------------------------------------------------------- numerics values

@pytest.mark.parametrize("zero", [{"stage": 0}, HOST], ids=["hbm", "host"])
def test_block_norms_match_jax_fp32(gpt2_params, zero):
    ds = dict(BASE, zero_optimization=zero, **NUMERICS)
    jeng = _jax_gpt2(gpt2_params, ds)
    teng = _port_engine(gpt2_params, ds)
    assert teng._numerics_on and teng.numerics.block_names == \
        jeng.numerics.block_names
    for b in _batches():
        jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        teng.train_batch(b)
        jl, tl = (e.numerics.snapshot()["last"] for e in (jeng, teng))
        assert tl["step"] == jl["step"]
        for jb, tb in zip(jl["blocks"], tl["blocks"]):
            assert tb["block"] == jb["block"]
            assert set(tb) == set(jb)
            for key in ("grad_norm", "param_norm", "update_norm"):
                if key in jb:
                    np.testing.assert_allclose(tb[key], jb[key], rtol=1e-5,
                                               err_msg=(jb["block"], key))
            assert tb["nonfinite"] == jb["nonfinite"] == 0
    assert ("update_norm" in tl["blocks"][0]) == (zero == {"stage": 0})
    teng.destroy()


def test_injected_nan_names_jax_first_block(gpt2_params):
    """A NaN reaches the gradient of ``wpe`` only: both packages name the
    same first block and count the same elements."""
    ds = dict(BASE, **NUMERICS)
    b = dict(_batches(1)[0], w=np.full((4,), np.nan, np.float32))
    jeng = _jax_gpt2(gpt2_params, ds, weighted=True)
    teng = _port_engine(gpt2_params, ds, weighted=True)
    jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
    before = len(port_ev.get_event_ring())
    teng.train_batch(b)
    jn, tn = (e.numerics.snapshot()["nonfinite"] for e in (jeng, teng))
    assert tn["steps_total"] == jn["steps_total"] == 1
    assert tn["last"]["block"] == jn["last"]["block"] == "wpe"
    assert tn["last"]["blocks"] == jn["last"]["blocks"]
    kinds = [e["kind"] for e in json.loads(
        port_ev.get_event_ring().to_json())["events"]][before - 1:]
    assert port_ev.NUMERICS_NONFINITE in kinds
    teng.destroy()


def test_numerics_watch_fires_jax_anomalies():
    losses = [2.0 + 0.01 * (i % 3) for i in range(12)] + [9.0, 2.0,
                                                          float("nan"), 2.0]
    out = []
    for mod in (jax_num, port_num):
        w = mod.NumericsWatch(["a", "b"], registry=MetricRegistry(),
                              window=8, threshold=6.0)
        nf = [0, 0]
        reasons = [w.observe(step=i, loss=x, grad_norms=[1.0, 2.0],
                             nonfinite=nf) for i, x in enumerate(losses)]
        out.append((reasons, w.anomalies_total,
                    w.snapshot()["anomaly"]["last"]))
    assert out[0] == out[1]
    assert out[1][0][12] == "loss_spike" and out[1][0][14] == "nonfinite_loss"


def test_numerics_off_runs_no_numerics_function(gpt2_params):
    """Off (the default) the step calls no block statistic and reads
    nothing back; turned on, it calls them every step."""
    teng = _port_engine(gpt2_params, dict(BASE))
    calls = []

    def spy(name):
        real = getattr(port_num, name)

        def f(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return f
    with mock.patch.object(port_num, "block_sq_norms",
                           spy("block_sq_norms")), \
            mock.patch.object(port_num, "block_nonfinite_counts",
                              spy("block_nonfinite_counts")), \
            mock.patch.object(teng.numerics, "observe",
                              side_effect=AssertionError("observed")):
        teng.train_batch(_batches(1)[0])
        assert calls == []
    teng.set_numerics_enabled(True)
    with mock.patch.object(port_num, "block_sq_norms",
                           spy("block_sq_norms")):
        teng.train_batch(_batches(1)[0])
    assert calls.count("block_sq_norms") == 3   # grads, params, updates
    assert teng.numerics.snapshot()["last"]["step"] == 2
    teng.destroy()


# -------------------------------------------------------------- goodput

@pytest.mark.parametrize("zero", [{"stage": 0}, HOST, "nvme params"],
                         ids=["hbm", "host", "nvme-params"])
def test_goodput_buckets_sum_to_the_wall(gpt2_params, zero, tmp_path):
    if zero == "nvme params":
        zero = {"stage": 3, "offload_optimizer": {"device": "cpu"},
                "offload_param": {"device": "nvme",
                                  "nvme_path": str(tmp_path)}}
    ds = dict(BASE, zero_optimization=zero,
              telemetry={"goodput": True})
    teng = _port_engine(gpt2_params, ds)
    for i, b in enumerate(_batches(2)):
        g0 = teng.goodput.snapshot()
        t = time.perf_counter()
        teng.train_batch(b)
        wall = time.perf_counter() - t
        g1 = teng.goodput.snapshot()
        step = {k: g1[k] - g0[k] for k in ("wall_s", "device_s", "host_s")}
        # against the caller's own clock: the step's wall is inside the
        # call, and the measured device interval ends before the wall does
        # (a device bucket capped at the wall would leave host at 0)
        assert 0 < step["wall_s"] <= wall
        assert step["device_s"] > 0 and step["host_s"] > 0
        if teng.host_opt is not None:
            # the host Adam and the param swaps, each timed on its own,
            # fall in host (the params are on disk from the first step on)
            host = teng.host_opt.last_times["total_s"]
            if teng._param_swapper is not None:
                host += teng.offload_step_times["param_out_s"] + (
                    teng._param_in_s if i else 0.0)
            assert step["device_s"] + host <= step["wall_s"]
    g = teng.goodput.snapshot()
    assert g["enabled"] and g["steps"] == 2
    assert g["data_wait_s"] == 0
    assert g["data_wait_s"] + g["device_s"] + g["host_s"] == pytest.approx(
        g["wall_s"], rel=1e-9)
    teng.set_goodput_enabled(False)
    teng.train_batch(_batches(1)[0])
    assert teng.goodput.snapshot()["steps"] == 2
    off = _port_engine(gpt2_params, dict(BASE))
    off.train_batch(_batches(1)[0])
    assert off.goodput.snapshot()["steps"] == 0 and \
        off.goodput.snapshot()["wall_s"] == 0.0
    teng.destroy()
    off.destroy()


# ------------------------------------------------------ flight recorder

def test_watchdog_on_a_fake_clock_dumps_the_ring_once(tmp_path):
    dumps = []
    for mod, ev in ((jax_wd, jax_wd._ev), (port_wd, port_ev)):
        now = [100.0]
        ring = ev.EventRing(16)
        ring.record(ev.STEP_END, step=7)
        w = mod.Watchdog(5.0, registry=MetricRegistry(), ring=ring,
                         clock=lambda: now[0],
                         dump_path=str(tmp_path / f"{mod.__name__}.json"))
        now[0] += 4.0
        assert not w.check()
        now[0] += 2.0
        assert w.check() and not w.check()   # one dump a stall
        w.notify_progress()
        now[0] += 6.0
        assert w.check() and w.stalls == 2
        d = json.loads((tmp_path / f"{mod.__name__}.json").read_text())
        dumps.append((sorted(d), d["idle_seconds"],
                      [e["kind"] for e in d["events"]["events"]]))
    assert dumps[0] == dumps[1]
    assert dumps[1][2][0] == port_ev.STEP_END


def test_fault_dump_writes_the_ring(tmp_path):
    path = str(tmp_path / "ring.json")
    port_ev.record_event(port_ev.STEP_END, source="train", step=41)
    port_ev.install_fault_dump(path)
    try:
        try:
            raise RuntimeError("boom")
        except RuntimeError as e:
            with mock.patch("sys.__excepthook__"):
                port_ev._excepthook(type(e), e, e.__traceback__)
        d = json.loads(open(path).read())
        assert d["dump_reason"] == "unhandled_exception"
        assert "boom" in d["exception"]
        assert any(e["kind"] == port_ev.STEP_END and
                   e["data"].get("step") == 41 for e in d["events"])
        assert (tmp_path / "ring.json.stacks").exists()
        port_ev.dump_ring(path, "on_demand", extra={"x": 1})
        d = json.loads(open(path).read())
        assert d["dump_reason"] == "on_demand" and d["x"] == 1
    finally:
        port_ev.uninstall_fault_dump()


def test_memory_monitor_owner_matching_and_buckets():
    mon = port_mem.MemoryMonitor()
    a = {"w": torch.zeros(10), "b": [torch.zeros(3, dtype=torch.bfloat16)]}
    shared = torch.zeros(5)
    g1 = lambda: (a, shared)   # noqa: E731
    g2 = lambda: {"s": shared, "m": torch.empty(4, device="meta")}  # noqa
    mon.register_component("params", g1)
    mon.register_component("opt", g2)
    snap = mon.snapshot(MetricRegistry())
    comp = snap["components"]
    assert comp["params"]["bytes"] == 40 + 6 + 20
    assert comp["params"]["host_bytes"] == 66
    assert comp["opt"]["bytes"] == 0   # shared counted once; meta nothing
    assert snap["devices"] == [] and comp["other"]["bytes"] == 0
    # a newer engine's registration of "params" survives the older's close
    g3 = lambda: a   # noqa: E731
    mon.register_component("params", g3)
    mon.unregister_component("params", g1)
    assert mon.components == ["opt", "params"]
    mon.unregister_component("params", g3)
    assert mon.components == ["opt"]
    t1 = mon.start_sampling(60.0, registry=MetricRegistry())
    t2 = mon.start_sampling(60.0, registry=MetricRegistry())
    mon.stop_sampling(t1)          # stale token: a no-op
    assert mon._sampler is not None
    mon.stop_sampling(t2)
    assert mon._sampler is None


def test_engine_arms_the_flight_recorder(gpt2_params, tmp_path):
    dump = str(tmp_path / "ev.json")
    ds = dict(BASE, zero_optimization=HOST,
              telemetry={"watchdog_deadline_s": 3600.0,
                         "events_dump_path": dump})
    prev = port_mem.set_memory_monitor(port_mem.MemoryMonitor())
    try:
        teng = _port_engine(gpt2_params, ds)
        assert teng.watchdog is not None
        mon = port_mem.get_memory_monitor()
        assert mon.components == ["optimizer_state", "params"]
        teng.train_batch(_batches(1)[0])
        assert teng.watchdog.idle_seconds() < 60
        comp = mon.snapshot(MetricRegistry())["components"]
        n = sum(p.numel() for p in teng.params.values())
        assert comp["params"]["bytes"] == 4 * n
        # the host master and moments are optimizer memory
        assert comp["optimizer_state"]["host_bytes"] == 12 * n
        teng.destroy()
        assert teng.watchdog is None and mon.components == []
    finally:
        port_mem.set_memory_monitor(prev)
        port_ev.uninstall_fault_dump()


# -------------------------------------------- activation checkpointing

@pytest.fixture
def clean_ac():
    port_ac.reset()
    jax_ac.reset()
    yield
    port_ac.reset()
    jax_ac.reset()


def test_configure_and_reset_semantics(clean_ac, gpt2_params):
    for ac in (jax_ac, port_ac):
        ac.configure(number_checkpoints=2)
        ac.reset(only_engine_installed=True)     # a user's stays
        assert ac.is_configured()
        ac.configure(ac._CONFIG, _by_engine=True)
        ac.reset(only_engine_installed=True)
        assert not ac.is_configured()
    # the engine installs its section, and a later engine without one
    # clears it
    _port_engine(gpt2_params, dict(BASE, activation_checkpointing={
        "number_checkpoints": 3}))
    assert port_ac.is_configured() and port_ac._CONFIG.number_checkpoints \
        == 3
    _port_engine(gpt2_params, dict(BASE))
    assert not port_ac.is_configured()
    assert deepspeed_tpu_torch.checkpointing is port_ac


@pytest.mark.parametrize("field", ["contiguous_memory_optimization",
                                   "synchronize_checkpoint_boundary"])
def test_refusals(clean_ac, field):
    for ac in (jax_ac, port_ac):
        with pytest.raises(NotImplementedError, match=field):
            ac.configure(**{field: True})
        assert not ac.is_configured()


@pytest.mark.parametrize("cfg", [None, {"profile": True},
                                 {"partition_activations": True}])
def test_checkpoint_gradients_match_jax_checkpoint(clean_ac, cfg):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 16)) / 4).astype(np.float32)

    def jf(x, w):
        h = jnp.tanh(x @ w)
        return jax.nn.gelu(h @ w.T, approximate=False) * x

    def tf(x, w):
        h = torch.tanh(x @ w)
        return torch.nn.functional.gelu(h @ w.T) * x
    if cfg:
        jax_ac.configure(**cfg)
        port_ac.configure(**cfg)
    jl = lambda x, w: jnp.sum(jax_ac.checkpoint(jf, x, w) ** 2)  # noqa
    jg = jax.grad(jl, argnums=(0, 1))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    (port_ac.checkpoint(tf, tx, tw) ** 2).sum().backward()
    for t, j in zip((tx.grad, tw.grad), jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    # recompute equals no recompute bit for bit
    px, pw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    (tf(px, pw) ** 2).sum().backward()
    assert torch.equal(px.grad, tx.grad) and torch.equal(pw.grad, tw.grad)


def test_partitioned_region_saves_the_seq_block(clean_ac):
    """``partition_activations`` on a seq axis of 2 (the group faked on
    one process: this rank is index 1, the all-gather returns the whole
    input): the region keeps only its block of dim 1, all-gathers it for
    the recompute, and its gradients equal a plain recompute's bit for
    bit."""
    from deepspeed_tpu_torch.comm import comm
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.standard_normal((2, 8, 4)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((4, 4)).astype(np.float32),
                     requires_grad=True)
    gathered = []

    def fake_gather(block, axis_name, axis):
        gathered.append((tuple(block.shape), axis_name, axis))
        assert torch.equal(block, x0[:, 4:])   # rank 1's block
        return x0.clone()

    def f(x):
        return torch.tanh(x @ w) * x
    port_ac.configure(partition_activations=True)
    x = x0.clone().requires_grad_(True)
    with mock.patch.object(port_ac, "_axis", lambda name: (1, 2)), \
            mock.patch.object(comm, "all_gather", fake_gather):
        y = port_ac.checkpoint(f, x)
        saved = y.grad_fn.saved_tensors
        (y ** 2).sum().backward()
    assert [tuple(t.shape) for t in saved] == [(2, 4, 4)]
    assert gathered == [((2, 4, 4), "seq", 1)]
    px, pw = x0.clone().requires_grad_(True), w.detach().clone(
    ).requires_grad_(True)
    (torch.tanh(px @ pw) * px).pow(2).sum().backward()
    assert torch.equal(x.grad, px.grad) and torch.equal(w.grad, pw.grad)


@pytest.mark.parametrize("n,segments", [(7, 3), (5, 5), (4, None), (6, 4)])
def test_checkpoint_sequential_bounds_equal_jax(clean_ac, n, segments):
    sizes = []
    for ac, lib in ((jax_ac, jnp), (port_ac, torch)):
        seen = []
        real = ac.checkpoint

        def rec(fn, x, _real=real, _seen=seen):
            _seen.append(len(fn.__defaults__[0]))
            return _real(fn, x)
        fns = [(lambda h, i=i: h * 1.5 + i) for i in range(n)]
        with mock.patch.object(ac, "checkpoint", rec):
            if segments is None:
                ac.configure(number_checkpoints=3)
            out = ac.checkpoint_sequential(fns, lib.ones(2) if lib is jnp
                                           else torch.ones(2),
                                           segments)
        sizes.append((seen, float(out[0])))
    assert sizes[0] == sizes[1]
    assert sum(sizes[1][0]) == n


def test_cpu_fallback_warns_once(clean_ac):
    port_ac._WARNED_CPU_FALLBACK = False
    port_ac.configure(cpu_checkpointing=True)
    with mock.patch.object(port_ac.logger, "warning") as warn:
        for _ in range(3):
            x = torch.ones(4, 4, requires_grad=True)
            port_ac.checkpoint(lambda t: (t * 2).sin(), x).sum().backward()
            assert torch.allclose(x.grad, 2 * (2 * x).cos())
    assert warn.call_count == 1
    assert "cpu_checkpointing" in warn.call_args[0][0]


def test_model_parallel_seed_by_tensor_and_data_rank(clean_ac):
    def draws(data, tensor):
        with mock.patch.object(port_ac, "_axis",
                               lambda name: ((tensor if name == "tensor"
                                              else data), 2)):
            g = port_ac.model_parallel_seed(1234)
        return torch.rand(8, generator=g)
    assert torch.equal(draws(0, 0), draws(1, 0))
    assert torch.equal(draws(0, 1), draws(1, 1))
    assert not torch.equal(draws(0, 0), draws(0, 1))
    # no process group: tensor rank 0
    assert torch.equal(torch.rand(8, generator=port_ac.model_parallel_seed(
        1234)), draws(0, 0))
