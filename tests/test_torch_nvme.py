"""The NVMe tier of the port's training engine against the JAX package's on
the CPU: the aio pool, the optimizer-state swapper, ``offload_optimizer:
{device: nvme}`` and ``offload_param: {device: nvme}``.

* Files written by the port's ``AsyncIOHandle`` read back bit for bit
  through JAX's, and the reverse (raw bytes, f32 and bf16).
* The swapper's pipelined order (the next leaf's read queued before the
  caller updates the current one, the write-back waited for before the
  next leaf) and its ``IOError``.
* ``HostOffloadOptimizer(device="nvme").step`` against JAX's, bit for
  bit (master, moments, bf16 params).
* ``offload_optimizer: nvme`` on the tiny GPT-2 of
  ``tests/test_torch_offload.py``, 4 steps: against JAX's nvme engine in
  fp32 to that file's tolerances (losses and gradient norms 1e-5
  relative, the master ``lr / 10`` absolute), and against the port's own
  host tier bit for bit in fp32 and bf16 (losses, master, moments,
  params).
* ``offload_param: nvme`` at stage 3: the swap files exist and
  ``engine.params`` holds shapes only (``meta``) between steps; equal to
  the ``cpu`` tier bit for bit; a checkpoint round trip; JAX's
  ``nvme_path`` ``ValueError`` texts.
* Across tiers: a tag saved under nvme resumes under cpu, and the
  reverse, bit for bit; ``host_optimizer.npz`` holds JAX's keys.

The two-rank NVMe run is in ``tests/test_torch_dist_parity.py``'s spawn
group.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAIO
from deepspeed_tpu.utils.tree import flatten_with_names
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor import OptimizerStateSwapper
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)
from test_torch_offload import (BASE, LR, TINY, _batches,  # noqa: F401
                                _gpt2_engine, _host_master, _jax_engine,
                                _train, gpt2_params)


def _nvme(path, stage=1, param=False, opt="nvme"):
    z = {"stage": stage}
    if opt:
        z["offload_optimizer"] = ({"device": "nvme", "nvme_path": str(path)}
                                  if opt == "nvme" else {"device": "cpu"})
    if param:
        z["offload_param"] = ({"device": "nvme", "nvme_path": str(path)}
                              if param == "nvme" else {"device": "cpu"})
    return z


# ----------------------------------------------------------------- aio

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_aio_files_cross_read_bit_for_bit(tmp_path, writer):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal(100_003).astype(np.float32)
    bf16 = torch.tensor(rng.standard_normal(4097), dtype=torch.bfloat16)
    port, jx = AsyncIOHandle(2), JaxAIO(2)
    w, r = (port, jx) if writer == "port" else (jx, port)
    w.pwrite(str(tmp_path / "a"), f32 if writer == "jax" else
             torch.from_numpy(f32))
    w.pwrite(str(tmp_path / "b"), bf16.view(torch.int16).numpy()
             if writer == "jax" else bf16)
    assert w.wait() == 0
    got_a = np.empty_like(f32)
    got_b = (np.empty(4097, np.int16) if writer == "port"
             else torch.empty(4097, dtype=torch.bfloat16))
    r.pread(str(tmp_path / "a"), got_a if writer == "port"
            else torch.from_numpy(got_a))
    r.pread(str(tmp_path / "b"), got_b)
    assert r.wait() == 0
    np.testing.assert_array_equal(got_a, f32)
    got_b = torch.as_tensor(got_b).view(torch.bfloat16)
    assert torch.equal(got_b, bf16)
    # a missing file is one failed request, counted by wait()
    port.pread(str(tmp_path / "missing"), torch.empty(4))
    assert port.wait() == 1
    port.close()
    jx.close()


def test_aio_refuses_a_device_or_strided_buffer(tmp_path):
    h = AsyncIOHandle(1)
    with pytest.raises(ValueError, match="contiguous"):
        h.pwrite(str(tmp_path / "x"), torch.zeros(4, 4).t())
    with pytest.raises(ValueError, match="writeable"):
        a = np.zeros(4, np.float32)
        a.flags.writeable = False
        h.pread(str(tmp_path / "x"), a)
    h.close()


def test_swapper_pipelines_reads_and_raises_ioerror(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path / "s"), 2)
    keys = ["h_0/w", "h_1.w", "wte"]
    for i, k in enumerate(keys):
        sw.write_state(k, {"m": np.full(4, i, np.float32),
                           "v": np.full(4, 10 + i, np.float32)}, sync=True)
    # JAX's file names
    assert sorted(os.listdir(tmp_path / "s")) == sorted(
        f"{k.replace('/', '_').replace('.', '_')}.{p}.swp"
        for k in keys for p in ("m", "v"))
    log = []
    read, write = sw.read_state, sw.write_state
    sw.read_state = lambda k, b, sync=False: (log.append(("read", k)),
                                              read(k, b, sync))[1]
    sw.write_state = lambda k, s, sync=False: (log.append(("write", k)),
                                               write(k, s, sync))[1]
    for k, st in sw.iter_pipelined(keys, lambda k: {
            "m": np.empty(4, np.float32), "v": np.empty(4, np.float32)}):
        log.append(("update", k))
        assert st["m"][0] == keys.index(k)
        st["m"] += 100
    assert log == [("read", "h_0/w"), ("read", "h_1.w"), ("update", "h_0/w"),
                   ("write", "h_0/w"), ("read", "wte"), ("update", "h_1.w"),
                   ("write", "h_1.w"), ("update", "wte"), ("write", "wte")]
    buf = {"m": np.empty(4, np.float32)}
    read("wte", buf, sync=True)
    assert buf["m"][0] == 102
    with pytest.raises(IOError, match="NVMe swap failed: swap-in of gone"):
        read("gone", buf, sync=True)
    sw.close()


# -------------------------------------------------- the nvme optimizer

def test_host_step_over_swap_files_equals_jax_bit_for_bit(tmp_path):
    """``HostOffloadOptimizer(device="nvme").step`` (host grads in, bf16
    params out) against JAX's on the same leaves: master, moments (read
    from each package's swap files) and params bit for bit."""
    from deepspeed_tpu.runtime.zero import offload as jax_offload
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    rng = np.random.default_rng(3)
    params = {"a.w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal(5000).astype(np.float32)}
    opt = {"lr": 1e-2, "weight_decay": 0.01}
    port = HostOffloadOptimizer({k: torch.from_numpy(v)
                                 for k, v in params.items()}, opt,
                                device="nvme", nvme_path=str(tmp_path / "p"))
    ref = jax_offload.HostOffloadOptimizer(
        {"a": {"w": params["a.w"]}, "b": params["b"]}, opt, device="nvme",
        nvme_path=str(tmp_path / "j"))
    for _ in range(3):
        g = {k: rng.standard_normal(v.size).astype(np.float32)
             for k, v in params.items()}
        out = port.step(g, lr=1e-2)
        jp = ref.step({"a/w": g["a.w"], "b": g["b"]}, lr=1e-2)
    np.testing.assert_array_equal(out["a.w"].float().numpy(),
                                  np.asarray(jp["a"]["w"], np.float32))
    jstate = ref.state_dict()["state"]
    for k, jk in (("a.w", "a/w"), ("b", "b")):
        np.testing.assert_array_equal(port.master[k].numpy(), ref.master[jk])
        for p in ("m", "v"):
            np.testing.assert_array_equal(port.moments(k)[p].numpy(),
                                          jstate[jk][p])
    port.close()


def test_nvme_optimizer_fp32_matches_jax_nvme(gpt2_params, tmp_path):
    ds = dict(BASE, zero_optimization=_nvme(tmp_path / "jax"))
    jeng = _jax_engine(jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **TINY, dtype=jnp.float32)), gpt2_params, ds)
    assert jeng.host_opt.swapper is not None
    teng = _gpt2_engine(gpt2_params, dict(
        BASE, zero_optimization=_nvme(tmp_path / "port")))
    assert teng.host_opt.swapper is not None and teng.host_opt.state is None
    jm, tm = _train(jeng, teng, _batches(4))
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
    jmaster = _host_master(jeng)
    for k, v in teng.fp32_master_params().items():
        np.testing.assert_allclose(v.numpy().reshape(-1), jmaster[k],
                                   atol=LR / 10, err_msg=k)
    # the same swap files: JAX's names, f32 moments of each leaf
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert teng.host_opt.adam.step_count == jeng.host_opt.adam.step_count
    teng.destroy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nvme_optimizer_equals_host_tier_bit_for_bit(gpt2_params, tmp_path,
                                                     dtype):
    dt = getattr(torch, dtype)
    extra = {"bf16": {"enabled": True}} if dt == torch.bfloat16 else {}
    host = _gpt2_engine(gpt2_params, dict(BASE, zero_optimization=_nvme(
        None, opt="cpu"), **extra), dt)
    nvme = _gpt2_engine(gpt2_params, dict(BASE, zero_optimization=_nvme(
        tmp_path), **extra), dt)
    for b in _batches(4):
        a, c = host.train_batch(b), nvme.train_batch(b)
        assert torch.equal(a["loss"], c["loss"])
        assert torch.equal(a["grad_norm"], c["grad_norm"])
    hm, nm = host.fp32_master_params(), nvme.fp32_master_params()
    for k in hm:
        assert torch.equal(hm[k], nm[k]), k
        assert torch.equal(host.params[k], nvme.params[k]), k
        for p in ("m", "v"):
            assert torch.equal(host.host_opt.state[k][p],
                               nvme.host_opt.moments(k)[p]), (k, p)
    assert nvme.offload_step_times["swap_read_bytes"] == 8 * sum(
        v.numel() for v in hm.values())
    nvme.destroy()


@pytest.mark.parametrize("cfg,match", [
    ({"stage": 1, "offload_optimizer": {"device": "nvme"}},
     "offload_optimizer.device=nvme requires nvme_path"),
    ({"stage": 3, "offload_param": {"device": "nvme"}},
     "offload_param.device=nvme requires nvme_path")],
    ids=["optimizer", "param"])
def test_nvme_path_required_with_jax_text(gpt2_params, cfg, match):
    ds = dict(BASE, zero_optimization=cfg)
    with pytest.raises(ValueError, match=match):
        _jax_engine(jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
            **TINY, dtype=jnp.float32)), gpt2_params, ds)
    with pytest.raises(ValueError, match=match):
        _gpt2_engine(gpt2_params, ds)


# ----------------------------------------------------- the nvme params

@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "staged"])
def test_nvme_params_swap_between_steps(gpt2_params, tmp_path, fetch):
    """Stage 3 with ``offload_param: nvme`` (and the host optimizer): the
    params live in swap files between steps, ``engine.params`` holds
    ``meta`` tensors of their shapes, and the run equals the ``cpu``
    tier's bit for bit."""
    ds = dict(BASE, bf16={"enabled": True})
    kw = {"offload_params": True} if fetch else {}
    cpu = _gpt2_engine(gpt2_params, dict(ds, zero_optimization=_nvme(
        None, 3, param="cpu", opt="cpu")), torch.bfloat16, **kw)
    nv = _gpt2_engine(gpt2_params, dict(ds, zero_optimization=_nvme(
        tmp_path, 3, param="nvme", opt="cpu")), torch.bfloat16, **kw)
    names = list(cpu.params)
    shapes = {k: tuple(v.shape) for k, v in cpu.params.items()}
    for b in _batches(3):
        assert torch.equal(cpu.train_batch(b)["loss"],
                           nv.train_batch(b)["loss"])
        assert all(v.device.type == "meta" for v in nv.params.values())
        assert {k: tuple(v.shape) for k, v in nv.params.items()} == shapes
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"param_{k.replace('.', '_')}.swp" for k in names)
    assert nv.offload_step_times["param_bytes"] == 2 * sum(
        int(np.prod(s)) for s in shapes.values())
    a, b = cpu.module_state_dict(), nv.module_state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # module_state_dict brought them back: resident until the next step
    assert all(v.device.type == "cpu" and v.is_contiguous()
               for v in nv.params.values())
    nv.destroy()


def test_nvme_param_swapper_refuses_swap_in_with_nothing_on_disk(tmp_path):
    from deepspeed_tpu_torch.runtime.zero.param_offload import ParamSwapper
    sw = ParamSwapper(str(tmp_path))
    with pytest.raises(RuntimeError, match="swap_in with no params on disk"):
        sw.swap_in()
    sw.close()


def test_nvme_params_checkpoint_round_trip(gpt2_params, tmp_path):
    """Both tiers on NVMe: a tag saved after 2 steps resumes a fresh
    engine (other weights) whose step 3 equals the uninterrupted run's,
    loss, params, master and moments, bit for bit."""
    ds = dict(BASE, bf16={"enabled": True})
    batches = _batches(3)

    def eng(tag, params=gpt2_params):
        return _gpt2_engine(params, dict(ds, zero_optimization=_nvme(
            tmp_path / tag, 3, param="nvme")), torch.bfloat16,
            offload_params=True)
    a = eng("a")
    la = [a.train_batch(b)["loss"] for b in batches]
    b = eng("b")
    for x in batches[:2]:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path / "ck"))
    b.destroy()
    c = eng("c", jax.tree.map(lambda x: x + 1.0, gpt2_params))
    c.load_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(c.train_batch(batches[2])["loss"], la[2])
    _assert_same_state(a, c)


def _assert_same_state(a, c):
    ma, mc = a.fp32_master_params(), c.fp32_master_params()
    pa, pc = a.module_state_dict(), c.module_state_dict()
    for k in ma:
        assert torch.equal(ma[k], mc[k]), k
        assert torch.equal(pa[k], pc[k]), k
        ea, ec = a.host_opt.moments(k), c.host_opt.moments(k)
        for p in ("m", "v"):
            assert torch.equal(ea[p], ec[p]), (k, p)
    assert a.host_opt.adam.step_count == c.host_opt.adam.step_count


# ------------------------------------------------------- across tiers

@pytest.mark.parametrize("save,load", [("nvme", "cpu"), ("cpu", "nvme")])
def test_tag_moves_between_tiers_bit_for_bit(gpt2_params, tmp_path, save,
                                             load):
    ds = dict(BASE, bf16={"enabled": True})
    batches = _batches(3)

    def eng(tier, tag):
        return _gpt2_engine(gpt2_params, dict(ds, zero_optimization=_nvme(
            tmp_path / tag, opt=tier)), torch.bfloat16)
    a = eng(load, "a")
    for b in batches:
        a.train_batch(b)
    b = eng(save, "b")
    for x in batches[:2]:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path / "ck"))
    blob = np.load(tmp_path / "ck" / "global_step2" / "host_optimizer.npz")
    paths = list(flatten_with_names(gpt2_params))
    assert set(blob.files) == {"step"} | {f"master::{p}" for p in paths} | {
        f"state::{p}::{m}" for p in paths for m in ("m", "v")}
    c = eng(load, "c")
    c.load_checkpoint(str(tmp_path / "ck"))
    c.train_batch(batches[2])
    _assert_same_state(a, c)
