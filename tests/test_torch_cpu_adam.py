"""The port's host Adam and Adagrad (``ops/cpu_adam.py`` over
``ops/csrc/cpu_adam.cpp``) and its ``HostOffloadOptimizer`` against the
JAX package's on the CPU.

Both packages compile the same C++ arithmetic with the same g++ flags on
this host, so on the same numpy inputs the native steps agree bit for bit:
the master, both moments and the bf16 copy. The port's plain version
(``use_native=False``) is held to the native one within 1e-5 relative and
1e-6 absolute (numpy evaluates the same formulas in another order, without
fused multiply-adds). Leaves of 10001 and 4096 * 3 + 5 elements cover the
vector loop, the scalar tail and more than one 4096-element block.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_adam as jax_cpu_adam
from deepspeed_tpu.runtime.zero import offload as jax_offload
from deepspeed_tpu_torch.ops import cpu_adam as port_cpu_adam
from deepspeed_tpu_torch.ops.op_builder import HostOpBuilder
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

N = 10001
STEPS = 3


def _grads(seed, n=N, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(steps)]


def _u16(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam-l2"])
def test_native_adam_equals_jax_bit_for_bit(adamw):
    w0 = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    kw = dict(lr=1e-2, weight_decay=0.01, adamw_mode=adamw)
    port = port_cpu_adam.DeepSpeedCPUAdam(**kw)
    ref = jax_cpu_adam.DeepSpeedCPUAdam(**kw)
    assert port.native and ref.native
    tm = {"w": torch.from_numpy(w0.copy())}      # torch buffers
    jm = {"w": w0.copy()}                        # numpy buffers
    ts, js = port.init_state(tm), ref.init_state(jm)
    tout = {"w": torch.empty(N, dtype=torch.bfloat16)}
    jout = {"w": np.empty(N, np.uint16)}
    for g in _grads(1):
        port.step(tm, {"w": torch.from_numpy(g)}, ts, bf16_out=tout)
        ref.step(jm, {"w": g}, js, bf16_out=jout)
    np.testing.assert_array_equal(tm["w"].numpy(), jm["w"])
    np.testing.assert_array_equal(ts["w"]["m"].numpy(), js["w"]["m"])
    np.testing.assert_array_equal(ts["w"]["v"].numpy(), js["w"]["v"])
    np.testing.assert_array_equal(_u16(tout["w"]), jout["w"])
    # the bf16 copy is the round-to-nearest-even cast of the master
    np.testing.assert_array_equal(_u16(tout["w"]),
                                  _u16(tm["w"].to(torch.bfloat16)))
    assert port.step_count == ref.step_count == STEPS


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_native_adagrad_equals_jax_bit_for_bit(wd):
    w0 = np.random.default_rng(2).standard_normal(N).astype(np.float32)
    port = port_cpu_adam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=wd)
    ref = jax_cpu_adam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=wd)
    tm, jm = {"w": torch.from_numpy(w0.copy())}, {"w": w0.copy()}
    ts, js = port.init_state(tm), ref.init_state(jm)
    tout = {"w": torch.empty(N, dtype=torch.bfloat16)}
    jout = {"w": np.empty(N, np.uint16)}
    for g in _grads(3):
        port.step(tm, {"w": torch.from_numpy(g)}, ts, bf16_out=tout)
        ref.step(jm, {"w": g}, js, bf16_out=jout)
    np.testing.assert_array_equal(tm["w"].numpy(), jm["w"])
    np.testing.assert_array_equal(ts["w"]["h"].numpy(), js["w"]["h"])
    np.testing.assert_array_equal(_u16(tout["w"]), jout["w"])


@pytest.mark.parametrize("opt", ["adamw", "adam-l2", "adagrad"])
def test_plain_version_within_tolerance_of_native(opt):
    w0 = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    runs = []
    for native in (True, False):
        if opt == "adagrad":
            o = port_cpu_adam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01,
                                                  use_native=native)
        else:
            o = port_cpu_adam.DeepSpeedCPUAdam(
                lr=1e-2, weight_decay=0.01, adamw_mode=opt == "adamw",
                use_native=native)
        assert o.native == native
        m = {"w": torch.from_numpy(w0.copy())}
        st = o.init_state(m)
        out = {"w": torch.empty(N, dtype=torch.bfloat16)}
        for g in _grads(5):
            o.step(m, {"w": torch.from_numpy(g)}, st, bf16_out=out)
        runs.append((m["w"].numpy(), {k: v.numpy() for k, v in
                                      st["w"].items()}, out["w"].float()))
    (wn, sn, on), (wp, sp, op) = runs
    np.testing.assert_allclose(wp, wn, rtol=1e-5, atol=1e-6)
    for k in sn:
        np.testing.assert_allclose(sp[k], sn[k], rtol=1e-5, atol=1e-6)
    # the bf16 copies are each master's RNE cast: one bf16 step apart at most
    np.testing.assert_allclose(op.numpy(), on.numpy(), rtol=2 ** -7)


def test_bf16_helper_is_round_to_nearest_even():
    x = np.random.default_rng(6).standard_normal(4099).astype(np.float32)
    x[:3] = [np.nan, np.inf, -np.inf]
    x[3] = np.float32(1.0) + np.float32(2 ** -8)   # a tie: rounds to even
    got = port_cpu_adam._f32_to_bf16_np(x)
    want = _u16(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got[1:], want[1:])
    assert (got[0] & 0x7F80) == 0x7F80 and (got[0] & 0x7F) != 0   # NaN
    np.testing.assert_array_equal(got, jax_cpu_adam._f32_to_bf16_np(x))


def test_chunks_at_4096_give_one_calls_bits():
    """``HostOffloadOptimizer``'s pipeline steps a leaf in chunks whose
    starts are multiples of 4096 elements; the C++ step's blocks are 4096
    long, so the bits equal one call over the whole leaf."""
    n = 4096 * 3 + 5
    w0 = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    g = _grads(8, n, 1)[0]
    outs = []
    for chunk in (n, 4096, 8192):
        o = port_cpu_adam.DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01)
        w = torch.from_numpy(w0.copy())
        st = o.init_state({"w": w})["w"]
        out = torch.empty(n, dtype=torch.bfloat16)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            o.step({"w": w[lo:hi]}, {"w": torch.from_numpy(g)[lo:hi]},
                   {"w": {p: a[lo:hi] for p, a in st.items()}},
                   bf16_out={"w": out[lo:hi]}, step=1)
        outs.append((w.numpy(), st["v"].numpy(), _u16(out)))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            np.testing.assert_array_equal(a, b)


def test_host_offload_optimizer_equals_jax():
    """The port's ``step_streamed`` (CPU grads, the params written in
    place) against JAX's ``HostOffloadOptimizer.step``: the same master,
    moments and bf16 params, bit for bit; and ``state_dict`` round trips."""
    rng = np.random.default_rng(9)
    params = {"a.w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal(N).astype(np.float32)}
    jtree = {"a": {"w": params["a.w"]}, "b": params["b"]}
    opt = {"lr": 1e-2, "weight_decay": 0.01, "betas": (0.8, 0.95)}
    port = HostOffloadOptimizer({k: torch.from_numpy(v)
                                 for k, v in params.items()}, opt)
    ref = jax_offload.HostOffloadOptimizer(jtree, opt)
    whole = HostOffloadOptimizer({k: torch.from_numpy(v)
                                  for k, v in params.items()}, opt)
    dst = {k: torch.zeros(v.shape, dtype=torch.bfloat16)
           for k, v in params.items()}
    for step in range(STEPS):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        port.step_streamed({k: torch.from_numpy(v) for k, v in g.items()},
                           lr=1e-2 * (step + 1), params=dst)
        out = whole.step({k: torch.from_numpy(v.reshape(-1))
                          for k, v in g.items()}, lr=1e-2 * (step + 1))
        jp = ref.step({"a/w": g["a.w"].reshape(-1), "b": g["b"]},
                      lr=1e-2 * (step + 1), param_dtype=jnp.bfloat16)
        for k in params:   # the whole-tree step: the same bits
            assert torch.equal(out[k], dst[k]), k
            assert torch.equal(whole.master[k], port.master[k]), k
    for k, jk in (("a.w", "a/w"), ("b", "b")):
        np.testing.assert_array_equal(port.master[k].numpy(), ref.master[jk])
        for part in ("m", "v"):
            np.testing.assert_array_equal(port.state[k][part].numpy(),
                                          ref.state[jk][part])
    np.testing.assert_array_equal(
        dst["a.w"].float().numpy(), np.asarray(jp["a"]["w"], np.float32))
    np.testing.assert_array_equal(
        dst["b"].float().numpy(), np.asarray(jp["b"], np.float32))
    assert port.adam.step_count == ref.adam.step_count == STEPS
    back = HostOffloadOptimizer({k: torch.zeros(v.shape)
                                 for k, v in params.items()}, opt)
    back.load_state_dict(port.state_dict())
    for k in params:
        assert torch.equal(back.master[k], port.master[k])
        assert torch.equal(back.state[k]["v"], port.state[k]["v"])
    assert back.adam.step_count == STEPS


def test_buffers_are_checked_and_a_failed_build_raises(tmp_path):
    o = port_cpu_adam.DeepSpeedCPUAdam()
    w = torch.zeros(8)
    st = o.init_state({"w": w})
    with pytest.raises(ValueError, match="contiguous float32"):
        o.step({"w": w}, {"w": torch.zeros(8, dtype=torch.float64)}, st)
    with pytest.raises(ValueError, match="contiguous float32"):
        o.step({"w": torch.zeros(16)[::2]}, {"w": torch.zeros(8)}, st)
    # no fallback: a source that does not compile raises at load
    bad = HostOpBuilder("broken", lambda lib: None)
    bad.source = tmp_path / "broken.cpp"
    bad.source.write_text("this is not C++\n")
    so = bad.so_path()
    assert so.name.startswith("broken-host-")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken"):
        bad.load()
    assert not so.exists()
    lib = port_cpu_adam.CPU_ADAM.load()
    assert isinstance(lib, ctypes.CDLL) and lib.dstpu_simd_width() >= 1
