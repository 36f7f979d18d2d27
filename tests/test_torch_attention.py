"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as tests/test_ops.py runs
them), plus the wrappers' contracts. The CUDA kernels themselves run only
on a card: their tests are in ``test_torch_cuda_kernels.py``, which imports
no JAX so that it runs on the GPU machine.

Tolerance 2e-5 in float32: both sides compute an exact softmax in f32
(online on the Pallas side, whole-row in the plain version); only the order
of the sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import decode_attention as port_decode
from deepspeed_tpu_torch.ops import flash_attention as port_flash

TOL = 2e-5


def _qkv(B, T, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, T, KH, D), np.float32),
            rng.standard_normal((B, T, KH, D), np.float32))


def _pallas_fwd(q, k, v, causal, scale):
    """The Pallas forward kernel in interpret mode on [B, T, h, D] numpy
    inputs: ``(o [B, T, H, D], lse [B, H, T])``."""
    B, T, H, D = q.shape

    def to3(x):   # [B, T, h, D] -> [B*h, T, D], the kernel's layout
        return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(-1, T, D)

    o3, lse3 = jax_flash._flash_fwd(to3(q), to3(k), to3(v), scale=scale,
                                    block_q=128, block_k=128, causal=causal,
                                    interpret=True)
    return (np.swapaxes(np.asarray(o3).reshape(B, H, T, D), 1, 2),
            np.asarray(lse3).reshape(B, H, T))


# the first four keep their ids from before the head dim was a parameter
@pytest.mark.parametrize("causal,T,H,KH,D", [
    pytest.param(True, 256, 4, 4, 32, id="True-256-4-4"),    # several blocks
    pytest.param(False, 128, 4, 4, 32, id="False-128-4-4"),  # full attention
    pytest.param(True, 256, 4, 2, 32, id="True-256-4-2"),    # GQA
    pytest.param(True, 128, 4, 1, 32, id="True-128-4-1"),    # MQA
    (True, 256, 4, 4, 128),    # the head dim of the GPT-2 1.3B preset
    (True, 256, 4, 2, 128),    # GQA at D=128
    (False, 128, 2, 2, 64),    # GPT-2 XL's head dim, full attention
])
def test_flash_plain_matches_pallas(causal, T, H, KH, D):
    B = 2
    q, k, v = _qkv(B, T, H, KH, D)
    scale = 1.0 / np.sqrt(D)
    o_jax, lse_jax = _pallas_fwd(q, k, v, causal, scale)
    o, lse = port_flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale)
    np.testing.assert_allclose(o.numpy(), o_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=TOL, atol=TOL)
    # the public entry point agrees with its lower level
    o_pub = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      block_q=128, block_k=128)
    np.testing.assert_allclose(
        port_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal).numpy(),
        np.asarray(o_pub), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H,D", [(4, 128), (4, 64)])
def test_flash_plain_reads_fused_qkv_views(H, D):
    """q/k/v as strided views of one fused [B, T, 3 H D] projection, as
    ``models/gpt2.py`` hands them over (strides (T 3C, 3C, D, 1)), against
    the Pallas kernel in interpret mode on the same values."""
    B, T = 2, 256
    rng = np.random.default_rng(D)
    qkv = rng.standard_normal((B, T, 3 * H * D), np.float32)
    q, k, v = (t.reshape(B, T, H, D)
               for t in torch.from_numpy(qkv).split(H * D, dim=-1))
    assert q.stride() == (T * 3 * H * D, 3 * H * D, D, 1)
    scale = 1.0 / np.sqrt(D)
    o_jax, lse_jax = _pallas_fwd(*(x.contiguous().numpy() for x in (q, k, v)),
                                 True, scale)
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    np.testing.assert_allclose(o.numpy(), o_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [1, 100, 130])
def test_flash_plain_takes_ragged_T(T):
    """The TPU kernel needs T % 128 == 0 (a tiling limit); the port takes
    any T. Against the JAX package's einsum attention oracle."""
    from deepspeed_tpu.ops.attention import causal_attention_reference
    q, k, v = _qkv(2, T, 4, 4, 32, seed=T)
    ref = causal_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    out = port_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_flash_plain_keeps_storage_dtype_rounding():
    """bf16: the scale is folded into q in bf16 and P is rounded to bf16
    before P.V, as in the Pallas kernel; the output keeps the dtype."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(1, 64, 2, 2, 64))
    o, lse = port_flash.flash_attention_fwd(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o32, _ = port_flash.flash_attention_fwd(q.float(), k.float(), v.float())
    err = (o.float() - o32).abs().max().item()
    assert 0 < err < 3e-2


@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2), (8, 1)])
def test_decode_plain_matches_pallas(H, KH):
    B, S, D = 3, 256, 32
    rng = np.random.default_rng(H * 10 + KH)
    q = rng.standard_normal((B, H, D), np.float32)
    kc = rng.standard_normal((B, S, KH, D), np.float32)
    vc = rng.standard_normal((B, S, KH, D), np.float32)
    lengths = np.array([1, 137, S], np.int32)   # >= 1: see the length-0 pin
    scale = 0.3
    ref = jax_decode.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(lengths),
                                      block_k=128, scale=scale,
                                      interpret=True)
    out = port_decode.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_decode_plain_length_zero_gives_zeros():
    """The TPU kernel's contract (acc / max(l, 1e-30) with l = 0), which
    the CUDA kernel keeps; the JAX reference oracle would give mean(v)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32), np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 64, 2, 32), np.float32))
    out = port_decode.decode_attention(q, kc, kc,
                                       torch.tensor([0, 3], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all() and out[1].abs().sum() > 0


def test_decode_plain_reads_layer_view_of_cache():
    """The model passes ``cache.k[layer]``, a view into [L, B, S, KH, D]."""
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 64, 2, 32),
                                                 np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 4, 32), np.float32))
    lens = torch.tensor([10, 64], dtype=torch.int32)
    a = port_decode.decode_attention(q, cache[1], cache[2], lens)
    b = port_decode.decode_attention(q, cache[1].clone(), cache[2].clone(),
                                     lens)
    assert torch.equal(a, b)


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    """On CPU tensors the wrappers take the plain versions: no kernel is
    launched, so the launch counts do not move."""
    n_f, n_d = (port_flash.flash_attention_fwd.launches,
                port_decode.decode_attention.launches)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 2, 64))
    port_flash.flash_attention(q, k, v)
    port_decode.decode_attention(q[:, 0], k, v,
                                 torch.tensor([5], dtype=torch.int32))
    assert port_flash.flash_attention_fwd.launches == n_f
    assert port_decode.decode_attention.launches == n_d


def test_wrappers_reject_bad_shapes():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 64))
    with pytest.raises(ValueError, match="incompatible"):
        port_flash.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError, match="not divisible"):
        port_flash.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="lengths"):
        port_decode.decode_attention(q[:, 0], k, v,
                                     torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="not divisible"):
        port_decode.decode_attention(q[:, 0, :3], k, v,
                                     torch.tensor([1], dtype=torch.int32))


def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take():
    """Reached only for CUDA tensors; the checks themselves are host code
    and are exercised here on CPU tensors posing as the kernel's input."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 2, 64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_flash._check_kernel_args(q, k, v)
    meta = torch.empty((1, 8, 2, 48), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_flash._check_kernel_args(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_decode._check_kernel_args(
            q[:, 0], k, v, torch.tensor([1], dtype=torch.int32))
