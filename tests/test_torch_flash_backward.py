"""The port's flash-attention backward (B2 dq, B3 dk/dv) on the CPU: the
plain versions against the JAX package's Pallas backward kernels (run in
interpret mode, as tests/test_ops.py runs them), the autograd Function
against ``jax.grad`` of the JAX ``flash_attention``, and ragged T against
autograd through the port's ``causal_attention_reference``. The CUDA
kernels themselves run only on a card (``test_torch_cuda_kernels.py``).

Tolerance 1e-4 in float32: both sides compute exact softmax gradients in
f32; only the order of the sums differs (the Pallas kernels sum over
128-key blocks, the plain versions over whole rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.ops import flash_attention as port_flash

TOL = 1e-4


def _inputs(B, T, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, T, KH, D), np.float32),
            rng.standard_normal((B, T, KH, D), np.float32),
            rng.standard_normal((B, T, H, D), np.float32))


def _to3(x):   # [B, T, h, D] -> [B*h, T, D], the Pallas kernels' layout
    B, T, h, D = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(B * h, T, D)


def _from3(x, B, h):
    BH, T, D = x.shape
    return np.swapaxes(np.asarray(x).reshape(B, h, T, D), 1, 2)


def _pallas_bwd(q, k, v, do, causal, scale):
    """The Pallas forward and backward kernels in interpret mode on
    [B, T, h, D] numpy inputs: ``(o, lse [B, H, T], dq, dk, dv)`` as torch
    tensors in the port's layout."""
    B, T, H, _ = q.shape
    KH = k.shape[2]
    o3, lse3 = jax_flash._flash_fwd(_to3(q), _to3(k), _to3(v), scale=scale,
                                    block_q=128, block_k=128, causal=causal,
                                    interpret=True)
    dq3, dk3, dv3 = jax_flash._flash_bwd(
        _to3(q), _to3(k), _to3(v), o3, lse3, _to3(do), scale=scale,
        block_q=128, block_k=128, causal=causal, interpret=True)
    return (torch.from_numpy(_from3(o3, B, H).copy()),
            torch.from_numpy(np.asarray(lse3).reshape(B, H, T).copy()),
            _from3(dq3, B, H), _from3(dk3, B, KH), _from3(dv3, B, KH))


# the first five keep their ids from before the head dim was a parameter
@pytest.mark.parametrize("causal,H,KH,D", [
    pytest.param(True, 4, 4, 32, id="True-4-4"),     # MHA
    pytest.param(False, 4, 4, 32, id="False-4-4"),   # full attention
    pytest.param(True, 4, 2, 32, id="True-4-2"),     # GQA
    pytest.param(True, 4, 1, 32, id="True-4-1"),     # MQA
    pytest.param(False, 4, 2, 32, id="False-4-2"),
    (True, 4, 4, 128),    # the head dim of the GPT-2 1.3B preset
    (True, 4, 1, 128),    # MQA at D=128
    (True, 4, 2, 64),     # GPT-2 XL's head dim, GQA
    (False, 2, 2, 64),
])
def test_bwd_plain_matches_pallas(causal, H, KH, D):
    B, T = 2, 256
    q, k, v, do = _inputs(B, T, H, KH, D, seed=H + KH + causal + D)
    scale = 1.0 / np.sqrt(D)
    o, lse, dq3, dk3, dv3 = _pallas_bwd(q, k, v, do, causal, scale)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    dq, dk, dv = port_flash.flash_attention_bwd(*t, o, lse,
                                                torch.from_numpy(do), causal,
                                                scale)
    np.testing.assert_allclose(dq.numpy(), dq3, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dk.numpy(), dk3, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv.numpy(), dv3, rtol=TOL, atol=TOL)
    # the reference the chip holds the kernels to is the same function
    ref = port_flash.flash_attention_bwd_reference(*t, o, lse,
                                                   torch.from_numpy(do),
                                                   causal, scale)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("H,D", [(4, 64), (2, 128)])
def test_bwd_plain_reads_fused_qkv_views(H, D):
    """q/k/v as strided views of one fused [B, T, 3 H D] projection, as
    ``models/gpt2.py`` hands them over (strides (T 3C, 3C, D, 1)), and dO
    and o as the forward makes them: B2 + B3 against the Pallas backward in
    interpret mode on the same values."""
    B, T = 2, 256
    rng = np.random.default_rng(D + 1)
    qkv = rng.standard_normal((B, T, 3 * H * D), np.float32)
    do = rng.standard_normal((B, T, H, D), np.float32)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.from_numpy(qkv).split(H * D, dim=-1))
    assert q.stride() == (T * 3 * H * D, 3 * H * D, D, 1)
    scale = 1.0 / np.sqrt(D)
    o, lse, dq3, dk3, dv3 = _pallas_bwd(
        *(x.contiguous().numpy() for x in (q, k, v)), do, True, scale)
    dq, dk, dv = port_flash.flash_attention_bwd(q, k, v, o, lse,
                                                torch.from_numpy(do), True,
                                                scale)
    for a, b in ((dq, dq3), (dk, dk3), (dv, dv3)):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("KH", [4, 2])
def test_autograd_function_matches_jax_grad(KH):
    """FlashAttentionFunction (forward plain version, backward B2 + B3
    plain versions on the CPU) against jax.grad through the JAX
    flash_attention's custom_vjp (Pallas in interpret mode)."""
    B, T, H, D = 2, 128, 4, 32
    q, k, v, do = _inputs(B, T, H, KH, D, seed=10 + KH)

    def jloss(q_, k_, v_):
        o = jax_flash.flash_attention(q_, k_, v_, causal=True, block_q=128,
                                      block_k=128)
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = port_flash.FlashAttentionFunction.apply(*leaves, True,
                                                  1.0 / np.sqrt(D))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("T,KH", [(100, 4), (130, 2), (1, 4)])
def test_ragged_T_matches_autograd_of_the_oracle(T, KH):
    """The TPU kernels need T % 128 == 0; the port takes any T. Gradients
    through ``causal_attention`` (the autograd Function) against autograd
    through ``causal_attention_reference``."""
    q, k, v, do = _inputs(2, T, 4, KH, 32, seed=T)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ga = torch.autograd.grad(port_attention.causal_attention(*a), a,
                             torch.from_numpy(do))
    gb = torch.autograd.grad(port_attention.causal_attention_reference(*b),
                             b, torch.from_numpy(do))
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=TOL, atol=TOL)


def test_oracle_matches_jax_oracle():
    """The port's causal_attention_reference is the JAX package's."""
    from deepspeed_tpu.ops.attention import causal_attention_reference
    q, k, v, _ = _inputs(2, 64, 4, 2, 16, seed=3)
    ref = causal_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    out = port_attention.causal_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_bwd_plain_keeps_storage_dtype_rounding():
    """bf16: dq scales q and dk/dv scale k in bf16, and P and dS are
    rounded to bf16 before their products, as the TPU kernels do — the
    result differs from an f32 backward by more than the f32 one differs
    from itself, and each kernel's half equals the combined function."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(1, 64, 2, 2, 32, seed=5))
    o, lse = port_flash.flash_attention_fwd(q, k, v)
    dq, delta = port_flash.flash_attention_bwd_dq(q, k, v, o, lse, do)
    dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert delta.dtype == torch.float32 and delta.shape == (1, 2, 64)
    for a, b in zip((dq, dk, dv),
                    port_flash.flash_attention_bwd(q, k, v, o, lse, do)):
        assert torch.equal(a, b)
    f32 = port_flash.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float())
    assert any(not torch.equal(a.float(), b) for a, b in zip((dq, dk, dv),
                                                             f32))


def test_bwd_wrappers_check_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="not divisible"):
        port_flash.flash_attention_bwd(q, q[:, :, :3], q[:, :, :3], q,
                                       torch.zeros(1, 4, 8), q)
    assert port_flash.flash_attention_bwd_dq.launches == 0
    assert port_flash.flash_attention_bwd_dkv.launches == 0
