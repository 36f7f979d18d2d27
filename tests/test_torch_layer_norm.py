"""The port's fused LayerNorm on the CPU against the JAX package.

The plain versions of kernels B9 (forward) and B10 (backward) are held to
the Pallas kernels in interpret mode (as tests/test_ops.py runs them on the
CPU) and to the JAX ``fused_layer_norm`` custom VJP on the same numpy
inputs: 1e-5 in float32 (f32 statistics on both sides, sums in another
order) and one bf16 step (2^-8 relative, atol 2e-2 for |o| up to ~4) in
bfloat16 (both round the same f32 values to bf16, which may land one step
apart). ``x`` is ``[3, 37, 48]``, so R = 111 is no multiple of the TPU's
128-row blocks. ``torch.autograd.gradcheck`` on float64 leaves (f32
statistics, limits that fit f32) holds the B10 formula to autograd. The CUDA kernels run only on a card
(``test_torch_cuda_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import layer_norm as jax_ln
from deepspeed_tpu_torch.ops import layer_norm as port_ln

SHAPE = (3, 37, 48)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -8, 2e-2)}


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(n).astype(np.float32) + 1.0,
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_matches_pallas_and_fused_layer_norm(dtype, eps):
    x, w, b, _ = _inputs(0)
    N = SHAPE[-1]
    jx = jnp.asarray(x, dtype)
    jo, jmean, jrstd = jax_ln._ln_fwd(jx.reshape(-1, N), jnp.asarray(w),
                                      jnp.asarray(b), eps=eps, block_rows=37,
                                      interpret=True)
    jfused = jax_ln.fused_layer_norm(jx, jnp.asarray(w), jnp.asarray(b), eps)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    o, mean, rstd = port_ln.layer_norm_fwd(tx.reshape(-1, N),
                                           torch.from_numpy(w),
                                           torch.from_numpy(b), eps)
    assert o.dtype == tx.dtype and mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (x.size // N, 1)
    _close(o.float(), jo.astype(jnp.float32), dtype)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5)
    fused = port_ln.fused_layer_norm(tx, torch.from_numpy(w),
                                     torch.from_numpy(b), eps)
    assert fused.shape == SHAPE and fused.dtype == tx.dtype
    _close(fused.float(), jfused.astype(jnp.float32), dtype)
    assert torch.equal(fused.reshape(-1, N), o)


@pytest.mark.parametrize("shape", [SHAPE, (4, 130), (1, 1, 5)])
def test_autograd_matches_jax_vjp(shape):
    """torch.autograd.grad through fused_layer_norm (plain B9, plain B10)
    against jax.vjp of the JAX fused_layer_norm (Pallas backward in
    interpret mode) with the same cotangent, in float32."""
    x, w, b, g = _inputs(1, shape)
    out, vjp = jax.vjp(lambda x_, w_, b_: jax_ln.fused_layer_norm(
        x_, w_, b_, 1e-5), *map(jnp.asarray, (x, w, b)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    o = port_ln.fused_layer_norm(*leaves)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for a, j in zip(grads, jgrads):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(j).max()))


def test_bf16_gradients_keep_their_dtypes():
    """dx in x's dtype; dw and db summed in f32 and cast to the weight's
    dtype (a bf16 weight gives bf16 gradients), as the JAX VJP does. Held
    within two bf16 steps (2^-7 relative, 2e-2 of the largest gradient):
    both sides round the same f32 results, summed in another order."""
    x, w, b, g = _inputs(2)
    jx, jw, jb, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, g))
    _, vjp = jax.vjp(lambda *a: jax_ln.fused_layer_norm(*a), jx, jw, jb)
    jgrads = vjp(jg)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w, b)]
    grads = torch.autograd.grad(port_ln.fused_layer_norm(*leaves), leaves,
                                torch.from_numpy(g).to(torch.bfloat16))
    for a, j in zip(grads, jgrads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(j.astype(jnp.float32)),
            rtol=2 ** -7, atol=2e-2 * float(np.abs(j.astype(jnp.float32)
                                                   ).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_on_a_wide_unaligned_row(dtype):
    """B10's plain version against the Pallas backward in interpret mode on
    rows wider than 8192 elements whose rows are no whole number of 16-byte
    chunks (N = 10001, R = 3): rows the CUDA wrapper gives its wide kernel.
    dx within the tolerances of the forward; dw and db, sums over the rows
    in f32 on both sides, within 1e-5 relative of their largest element."""
    x, w, _, g = _inputs(7, (3, 10001))
    N = x.shape[-1]
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    _, jmean, jrstd = jax_ln._ln_fwd(jx, jnp.asarray(w), jnp.zeros(N),
                                     eps=1e-5, block_rows=3, interpret=True)
    jdx, jdw, jdb = jax_ln._ln_bwd(jx, jnp.asarray(w), jmean, jrstd, jg,
                                   block_rows=3, interpret=True)
    tx, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    mean = torch.from_numpy(np.array(jmean))
    rstd = torch.from_numpy(np.array(jrstd))
    dx, dw, db = port_ln.layer_norm_bwd(tx, torch.from_numpy(w), mean, rstd,
                                        tg)
    assert dx.dtype == tx.dtype and dw.dtype == db.dtype == torch.float32
    _close(dx.float(), jdx.astype(jnp.float32), dtype)
    for a, j in ((dw, jdw), (db, jdb)):
        j = np.asarray(j)
        np.testing.assert_allclose(a.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(j).max()))


def test_residual_variant_matches_jax():
    x, w, b, r = _inputs(3)
    jo, js = jax_ln.fused_residual_layer_norm(*map(jnp.asarray, (x, r, w, b)))
    o, s = port_ln.fused_residual_layer_norm(
        *map(torch.from_numpy, (x, r, w, b)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def test_reference_matches_jax_reference():
    x, w, b, _ = _inputs(4)
    ref = jax_ln.layer_norm_reference(*map(jnp.asarray, (x, w, b)))
    out = port_ln.layer_norm_reference(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_gradcheck_in_float64():
    """The plain B10 formula against autograd's finite differences, on
    float64 leaves. The statistics and the output are computed in f32 (as
    for every dtype), so the steps are 1e-3 and the limits 1e-3: f32
    rounding of outputs ~1 over a step of 1e-3 reads ~1e-4, the central
    difference's own error ~1e-6, a wrong term O(0.1)."""
    x, w, b, _ = _inputs(5, (4, 7, 6))
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, w, b)]
    assert torch.autograd.gradcheck(
        lambda *a: port_ln.FusedLayerNormFunction.apply(*a, 1e-5), leaves,
        eps=1e-3, atol=1e-3, rtol=1e-3)


def test_cpu_calls_count_no_launch_and_shapes_are_checked():
    x, w, b, g = (torch.from_numpy(a) for a in _inputs(6, (5, 8)))
    n_f, n_b = port_ln.layer_norm_fwd.launches, port_ln.layer_norm_bwd.launches
    o, mean, rstd = port_ln.layer_norm_fwd(x, w, b)
    port_ln.layer_norm_bwd(x, w, mean, rstd, g)
    assert (port_ln.layer_norm_fwd.launches,
            port_ln.layer_norm_bwd.launches) == (n_f, n_b)
    with pytest.raises(ValueError, match="weights"):
        port_ln.layer_norm_fwd(x, w[:4], b)
    with pytest.raises(ValueError, match="mean/rstd"):
        port_ln.layer_norm_bwd(x, w, mean[:2], rstd, g)
