"""The port's int8 weight storage and w8a8 GEMMs against the JAX package
on the CPU.

* ``quantize_weight``, ``quantize_weight_out`` and
  ``GroupQuantizer.quantize_tree`` (row-group and ``out_mode``, the MoE
  branch) give JAX's ``q`` and scales bit for bit: the same f32 division,
  rounding half to even and clip, on 2-D, ``[E, H, D]``, ``[H, D, E]`` and
  stacked-expert weights, with group sizes that must be clipped, 4-bit
  storage and an all-zero group.
* ``tree_weight_bytes`` and ``WeightQuantization`` (its leaves and
  ``quantized_paths``) equal JAX's.
* ``int8_matmul`` and ``int8_einsum`` in the q/k/v, attention-out and 2-D
  layouts: the int32 product is exact on both sides and the activation
  quant is the same f32 arithmetic, so the outputs agree to 1e-6
  relative (the f32 rescale's last bit); a zero activation row gives a
  zero output row; a 3-D weight is refused by ``int8_matmul``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.module_inject import quantize as jq
from deepspeed_tpu.ops import int8_gemm as jg
from deepspeed_tpu.ops import quant_core as jqc
from deepspeed_tpu.runtime.weight_quantizer import \
    WeightQuantization as JaxWeightQuantization
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.module_inject import quantize as tq
from deepspeed_tpu_torch.ops import int8_gemm as tg
from deepspeed_tpu_torch.ops import quant_core as tqc
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization

GEMM_RTOL = 1e-6


def _w(shape, seed=0, zero_rows=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w.reshape(-1, shape[-1])[:zero_rows] = 0.0   # an all-zero group
    return w


def _same_node(t, j):
    """A port node equals a JAX node: same keys, dtypes and bits."""
    assert set(t) == set(j)
    for k in j:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("shape,group,bits,zero_rows", [
    ((96, 40), 64, 8, 64),       # 64 does not divide 96: clipped to 48
    ((32, 4, 8), 64, 8, 0),      # [E, H, D]: groups within a dim-0 slice
    ((4, 8, 32), 5, 8, 8),       # [H, D, E]: 5 clipped to 4
    ((3, 16, 24), 64, 8, 0),     # stacked experts
    ((64, 48), 16, 4, 16),       # 4-bit storage
])
def test_quantize_weight_is_jax_bit_for_bit(shape, group, bits, zero_rows):
    w = _w(shape, zero_rows=zero_rows)
    t = tq.quantize_weight(torch.from_numpy(w), group, bits)
    _same_node(t, jq.quantize_weight(w, group, bits))
    assert t["scale"].shape == shape[:-1] + (1,)
    if zero_rows:
        assert not t["q"].reshape(-1, shape[-1])[:zero_rows].any()
    assert tq.quantize_weight(t) is t   # already quantized


@pytest.mark.parametrize("shape,contract", [
    ((48, 40), (0,)), ((32, 4, 8), (0,)), ((4, 8, 32), (0, 1)),
    ((3, 16, 24), (1,))])
def test_quantize_weight_out_is_jax_bit_for_bit(shape, contract):
    w = _w(shape, 1, zero_rows=1)
    t = tq.quantize_weight_out(torch.from_numpy(w), contract)
    _same_node(t, jq.quantize_weight_out(w, contract))
    assert all(t["oscale"].shape[d] == 1 for d in contract)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dequantize_matches_jax(dtype):
    w = _w((64, 24), 2)
    node = jq.quantize_weight(w, 16)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    t = tq.dequantize_weight(params_from_numpy(jax.device_get(node)), tdt)
    j = jq.dequantize_weight(node, dtype)
    assert t.dtype == tdt
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    # the int8 KV pool's dequant: f32 by default, cast on request
    q, s = jqc.quantize_int8(jnp.asarray(w), -1)
    tq_, ts = (torch.from_numpy(np.array(a)) for a in (q, s))
    assert tqc.dequantize_int8(tq_, ts).dtype == torch.float32
    np.testing.assert_array_equal(
        tqc.dequantize_int8(tq_, ts, tdt).float().numpy(),
        np.asarray(jqc.dequantize_int8(q, s, dtype).astype(jnp.float32)))


def _tree(variant="gpt2", moe=False):
    kw = dict(gated_mlp=True, activation="silu", norm_type="rmsnorm",
              n_kv_head=2) if variant == "gated" else {}
    cfg = jt.InferenceTransformerConfig(
        vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32, **kw)
    p = jax.device_get(jt.init_params(jax.random.PRNGKey(0), cfg))
    if moe:   # a stacked-expert layer, as the JAX MoE models carry
        layer = p["layers"][1]
        ex = {"wi": _w((3, 32, 64), 5), "bi": np.zeros((3, 64), np.float32),
              "wo": _w((3, 64, 32), 6), "bo": np.zeros((3, 32), np.float32)}
        layer["moe"] = {"gate": _w((32, 3), 7), "experts": ex}
        del layer["mlp"]
    return p


def _same_tree(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _same_tree(t[k], j[k])
    elif isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same_tree(a, b)
    else:
        a, b = t.numpy(), np.asarray(j)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,moe,out_mode", [
    ("gpt2", False, False), ("gpt2", False, True), ("gated", False, False),
    ("gated", False, True), ("gpt2", True, False), ("gpt2", True, True)])
def test_group_quantizer_tree_is_jax_bit_for_bit(variant, moe, out_mode):
    jp = _tree(variant, moe)
    tp = params_from_numpy(jp)
    t = tq.GroupQuantizer(group_size=16, out_mode=out_mode).quantize_tree(tp)
    j = jax.device_get(jq.GroupQuantizer(
        group_size=16, out_mode=out_mode).quantize_tree(jp))
    _same_tree(t, j)
    key = "oscale" if out_mode else "scale"
    assert set(t["layers"][0]["attn"]["wo"]) == {"q", key}
    assert torch.is_tensor(t["layers"][0]["attn"]["bo"])   # biases stay
    assert tq.GroupQuantizer(q_int8=False).quantize_tree(tp) is tp
    # bytes: int8 + f32 scales against f32 storage, both packages
    assert tq.tree_weight_bytes(t) == jq.tree_weight_bytes(j)
    assert tq.tree_weight_bytes(tp) == jq.tree_weight_bytes(jp)
    assert tq.tree_weight_bytes(t) < tq.tree_weight_bytes(tp)


@pytest.mark.parametrize("extra,skip", [
    (True, None), (False, None), (True, ("*norm*", "*wq*"))])
def test_weight_quantization_matches_jax(extra, skip):
    jp = _tree("gated")
    kw = dict(mlp_extra_grouping=extra, quantize_groups=8, min_size=512)
    if skip is not None:
        kw["skip_patterns"] = skip
    jw, tw = JaxWeightQuantization(**kw), WeightQuantization(**kw)
    j = jax.device_get(jw.model_quantize(jp))
    t = tw.model_quantize(params_from_numpy(jp))
    _same_tree(t, j)
    assert tw.quantized_paths == jw.quantized_paths
    assert tw.quantized_paths   # something quantized
    node = t["layers"][0]["mlp"]["wi"]
    np.testing.assert_array_equal(
        WeightQuantization.dequantize(node).numpy(),
        np.asarray(JaxWeightQuantization.dequantize(
            j["layers"][0]["mlp"]["wi"])))
    # an already quantized node is left as it is
    again = WeightQuantization(**kw)
    assert again.model_quantize(t)["layers"][0]["mlp"]["wi"] is node


def _x(shape, seed=3, xc=1):
    """Activations whose first token (over the ``xc`` contracted dims) is
    all zero."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[(0,) * (x.ndim - xc)] = 0.0
    return x


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GEMM_RTOL,
                               atol=GEMM_RTOL * float(np.abs(j).max()))


@pytest.mark.parametrize("form", ["qkv", "attn_out", "2d"])
def test_int8_einsum_matches_jax(form):
    """``oscale`` leaves through ``maybe_int8_einsum`` /
    ``maybe_int8_matmul`` with w8a8 on."""
    if form == "qkv":
        w, c, sub, x, xc, wo = _w((32, 4, 8)), (0,), "...e,ehd->...hd", \
            _x((2, 5, 32)), 1, 2
    elif form == "attn_out":
        w, c, sub, x, xc, wo = _w((4, 8, 32)), (0, 1), "...hd,hde->...e", \
            _x((2, 5, 4, 8), xc=2), 2, 1
    else:
        w, c, sub, x, xc, wo = _w((32, 48)), (0,), "...k,kn->...n", \
            _x((3, 32)), 1, 1
    jnode = jq.quantize_weight_out(w, c)
    tnode = params_from_numpy(jax.device_get(jnode))
    j = jg.maybe_int8_einsum(sub, jnp.asarray(x), jnode, jnp.float32, True,
                             xc, wo)
    t = tg.maybe_int8_einsum(sub, torch.from_numpy(x), tnode, torch.float32,
                             True, xc, wo)
    _close(t, j)
    # the zero activation row stays exactly zero
    assert not t[(0,) * (x.ndim - xc)].any()
    # column-major storage changes no value
    laid = tg.int8_compute_layout(tnode)
    assert torch.equal(laid["q"], tnode["q"])
    assert laid["q"].reshape(int(np.prod(w.shape[:len(c)])), -1).stride(0) \
        == 1
    _close(tg.int8_einsum(sub, torch.from_numpy(x), laid, xc, wo,
                          torch.float32), j)
    if form == "2d":
        _close(tg.maybe_int8_matmul(torch.from_numpy(x), tnode,
                                    torch.float32, True),
               jg.maybe_int8_matmul(jnp.asarray(x), jnode, jnp.float32,
                                    True))


@pytest.mark.parametrize("shape", [(3, 32), (2, 5, 32)])
def test_int8_matmul_matches_jax(shape):
    """Row-group leaves: the row scales folded into x, one dynamic quant."""
    jnode = jq.quantize_weight(_w((32, 48), 4), 8)
    tnode = params_from_numpy(jax.device_get(jnode))
    x = _x(shape)
    j = jg.int8_matmul(jnp.asarray(x), jnode)
    t = tg.int8_matmul(torch.from_numpy(x), tnode)
    _close(t, j)
    _close(tg.maybe_int8_matmul(torch.from_numpy(x), tnode, torch.float32,
                                True), j)
    # without w8a8 the seam dequantizes, as JAX's
    np.testing.assert_allclose(
        tg.maybe_int8_matmul(torch.from_numpy(x), tnode, torch.float32,
                             False).numpy(),
        np.asarray(jg.maybe_int8_matmul(jnp.asarray(x), jnode, jnp.float32,
                                        False)), rtol=1e-5, atol=1e-5)


def test_int8_refusals():
    node = tq.quantize_weight(torch.from_numpy(_w((32, 4, 8))))
    x = torch.from_numpy(_x((2, 32)))
    with pytest.raises(ValueError, match="2-D"):
        tg.int8_matmul(x, node)
    with pytest.raises(ValueError, match="2-D"):
        jg.int8_matmul(jnp.asarray(x.numpy()), jq.quantize_weight(
            _w((32, 4, 8))))
    # a row-group [E, H, D] leaf under w8a8 takes the dequant einsum
    y = tg.maybe_int8_einsum("...e,ehd->...hd", x, node, torch.float32,
                             True, 1, 2)
    assert y.shape == (2, 4, 8)
    # the batched expert forms wait for the MoE slice
    ex = tq.quantize_weight_out(torch.from_numpy(_w((3, 32, 16))), (1,))
    with pytest.raises(NotImplementedError, match="MoE"):
        tg.int8_einsum("xse,xef->xsf", torch.zeros(3, 4, 32), ex, 1, 1,
                       torch.float32)
