"""The port's block-sparse attention on the CPU against the JAX package.

Layouts: each of the six SparsityConfig families, over successive
``make_layout`` calls (``Variable`` and ``BigBird`` draw from one
``RandomState`` across calls), must equal the JAX package's bit for bit, and
each validation error must be raised with the same type and message. The
plain version of kernel B8 is held to the Pallas kernel in interpret mode
(as the JAX package's own tests run it on the CPU) on the same numpy inputs:
2e-5 in float32 (both sides compute an exact softmax in f32; only the order
of the sums differs: online over blocks against one pass over the gathered
row) and 2e-2 in bfloat16 (both round P and the output to bf16, at
different running maxima, so results may land one bf16 step apart). The
CUDA kernel itself runs only on a card (``test_torch_cuda_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jax_sparse
import deepspeed_tpu_torch.ops.sparse_attention as port_sparse
from deepspeed_tpu.ops.pallas import block_sparse_attention as jax_bsa
from deepspeed_tpu_torch.ops import block_sparse_attention as port_bsa

B, T, H, D = 2, 64, 2, 16
BLOCK = 16

# (config class name, constructor kwargs, sequence lengths of successive
# make_layout calls)
LAYOUTS = [
    ("DenseSparsityConfig", dict(num_heads=4, block=16), (128, 96)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4,
                                 attention="unidirectional"), (128, 112)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4,
                                 num_global_blocks=2,
                                 horizontal_global_attention=True),
     (128, 80)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=4),
     (128, 96)),
    ("VariableSparsityConfig", dict(num_heads=4, block=16,
                                    num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[0, 5],
                                    different_layout_per_head=True, seed=3),
     (128, 96, 128)),
    ("VariableSparsityConfig", dict(num_heads=3, block=16,
                                    num_random_blocks=1,
                                    global_block_indices=[1, 4],
                                    global_block_end_indices=[3, 6],
                                    attention="unidirectional",
                                    horizontal_global_attention=False,
                                    seed=7), (128, 128)),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16), (128, 96, 128)),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16,
                                   different_layout_per_head=True,
                                   num_random_blocks=2,
                                   num_sliding_window_blocks=5,
                                   num_global_blocks=2,
                                   attention="unidirectional", seed=11),
     (128, 160)),
    ("BSLongformerSparsityConfig", dict(num_heads=4, block=16), (128, 96)),
    ("BSLongformerSparsityConfig", dict(num_heads=4, block=16,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0, 4],
                                        global_block_end_indices=[2, 9],
                                        attention="unidirectional"),
     (128, 96)),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=4, block=16),
     (128, 96)),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=4, block=16,
                                              num_sliding_window_blocks=5,
                                              attention="bidirectional"),
     (128,)),
]


@pytest.mark.parametrize("name,kwargs,lens", LAYOUTS)
def test_layouts_equal_jax(name, kwargs, lens):
    jcfg = getattr(jax_sparse, name)(**kwargs)
    pcfg = getattr(port_sparse, name)(**kwargs)
    for n in lens:
        a, b = jcfg.make_layout(n), pcfg.make_layout(n)
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, n)


# each builds a config, or a layout, that the JAX package refuses
INVALID = [
    lambda m: m.FixedSparsityConfig(num_heads=2, num_local_blocks=3,
                                    num_global_blocks=2),
    lambda m: m.FixedSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.FixedSparsityConfig(num_heads=2, attention="unidirectional",
                                    horizontal_global_attention=True),
    lambda m: m.FixedSparsityConfig(num_heads=2,
                                    num_different_global_patterns=2),
    lambda m: m.FixedSparsityConfig(num_heads=2, num_local_blocks=4,
                                    different_layout_per_head=True,
                                    num_different_global_patterns=5),
    lambda m: m.VariableSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.BigBirdSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.BSLongformerSparsityConfig(num_heads=2,
                                           global_block_indices=[0, 2],
                                           global_block_end_indices=[1]),
    lambda m: m.BSLongformerSparsityConfig(num_heads=2,
                                           global_block_indices=[3],
                                           global_block_end_indices=[3]),
    lambda m: m.DenseSparsityConfig(num_heads=2, block=16).make_layout(40),
    lambda m: m.VariableSparsityConfig(num_heads=2, block=16,
                                       num_random_blocks=5).make_layout(64),
    lambda m: m.BigBirdSparsityConfig(num_heads=2, block=16,
                                      num_sliding_window_blocks=7
                                      ).make_layout(64),
    lambda m: m.BSLongformerSparsityConfig(num_heads=2, block=16,
                                           num_sliding_window_blocks=7
                                           ).make_layout(64),
    lambda m: m.LocalSlidingWindowSparsityConfig(
        num_heads=2, block=16, num_sliding_window_blocks=7).make_layout(64),
]


@pytest.mark.parametrize("case", range(len(INVALID)))
def test_validation_errors_equal_jax(case):
    with pytest.raises(Exception) as jerr:
        INVALID[case](jax_sparse)
    with pytest.raises(Exception) as perr:
        INVALID[case](port_sparse)
    assert perr.type is jerr.type and str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_lut_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lay = (rng.random((3, 8, 8)) < 0.3).astype(np.int64)
    lay[:, 5] = 0                      # a row with no active block
    jl, jc = jax_bsa.build_lut(lay)
    pl_, pc = port_bsa.build_lut(lay)
    assert np.array_equal(jl, pl_) and jl.dtype == pl_.dtype
    assert np.array_equal(jc, pc) and jc.dtype == pc.dtype


def _qkv(seed, shape=(B, H, T, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32) for _ in range(3)]


KERNEL_CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=H, block=BLOCK)),
    "fixed": ("FixedSparsityConfig", dict(num_heads=H, block=BLOCK,
                                          num_local_blocks=2,
                                          attention="unidirectional")),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=H, block=BLOCK,
                                              different_layout_per_head=True)),
    "longformer": ("BSLongformerSparsityConfig",
                   dict(num_heads=H, block=BLOCK, global_block_indices=[2])),
}


def _cfg(module, layout):
    name, kwargs = KERNEL_CONFIGS[layout]
    return getattr(module, name)(**kwargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(KERNEL_CONFIGS))
def test_plain_kernel_matches_pallas(layout, causal, dtype):
    lay = _cfg(port_sparse, layout).make_layout(T)
    lut, counts = port_bsa.build_lut(lay)
    q, k, v = _qkv(5)
    jt = [jnp.asarray(x, dtype) for x in (q, k, v)]
    ref = jax_bsa.block_sparse_attention(*jt, jnp.asarray(lut),
                                         jnp.asarray(counts), BLOCK,
                                         causal=causal, interpret=True)
    tt = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    out = port_bsa.block_sparse_attention(*tt, torch.from_numpy(lut),
                                          torch.from_numpy(counts), BLOCK,
                                          causal=causal)
    assert out.dtype == tt[0].dtype and out.shape == (B, H, T, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_causally_dead_rows_output_zero():
    """An active block strictly above the diagonal under causal=True (the
    JAX test ``test_kernel_causally_dead_row_outputs_zero``): its rows see
    no key and give exactly 0, as the Pallas kernel does; a row block with
    count 0 too."""
    nb = T // BLOCK
    lay = np.zeros((H, nb, nb), np.int64)
    lay[:, 0, 1] = 1            # row block 0 sees only the future block 1
    for i in range(1, nb - 1):
        lay[:, i, i] = 1        # row block nb-1: count 0
    lut, counts = port_bsa.build_lut(lay)
    q, k, v = _qkv(6)
    out = port_bsa.block_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(lut),
        torch.from_numpy(counts), BLOCK, causal=True)
    ref = jax_bsa.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(lut), jnp.asarray(counts),
        BLOCK, causal=True, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    assert torch.all(out[:, :, :BLOCK] == 0)
    assert torch.all(out[:, :, -BLOCK:] == 0)
    assert torch.all(out[:, :, BLOCK:-BLOCK].abs().sum(-1) > 0)


@pytest.mark.parametrize("layout,causal", [("fixed", True),
                                           ("bigbird", False),
                                           ("longformer", False),
                                           ("dense", True)])
def test_sparse_attention_matches_jax(layout, causal):
    lay = _cfg(port_sparse, layout).make_layout(T)
    q, k, v = _qkv(7, (B, T, H, D))
    ref = jax_sparse.sparse_attention(*map(jnp.asarray, (q, k, v)), lay,
                                      BLOCK, causal=causal, interpret=True)
    oracle = jax_sparse.sparse_attention_reference(
        *map(jnp.asarray, (q, k, v)), lay, BLOCK, causal=causal)
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    out = port_sparse.sparse_attention(*tq, lay, BLOCK, causal=causal)
    port_oracle = port_sparse.sparse_attention_reference(*tq, lay, BLOCK,
                                                         causal)
    assert out.shape == (B, T, H, D)
    for a, b in ((out, ref), (port_oracle, oracle), (out, oracle)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("layout", ["fixed", "bigbird", "dense"])
@pytest.mark.parametrize("padded", [False, True])
def test_sparse_self_attention_matches_jax(layout, padded):
    """The front-end (layout + LUT cache, head check) with and without a
    key padding mask that pads sequence 1 fully and sequence 0 in part."""
    jop = jax_sparse.SparseSelfAttention(_cfg(jax_sparse, layout))
    pop = port_sparse.SparseSelfAttention(_cfg(port_sparse, layout))
    q, k, v = _qkv(8, (B, T, H, D))
    mask = None
    if padded:
        mask = np.ones((B, T), np.int32)
        mask[0, 50:] = 0
        mask[1, :] = 0
    ref = jop(*map(jnp.asarray, (q, k, v)),
              key_padding_mask=None if mask is None else jnp.asarray(mask),
              interpret=True)
    out = pop(*map(torch.from_numpy, (q, k, v)),
              key_padding_mask=None if mask is None else
              torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    if padded:
        assert torch.all(out[1] == 0) and not torch.all(out[0] == 0)
    assert np.array_equal(pop.layout(T), jop.layout(T))


def test_front_end_caches_the_lut_once_per_length_and_counts_no_cpu_launch():
    op = port_sparse.SparseSelfAttention(_cfg(port_sparse, "fixed"))
    before = port_bsa.block_sparse_attention.launches
    for n in (T, T, 2 * T, T):
        q, k, v = map(torch.from_numpy, _qkv(n, (1, n, H, D)))
        assert op(q, k, v).shape == (1, n, H, D)
    assert sorted(op._cache) == [T, 2 * T]
    assert port_bsa.block_sparse_attention.launches == before
    with pytest.raises(ValueError, match="heads"):
        op(*map(torch.from_numpy, _qkv(0, (1, T, H + 1, D))))


def test_ragged_length_raises_like_jax():
    q = np.zeros((1, 1, 40, 16), np.float32)
    lut, counts = np.zeros((1, 2, 1), np.int32), np.ones((1, 2), np.int32)
    with pytest.raises(ValueError) as jerr:
        jax_bsa.block_sparse_attention(*[jnp.asarray(q)] * 3,
                                       jnp.asarray(lut), jnp.asarray(counts),
                                       16, interpret=True)
    with pytest.raises(ValueError) as perr:
        port_bsa.block_sparse_attention(*[torch.from_numpy(q)] * 3,
                                        torch.from_numpy(lut),
                                        torch.from_numpy(counts), 16)
    assert str(perr.value) == str(jerr.value)
