"""Head dims up to 256 in the port (faults D1a, D1b-i and D1b-ii) on the CPU.

Every CUDA attention kernel (B1-B8, B5i-B7i) runs any head dim D <= 256 on
its 64-, 128- or 256-wide instantiation: columns past D are read as zeros
and never written, and the scale comes from the true D. What the CPU can
check:

* ``head_dim_route`` for every D in 1..320 and operand sizes 1, 2 and 4:
  the kernel width, the padded route, the D1c error of every kernel above
  256, one route for every kernel (the flash backward's and B8's wrappers
  take B1's); and ``warn_if_padded``, the warning the cache builders give
  for that route.
* Each attention kernel's plain version against its JAX function, run as
  the JAX tests run it (Pallas in interpret mode), at D in {32, 40, 80, 96,
  112, 132, 160, 192, 256} (int8 pools at those of whole 16-byte rows):
  flash forward + LSE, the flash backward, dense decode, paged decode,
  chunk and verify over fp and int8 pools, and block-sparse attention on
  layout (i) (Fixed, causal).
  Tolerance 1e-5 in f32: both sides compute an exact f32 softmax and its
  gradients; only the order of the sums differs.
* The zero-fill identity the kernels rely on: each plain version on inputs
  zero-padded to the kernel width, with the scale of the true D, sliced
  back, equals its result at the true D within 1e-6 in f32 (the padded
  sums add exact zeros; BLAS may block the longer sums otherwise).
* End to end, 2 layers at narrow widths with the new head dims: the GPT-2
  training model's loss and gradients at D = 80 (n_embd 160, 2 heads), D =
  96 (192, 2) and D = 256 (512, 2) against the JAX model (the tolerances of
  tests/test_torch_gpt2.py), and a NeoX-style parallel-residual model at
  D = 80 with rotary_dim 20: greedy tokens of ``generate`` and of the paged
  server equal to the JAX engine's and server's, token for token; and a
  GPT-J-shaped model (2 heads of 256, rotary_dim 64 interleaved, one
  shared LayerNorm, an untied head with a bias) the same way, through
  prefix caching with chunked prefill and speculation K=4, over fp and
  int8 pools.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import ContinuousBatchingServer as JaxServer
from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops import quant_core as jqc
from deepspeed_tpu.ops.pallas import block_sparse_attention as jax_bsa
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.pallas import flash_attention as jax_flash
from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                           DeepSpeedInferenceConfig,
                                           InferenceEngine)
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.module_inject.from_jax import gpt2_params_from_flax
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import sparse_attention as tsparse
from deepspeed_tpu_torch.ops.head_dim import (MAX_HEAD_DIM, head_dim_route,
                                              pad_head_dim, warn_if_padded)

TOL = 1e-5
PAD_TOL = 1e-6
DIMS = [32, 40, 80, 96, 112]
# the kernels' 256-wide instantiation; 132 takes its padded route
WIDE_DIMS = [132, 160, 192, 256]
# the paged pools: 12 blocks of 32, tables with out-of-order ids
NB, BS = 12, 32
TABLES = np.array([[3, 5, 0, 0], [1, 2, 7, 9], [11, 0, 0, 0]], np.int32)


def _rng(*key):
    return np.random.default_rng(list(key))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- the route

@pytest.mark.parametrize("elem", [1, 2, 4])
def test_head_dim_route_for_every_head_dim(elem):
    """DK = 64 up to 64, 128 up to 128, 256 up to 256 (the serving
    kernels); the padded route exactly where a row of D elements is no
    whole number of 16-byte chunks; D1c above 256."""
    per_chunk = 16 // elem
    assert MAX_HEAD_DIM == 256
    for D in range(1, MAX_HEAD_DIM + 1):
        DK, pad = head_dim_route(D, elem)
        assert DK == (64 if D <= 64 else 128 if D <= 128 else 256), D
        assert pad == (D % per_chunk != 0), D
    for D in range(MAX_HEAD_DIM + 1, 321):
        with pytest.raises(ValueError, match="D1c"):
            head_dim_route(D, elem)
    # the public models' head dims all take the native route in 16 bits
    assert all(not head_dim_route(D, 2)[1] for D in (32, 40, 48, 80, 96,
                                                       112, 256))


@pytest.mark.parametrize("elem", [1, 2, 4])
def test_every_kernel_takes_one_route_to_256(elem):
    """The flash backward and B8 take B1's route: the same width and pad
    for every D up to 256, D1c above; and their wrappers refuse only
    there."""
    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[elem]
    for D in range(1, MAX_HEAD_DIM + 1):
        q = torch.empty((1, 4, 2, D), dtype=dtype, device="meta")
        assert tfa._route(q, q, q) == head_dim_route(D, elem), D
    for D in range(MAX_HEAD_DIM + 1, 321):
        q = torch.empty((1, 4, 2, D), dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="D1c"):
            tfa._route(q, q, q)
    # the wrappers route before they launch; a 'meta' tensor is no CPU
    # tensor, so they take the kernel path: at 256 they pass the route and
    # stop at the device check after it, at 320 they refuse at the route
    lse = torch.empty((1, 2, 16), device="meta")
    lut = torch.zeros((2, 1, 1), dtype=torch.int32, device="meta")
    counts = torch.ones((2, 1), dtype=torch.int32, device="meta")
    for D, match in ((256, "cuda or cpu"), (320, "D1c")):
        q = torch.empty((1, 16, 2, D), device="meta")
        qb = q.transpose(1, 2)
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention_bwd_dq(q, q, q, q, lse, q)
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention_bwd_dkv(q, q, q, lse, lse, q)
        with pytest.raises(ValueError, match=match):
            tbsa.block_sparse_attention(qb, qb, qb, lut, counts, 16)


@pytest.mark.parametrize("D,elem,device,padded", [
    (40, 1, "cuda", True),      # an int8 pool of 40: 2.5 chunks a row
    (36, 2, "cuda", True),
    (80, 1, "cuda", False),     # Pythia-2.8B's int8 pool
    (80, 2, "cuda", False),
    (40, 2, "cuda", False),
    (40, 1, "cpu", False),      # the plain versions copy nothing
    (256, 2, "cuda", False),    # GPT-J's 256: native on the 256-wide tile
    (132, 2, "cuda", True),     # padded to 256
    (136, 1, "cuda", True),     # an int8 pool of 136: 8.5 chunks a row
    (320, 2, "cuda", False),    # D1c: the first call raises instead
])
def test_cache_builders_warn_of_the_padded_route(D, elem, device, padded):
    """The engine and the server warn when their cache or pool would be
    copied whole on every attention call: exactly the padded route on a
    CUDA device."""
    assert warn_if_padded("pool", D, elem, device) is padded


# --------------------------------------------------- plain versions vs JAX

def _to3(x):   # [B, T, h, D] -> [B*h, T, D], the Pallas kernels' layout
    B, T, h, D = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(B * h, T, D)


def _from3(x, B, h):
    BH, T, D = x.shape
    return np.swapaxes(np.asarray(x).reshape(B, h, T, D), 1, 2)


def _flash_inputs(D):
    rng = _rng(1, D)
    B, T, H, KH = 2, 256, 4, 2
    return (_normal(rng, (B, T, H, D)), _normal(rng, (B, T, KH, D)),
            _normal(rng, (B, T, KH, D)), _normal(rng, (B, T, H, D)))


@pytest.mark.parametrize("D", DIMS + WIDE_DIMS)
def test_flash_fwd_plain_matches_pallas(D):
    q, k, v, _ = _flash_inputs(D)
    scale = 1.0 / np.sqrt(D)
    o3, lse3 = jax_flash._flash_fwd(_to3(q), _to3(k), _to3(v), scale=scale,
                                    block_q=128, block_k=128, causal=True,
                                    interpret=True)
    o, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=True)
    _close(o, _from3(o3, 2, 4))
    _close(lse, np.asarray(lse3).reshape(2, 4, -1))


@pytest.mark.parametrize("D", DIMS + WIDE_DIMS)
def test_flash_bwd_plain_matches_pallas(D):
    q, k, v, do = _flash_inputs(D)
    scale = 1.0 / np.sqrt(D)
    o3, lse3 = jax_flash._flash_fwd(_to3(q), _to3(k), _to3(v), scale=scale,
                                    block_q=128, block_k=128, causal=True,
                                    interpret=True)
    dq3, dk3, dv3 = jax_flash._flash_bwd(
        _to3(q), _to3(k), _to3(v), o3, lse3, _to3(do), scale=scale,
        block_q=128, block_k=128, causal=True, interpret=True)
    o = torch.from_numpy(_from3(o3, 2, 4).copy())
    lse = torch.from_numpy(np.asarray(lse3).reshape(2, 4, -1).copy())
    dq, dk, dv = tfa.flash_attention_bwd(*_t(q, k, v), o, lse,
                                         torch.from_numpy(do))
    for got, want, h in ((dq, dq3, 4), (dk, dk3, 2), (dv, dv3, 2)):
        _close(got, _from3(want, 2, h))


@pytest.mark.parametrize("D", DIMS + WIDE_DIMS)
def test_decode_plain_matches_pallas(D):
    rng = _rng(2, D)
    B, S, H, KH = 3, 256, 8, 2
    q, kc, vc = (_normal(rng, (B, H, D)), _normal(rng, (B, S, KH, D)),
                 _normal(rng, (B, S, KH, D)))
    lens = np.array([1, 137, S], np.int32)
    want = jda.decode_attention(*_j(q, kc, vc, lens), block_k=128,
                                interpret=True)
    _close(tda.decode_attention(*_t(q, kc, vc, lens)), want)


def _int8_pool(rng, KH, D):
    """An int8 pool [NB, BS, KH, D] quantized per (position, head) row and
    its [NB, KH, BS] scale tiles."""
    q, s = jqc.quantize_int8(jnp.asarray(_normal(rng, (NB, BS, KH, D))), -1)
    return np.asarray(q), np.asarray(s)[..., 0].transpose(0, 2, 1).copy()


def _paged_inputs(D, pool):
    """q for decode [3, 8, D], chunk [40, 8, D] and verify [3, 3, 8, D], and
    the pools over 2 kv heads (fp, or int8 with scale tiles)."""
    rng = _rng(3, D, pool == "int8")
    qs = (_normal(rng, (3, 8, D)), _normal(rng, (40, 8, D)),
          _normal(rng, (3, 3, 8, D)))
    if pool == "fp":
        return qs, (_normal(rng, (NB, BS, 2, D)),
                    _normal(rng, (NB, BS, 2, D))), {}
    (kq, ks), (vq, vs) = _int8_pool(rng, 2, D), _int8_pool(rng, 2, D)
    return qs, (kq, vq), {"k_scale": ks, "v_scale": vs}


PAGED_CASES = ([(D, "fp") for D in DIMS + WIDE_DIMS]
               + [(D, "int8") for D in DIMS + WIDE_DIMS if D % 16 == 0])


@pytest.mark.parametrize("D,pool", PAGED_CASES)
def test_paged_plain_versions_match_pallas(D, pool):
    """Decode (with a length-0 slot), chunk (start one block in) and verify
    (K = 3), over fp pools and over int8 pools with their scale tiles at the
    head dims whose int8 rows are whole 16-byte chunks (the others take the
    padded route, whose arithmetic the zero-fill identity below covers)."""
    (qd, qc, qv), (kp, vp), sc = _paged_inputs(D, pool)
    tk, tv = _t(kp, vp)
    jk, jv = _j(kp, vp)
    tsc = {k: torch.from_numpy(v) for k, v in sc.items()}
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    lens = np.array([0, 100, 17], np.int32)
    got = tda.paged_decode_attention(*_t(qd), tk, tv, *_t(TABLES, lens),
                                     **tsc)
    want = jda.paged_decode_attention(*_j(qd), jk, jv, *_j(TABLES, lens),
                                      interpret=True, **jsc)
    assert not got[0].any()   # the idle slot
    _close(got, want)
    got = tda.paged_chunk_attention(*_t(qc), tk, tv, *_t(TABLES[1]), 32,
                                    **tsc)
    want = jda.paged_chunk_attention(*_j(qc), jk, jv, *_j(TABLES[1]),
                                     jnp.int32(32), interpret=True, **jsc)
    _close(got, want)
    lens = np.array([40, 100, 17], np.int32)
    got = tda.paged_verify_attention(*_t(qv), tk, tv, *_t(TABLES, lens),
                                     **tsc)
    want = jda.paged_verify_attention(*_j(qv), jk, jv, *_j(TABLES, lens),
                                      interpret=True, **jsc)
    _close(got, want)


def _fixed_layout(H, block, T):
    """Layout (i) of chip_smoke.py's phase sparse: Fixed, unidirectional."""
    return tsparse.FixedSparsityConfig(
        num_heads=H, block=block, num_local_blocks=4,
        attention="unidirectional").make_layout(T)


@pytest.mark.parametrize("D", DIMS + WIDE_DIMS)
def test_block_sparse_plain_matches_pallas(D):
    rng = _rng(4, D)
    B, H, T, block = 2, 2, 256, 64
    lut, counts = tbsa.build_lut(_fixed_layout(H, block, T))
    q, k, v = (_normal(rng, (B, H, T, D)) for _ in range(3))
    want = jax_bsa.block_sparse_attention(*_j(q, k, v, lut, counts), block,
                                          causal=True, interpret=True)
    got = tbsa.block_sparse_attention(*_t(q, k, v, lut, counts), block,
                                      causal=True)
    _close(got, want)


# ------------------------------------------------- the zero-fill identity

def _padded(fn, D, *xs):
    """``fn`` on ``xs`` zero-padded to the kernel width, sliced back to D
    (every output whose last dim is the kernel width)."""
    DK, _ = head_dim_route(D, 4)
    out = fn(*(pad_head_dim(x, DK) if x.shape[-1] == D else x for x in xs))
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(o[..., :D] if o.shape[-1] == DK else o for o in outs)


def _identity_cases(D):
    """(name, plain version with the scale of the true D fixed, tensor
    arguments; those whose last dim is D get padded)."""
    s = 1.0 / np.sqrt(D)
    q, k, v, do = _t(*_flash_inputs(D))
    o, lse = tfa.flash_attention_reference(q, k, v, True, s)
    (qd, qc, qv), (kp, vp), _ = _paged_inputs(D, "fp")
    qd, qc, qv, kp, vp = _t(qd, qc, qv, kp, vp)
    _, (k8, v8), sc = _paged_inputs(D, "int8")
    k8, v8, ks, vs = _t(k8, v8, sc["k_scale"], sc["v_scale"])
    rng = _rng(5, D)
    kc, vc = _t(_normal(rng, (3, 256, 2, D)), _normal(rng, (3, 256, 2, D)))
    tab, dl, vl = _t(TABLES, np.array([0, 100, 17], np.int32),
                     np.array([40, 100, 17], np.int32))
    lens = torch.tensor([1, 137, 256], dtype=torch.int32)
    lut, counts = _t(*tbsa.build_lut(_fixed_layout(2, 64, 256)))
    bq, bk, bv = _t(*(_normal(rng, (2, 2, 256, D)) for _ in range(3)))
    return [
        ("flash fwd", lambda *a: tfa.flash_attention_reference(
            *a, True, s), (q, k, v)),
        ("flash bwd", lambda *a: tfa.flash_attention_bwd_reference(
            *a, True, s), (q, k, v, o, lse, do)),
        ("decode", lambda *a: tda.decode_attention_reference(*a, lens, s),
         (qd, kc, vc)),
        ("paged decode", lambda *a: tda.paged_decode_attention_reference(
            *a, tab, dl, s), (qd, kp, vp)),
        ("paged chunk", lambda *a: tda.paged_chunk_attention_reference(
            *a, tab[1], 32, s), (qc, kp, vp)),
        ("paged verify", lambda *a: tda.paged_verify_attention_reference(
            *a, tab, vl, s), (qv, kp, vp)),
        ("paged decode int8",
         lambda *a: tda.paged_decode_attention_reference(
             *a, tab, dl, s, ks, vs), (qd, k8, v8)),
        ("paged chunk int8",
         lambda *a: tda.paged_chunk_attention_reference(
             *a, tab[1], 32, s, ks, vs), (qc, k8, v8)),
        ("paged verify int8",
         lambda *a: tda.paged_verify_attention_reference(
             *a, tab, vl, s, ks, vs), (qv, k8, v8)),
        ("block sparse", lambda *a: tbsa.block_sparse_attention_reference(
            *a, lut, counts, 64, True, s), (bq, bk, bv)),
    ]


@pytest.mark.parametrize("D", DIMS)
def test_plain_versions_keep_the_zero_fill_identity(D):
    for name, fn, args in _identity_cases(D):
        want = fn(*args)
        want = want if isinstance(want, tuple) else (want,)
        got = _padded(fn, D, *args)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PAD_TOL,
                                       atol=PAD_TOL, err_msg=name)


# --------------------------------------------------------------- models

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("n_embd,D", [(160, 80), (192, 96), (512, 256)])
def test_gpt2_loss_and_grads_match_jax_at_new_head_dims(n_embd, D):
    """The training GPT-2 with 2 heads of D (gpt2-2.7b's 80, gpt2-760m's
    96, Gemma-2B's 256), flash attention and remat on, 2 layers: the loss
    to 1e-5 relative and every gradient leaf to 1e-4 of its largest
    element."""
    tiny = dict(vocab_size=96, n_positions=64, n_embd=n_embd, n_layer=2,
                n_head=2)
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **tiny, dtype=jnp.float32, remat=True, use_flash_attention=True))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0), batch_size=2,
                                         seq_len=64))
    ids = _rng(6, D).integers(0, 96, (2, 64)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jparams, {"input_ids": jnp.asarray(ids)})
    jgrads = _flatten(jax.device_get(jgrads))
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **tiny, dtype=torch.float32, remat=True, use_flash_attention=True))
    assert model.config.n_embd // model.config.n_head == D
    params = {k: v.requires_grad_() for k, v in
              gpt2_params_from_flax(jparams).items()}
    loss = model.loss_fn(params, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(jgrads) == set(params)
    assert any(n.endswith("c_attn.kernel") for n in params)
    for (name, _), g in zip(params.items(), grads):
        ref = jgrads[name]
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, ref / scale,
                                   atol=1e-4, err_msg=name)


# a NeoX-style model (Pythia's block) at D = 80: parallel attention and MLP
# with two LayerNorms, a quarter of the head dim rotated (rotary_dim 20,
# not interleaved), exact GELU, an untied head
NEOX = dict(vocab_size=128, n_positions=256, n_embd=160, n_layer=2, n_head=2,
            positional="rotary", rotary_dim=20, parallel_attn_mlp=True,
            activation="gelu", tied_lm_head=False, layer_norm_eps=1e-5)
PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13],
           [20, 21], [30], [40, 41, 42, 43, 44], [50, 51]]
SHARED = [1 + (i * 7) % 120 for i in range(70)]


def _neox_engines(knobs):
    jcfg = jt.InferenceTransformerConfig(**NEOX, dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    assert tcfg.head_dim == 80
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.float32)
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32,
                num_slots=2)
    conf.update(knobs)
    return (JaxEngine((jcfg, jp), JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


def _serve(server_cls, eng, prompts, new):
    srv = server_cls(eng)
    ids = [srv.submit(p, max_new_tokens=new) for p in prompts[:1]]
    for _ in range(3):
        srv.step()
    ids += [srv.submit(p, max_new_tokens=new) for p in prompts[1:]]
    srv.drain()
    out = [srv.result(i) for i in ids]
    stats = srv.stats
    srv.close()
    return out, stats


@pytest.mark.parametrize("case", ["monolithic", "chunked+prefix",
                                  "speculation-k4"])
def test_neox_head_dim_80_serves_like_jax(case):
    """Greedy tokens of the port's generate and paged server against the
    JAX engine's and server's, and the server against generate."""
    knobs, prompts = {
        "monolithic": ({}, PROMPTS),
        "chunked+prefix": ({"enable_prefix_caching": True,
                            "prefill_chunk_tokens": 32},
                           [SHARED + [100 + i] * (i + 1) for i in range(4)]
                           + PROMPTS[:2]),
        "speculation-k4": ({"speculation_tokens": 4},
                           [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5],
                            [9, 8, 7, 9, 8]]),
    }[case]
    je, te = _neox_engines(knobs)
    new = 6
    t_gen = te.generate(prompts, max_new_tokens=new)
    assert t_gen == [list(r) for r in je.generate(prompts,
                                                  max_new_tokens=new)]
    j_out, _ = _serve(JaxServer, je, prompts, new)
    t_out, st = _serve(ContinuousBatchingServer, te, prompts, new)
    assert t_out == j_out
    assert t_out == t_gen
    if case == "chunked+prefix":
        assert st["prefix_cache_hits"] > 0 and st["prefill_chunks"] > 0


# a GPT-J-shaped model at D = 256: parallel attention and MLP behind one
# shared LayerNorm (no ln2), a quarter of the head dim rotated in GPT-J's
# interleaved pairs (rotary_dim 64), gelu_new, an untied head with a bias
GPTJ = dict(vocab_size=128, n_positions=256, n_embd=512, n_layer=2,
            n_head=2, positional="rotary", rotary_dim=64,
            rotary_interleaved=True, parallel_attn_mlp=True,
            activation="gelu_new", tied_lm_head=False, layer_norm_eps=1e-5)


def _gptj_engines(knobs):
    jcfg = jt.InferenceTransformerConfig(**GPTJ, dtype=jnp.float32)
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(1), jcfg))
    jp["lm_head_bias"] = _normal(_rng(7), (GPTJ["vocab_size"],))
    assert all("ln2" not in lay for lay in jp["layers"])
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    assert tcfg.head_dim == 256
    tp = params_from_numpy(jp, "cpu", torch.float32)
    assert "lm_head_bias" in tp
    conf = dict(dtype="float32", max_out_tokens=256, block_size=32,
                num_slots=2)
    conf.update(knobs)
    return (JaxEngine((jcfg, jax.tree_util.tree_map(jnp.asarray, jp)),
                      JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("case", ["chunked+prefix", "speculation-k4"])
def test_gptj_head_dim_256_serves_like_jax(case, pool):
    """Greedy tokens of the port's generate and paged server against the
    JAX engine's and server's; over an fp pool also the server against
    generate (an int8 pool's chunks read quantized prefix keys)."""
    knobs, prompts = {
        "chunked+prefix": ({"enable_prefix_caching": True,
                            "prefill_chunk_tokens": 32},
                           [SHARED + [100 + i] * (i + 1) for i in range(3)]
                           + PROMPTS[:2]),
        "speculation-k4": ({"speculation_tokens": 4},
                           [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5],
                            [9, 8, 7, 9, 8]]),
    }[case]
    if pool == "int8":
        knobs = dict(knobs, kv_cache_dtype="int8")
    je, te = _gptj_engines(knobs)
    new = 6
    t_gen = te.generate(prompts, max_new_tokens=new)
    assert t_gen == [list(r) for r in je.generate(prompts,
                                                  max_new_tokens=new)]
    j_out, _ = _serve(JaxServer, je, prompts, new)
    t_out, st = _serve(ContinuousBatchingServer, te, prompts, new)
    assert t_out == j_out
    if pool == "fp":
        assert t_out == t_gen
    if case == "chunked+prefix":
        assert st["prefix_cache_hits"] > 0 and st["prefill_chunks"] > 0
    else:
        assert st["speculation"]["verify_steps"] > 0
