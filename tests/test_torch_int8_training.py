"""SwitchBack int8 training in the port against the JAX package on the
CPU.

* ``switchback_matmul``'s forward, dx and dw against JAX's
  ``custom_vjp``: f32 inputs to 1e-6 relative for the forward and dx (the
  same quantization and an exact int32 product; only the f32 rescale's
  last bit may differ) and 1e-5 of the largest element for dw (an f32
  GEMM summed in another order); bf16 inputs to one bf16 step of the
  largest element (the same f32 values rounded once to bf16).
* ``lm_logits`` with and without int8, and its gradients.
* A 2-layer GPT-2 with ``int8_training=True`` in f32: the loss to 1e-5
  relative and every gradient leaf within 1e-2 relative L2 and 2e-2 of
  its largest element. The two frameworks' f32 activations differ in
  their last bits, which can move an int8 code by one step (1/127 of its
  row's amax) where a value sits on a rounding boundary; such a flip in
  the first block's backward reaches its gradients and the embeddings'.
* A 3-step ``train_batch`` trajectory against the JAX engine: the first
  step's loss to 1e-5 and gradient norm to 1e-3 relative (observed 1e-7
  and 6e-5), later steps' to 1e-3 and 5e-3 (observed 6e-5 and 5e-4), and
  each master leaf's update (final minus initial) within 5e-2 relative L2
  (observed 2.7e-2) and ``6 lr`` absolute: Adam scales each element's
  step by its own gradient history, so a flipped code reaches the update
  at up to ``lr`` a step on either side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops import int8_training as jit8
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject.from_jax import (gpt2_params_from_flax,
                                                        gpt2_params_to_numpy)
from deepspeed_tpu_torch.ops import int8_training as tit8

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
GRAD_L2 = 1e-2
GRAD_MAX = 2e-2
LR = 1e-3


def _np(shape, seed, scale=1.0, zero_row=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    if zero_row:
        a.reshape(-1, shape[-1])[0] = 0.0
    return a


def _vjp_both(fn_j, fn_t, x, w, dy, jdt, tdt):
    y, vjp = jax.vjp(fn_j, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(dy, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    ty = fn_t(tx, tw)
    tdx, tdw = torch.autograd.grad(ty, [tx, tw],
                                   torch.from_numpy(dy).to(tdt))
    assert ty.dtype == tdx.dtype == tdw.dtype == tdt
    return [(t.detach().float().numpy(), np.asarray(j.astype(jnp.float32)))
            for t, j in ((ty, y), (tdx, jdx), (tdw, jdw))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xshape", [(6, 32), (3, 5, 32)])
def test_switchback_matmul_matches_jax(dtype, xshape):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _np(xshape, 0, zero_row=True)
    w = _np((32, 24), 1, 0.1)
    dy = _np(xshape[:-1] + (24,), 2)
    out = _vjp_both(jit8.switchback_matmul, tit8.switchback_matmul, x, w,
                    dy, jdt, tdt)
    for i, (t, j) in enumerate(out):
        top = float(np.abs(j).max())
        if dtype == "bfloat16":
            tol = 2.0 ** (np.floor(np.log2(top)) - 7)
        else:
            tol = (1e-5 if i == 2 else 1e-6) * top
        np.testing.assert_allclose(t, j, atol=tol, rtol=0, err_msg=str(i))
    # the zero row's output and dx row are exactly zero
    assert not out[0][0].reshape(-1, 24)[0].any()


@pytest.mark.parametrize("int8", [False, True])
def test_lm_logits_matches_jax(int8):
    x, w, dy = _np((2, 5, 32), 3), _np((40, 32), 4, 0.1), _np((2, 5, 40), 5)
    out = _vjp_both(lambda a, b: jit8.lm_logits(a, b, int8),
                    lambda a, b: tit8.lm_logits(a, b, int8), x, w, dy,
                    jnp.float32, torch.float32)
    for i, (t, j) in enumerate(out):
        np.testing.assert_allclose(t, j, atol=1e-5 * float(np.abs(j).max()),
                                   rtol=0, err_msg=str(i))
    assert tit8.maybe_switchback(True) is tit8.switchback_matmul
    assert tit8.maybe_switchback(False) is torch.matmul


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close_leaf(a, b, name, l2=GRAD_L2, top=GRAD_MAX):
    d = a - b
    assert np.linalg.norm(d) <= l2 * max(np.linalg.norm(b), 1e-12), name
    assert np.abs(d).max() <= top * max(np.abs(b).max(), 1e-12), name


@pytest.fixture(scope="module")
def flax_params():
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(0), batch_size=2,
                                     seq_len=64))


def _ids(seed, rows=2):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (rows, 64)).astype(np.int32)


@pytest.mark.parametrize("flash,remat", [(True, True), (False, False)])
def test_int8_gpt2_loss_and_grads_match_jax(flax_params, flash, remat):
    kw = dict(**TINY, int8_training=True, remat=remat,
              use_flash_attention=flash)
    ids = _ids(1)
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**kw,
                                                      dtype=jnp.float32))
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        flax_params, {"input_ids": jnp.asarray(ids)})
    jgrads = _flatten(jax.device_get(jgrads))
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**kw,
                                                       dtype=torch.float32))
    assert model.module.h_0.mlp.c_fc.matmul is tit8.switchback_matmul
    params = {k: v.requires_grad_() for k, v in
              gpt2_params_from_flax(flax_params).items()}
    loss = model.loss_fn(params, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(jgrads) == set(params)
    for name, g in zip(params, grads):
        _close_leaf(g.numpy(), jgrads[name], name)
    # int8 changes the function: the loss differs from the plain model's
    plain = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **{**kw, "int8_training": False}, dtype=torch.float32))
    assert plain.loss_fn(params, {"input_ids": torch.from_numpy(ids)}
                         ).item() != loss.item()


def test_int8_trajectory_matches_jax(flax_params):
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.01}}}
    kw = dict(**TINY, int8_training=True)
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**kw,
                                                      dtype=jnp.float32))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=flax_params, config=dict(conf),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    tmodel = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**kw,
                                                        dtype=torch.float32))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, model_parameters=gpt2_params_from_flax(flax_params),
        config=dict(conf), device="cpu")
    for s in range(3):
        b = {"input_ids": _ids(10 + s)}
        j = jeng.train_batch({"input_ids": jnp.asarray(b["input_ids"])})
        t = teng.train_batch(b)
        # the first step starts from the same weights; after it the
        # masters part by the flips' reach into Adam's updates
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]),
                                   rtol=1e-5 if s == 0 else 1e-3)
        np.testing.assert_allclose(float(t["grad_norm"]),
                                   float(j["grad_norm"]),
                                   rtol=1e-3 if s == 0 else 5e-3)
    init = _flatten(flax_params)
    jm = _flatten(jeng.fp32_master_params())
    tm = _flatten(gpt2_params_to_numpy(teng.fp32_master_params()))
    assert set(jm) == set(tm) == set(init)
    for k in jm:
        a, b = tm[k] - init[k], jm[k] - init[k]
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b), k
        assert np.abs(a - b).max() <= 6 * LR, k
