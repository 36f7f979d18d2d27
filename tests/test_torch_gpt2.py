"""The port's training GPT-2 against the JAX package's flax model on the
CPU: weights from ``GPT2LMModel.init`` carried across with
``gpt2_params_from_flax``, then the loss and every gradient leaf of the
port (autograd) against ``jax.value_and_grad(model.loss_fn)``.

Tolerance in float32: the loss to 1e-5 relative; each gradient leaf to
1e-4 relative to its largest element (both sides are f32 end to end; the
matrix products and reductions sum in another order, and the attention
softmax is computed whole-row on one side and through the einsum oracle on
the other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.module_inject.from_jax import (gpt2_params_from_flax,
                                                        gpt2_params_to_numpy)

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_params():
    model = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                     dtype=jnp.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(0), batch_size=2,
                                     seq_len=64))


def _ids(seed=0, B=2, T=64):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                                (B, T)).astype(np.int32)


@pytest.mark.parametrize("flash,remat", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_loss_and_grads_match_jax(jax_params, flash, remat):
    ids = _ids()
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(
        **TINY, dtype=jnp.float32, remat=remat, use_flash_attention=flash))
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jax_params, {"input_ids": jnp.asarray(ids)})
    jgrads = _flatten(jax.device_get(jgrads))

    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **TINY, dtype=torch.float32, remat=remat, use_flash_attention=flash))
    params = {k: v.requires_grad_() for k, v in
              gpt2_params_from_flax(jax_params).items()}
    loss = model.loss_fn(params, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    assert set(jgrads) == set(params)
    for (name, _), g in zip(params.items(), grads):
        ref = jgrads[name]
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, ref / scale,
                                   atol=GRAD_TOL, err_msg=name)


def test_bf16_forward_matches_jax(jax_params):
    """bf16 compute on both sides: the loss to 2e-2 (activations and
    logits are rounded to bf16 at different places: torch rounds a GELU
    or LayerNorm once from f32, XLA may round inside them)."""
    ids = _ids(1)
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jax_params)
    jloss = float(jmodel.loss_fn(jp, {"input_ids": jnp.asarray(ids)}))
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    params = gpt2_params_from_flax(jax_params, dtype=torch.bfloat16)
    with torch.no_grad():
        loss = model.loss_fn(params, {"input_ids": torch.from_numpy(ids)})
    assert abs(loss.item() - jloss) <= 2e-2 * abs(jloss)


def test_labels_and_padding_mask(jax_params):
    """Explicit labels; labels outside [0, vocab_size) (an ignore index,
    a padded-vocabulary id) are masked out of the mean, as in JAX."""
    ids = _ids(2)
    labels = _ids(3)
    labels[0, :5] = -100
    labels[1, 7] = 100   # in the padded columns, past vocab_size
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**TINY,
                                                      dtype=jnp.float32))
    jloss = float(jmodel.loss_fn(jax_params, {
        "input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}))
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY,
                                                       dtype=torch.float32))
    with torch.no_grad():
        loss = model.loss_fn(gpt2_params_from_flax(jax_params), {
            "input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL)


def test_init_matches_flax_names_shapes_and_distributions(jax_params):
    cfg = port_gpt2.config_for("gpt2-125m", n_layer=2)
    model = port_gpt2.GPT2LMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    jmodel = jax_gpt2.GPT2LMModel(jax_gpt2.config_for("gpt2-125m",
                                                      n_layer=2))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jflat = {k: v.shape for k, v in _flatten(jax.tree.map(
        lambda s: np.zeros((0,)), shapes)).items()}
    assert set(jflat) == set(params)
    for name, s in _flatten(jax.tree.map(
            lambda s: np.empty(s.shape, np.int8), shapes)).items():
        assert tuple(params[name].shape) == s.shape, name
        assert params[name].dtype == torch.float32
    assert params["wte"].std().item() == pytest.approx(0.02, rel=0.02)
    assert params["wpe"].std().item() == pytest.approx(0.01, rel=0.02)
    k = params["h_0.mlp.c_fc.kernel"]
    assert k.std().item() == pytest.approx(768 ** -0.5, rel=0.02)
    assert k.abs().max().item() <= 2 * 768 ** -0.5 / 0.8796 + 1e-6
    assert torch.equal(params["h_1.ln_2.scale"], torch.ones(768))
    assert not params["h_1.attn.c_proj.bias"].any()
    assert model.param_count(params) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert model.flops_per_token() == jmodel.flops_per_token()
    # the preset of the chip run: 1,313,722,368 parameters
    big = port_gpt2.GPT2LMModel(port_gpt2.config_for("gpt2-1.3b"))
    assert sum(p.numel() for p in big.module.parameters()) == 1313722368


def test_params_round_trip(jax_params):
    back = gpt2_params_to_numpy(gpt2_params_from_flax(jax_params))
    flat_a, flat_b = _flatten(jax_params), _flatten(back)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def test_queue_c_model_options_raise():
    for kw in ({"dropout": 0.1}, {"num_experts": 4},
               {"sequence_parallel": True}):
        with pytest.raises(NotImplementedError, match="queue C"):
            port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY, **kw))
    # offload_params is ported (ZeRO-3 parameter offload: the model
    # fetches its own layers; tests/test_torch_param_offload.py)
    assert port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **TINY, offload_params=True)).handles_param_offload
