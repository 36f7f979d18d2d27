"""The port's training LLaMA against the JAX package's flax model on the
CPU.

Weights are drawn with numpy into JAX's tree (shapes from
``jax.eval_shape``) and carried across with ``llama_params_from_flax``;
the same ids go through both models. JAX's ``causal_attention`` takes its
einsum reference on the CPU; the port's takes ``FlashAttentionFunction``,
which on a CPU tensor runs the kernels' plain versions (forward and
backward), with k/v unexpanded at ``n_kv_head < n_head``.

Tolerances, in float32: logits to 2e-5 absolute (values ~1; the same f32
function, summed in another order); the loss to 1e-5 relative; each
gradient leaf to 1e-4 relative to its largest element (the attention
softmax is computed whole-row through the kernels' plain version on one
side and through the einsum oracle on the other). SwitchBack (int8
training): the loss to 1e-4 relative, every gradient leaf within 2e-2
relative L2 and 3e-2 of its largest element. The two frameworks' f32
activations differ in their last bits, which can move an int8 code by one
step (1/127 of its row's amax) where a value sits on a rounding boundary
(``tests/test_torch_int8_training.py`` says the same of GPT-2). Here a
flip lands in the forward as well: the loss moves by 3e-5 relative and the
first block's gradients and the embeddings' by up to 1.9e-2 of their
largest element (1.4e-2 relative L2); on draws without a flip all agree
to 3e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.module_inject.from_jax import llama_params_from_flax

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            n_kv_head=2, intermediate_size=96)
T = 32
LOGIT_TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def xla_fast_compiles():
    """JAX's side compiled with XLA's CPU backend optimisations off (most
    of these tests' time is JAX compiling): the same HLO, compiled in
    about half the time. Its executables are dropped afterwards, so no
    other test module runs them."""
    prev = jax.config._read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(jcfg):
    model = jax_llama.LlamaLMModel(dataclasses.replace(
        jcfg, remat=False, use_flash_attention=False))
    # the flax module's own init: ``LlamaLMModel.init`` compiles even
    # under eval_shape
    return jax.eval_shape(model.module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]


def numpy_params(jcfg, seed=0):
    """JAX's tree for ``jcfg`` drawn with numpy: kernels N(0, 1/fan_in),
    tables N(0, 0.02), norms 1 + N(0, 0.1) (so their gradients and the
    weights' placement both show)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        if "embed" in name or "lm_head" in name:
            return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
        return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, _shapes(jcfg))


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_llama.LlamaConfig(**kw, dtype=jnp.float32),
            port_llama.LlamaConfig(**kw, dtype=torch.float32))


def _ids(seed=0, B=2, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def test_presets_and_validation_errors_match_jax():
    assert set(port_llama.PRESETS) == set(jax_llama.PRESETS)
    for name in jax_llama.PRESETS:
        j, p = jax_llama.config_for(name), port_llama.config_for(name)
        jd, pd = dataclasses.asdict(j), dataclasses.asdict(p)
        assert jd.pop("dtype") == jnp.bfloat16
        assert pd.pop("dtype") == torch.bfloat16
        assert jd == pd, name
        assert p.head_dim == j.head_dim and p.moe_layer_set == j.moe_layer_set
    bad = [("config_for", ("llama-99t",), {}),
           ("LlamaConfig", (), dict(n_head=6, n_kv_head=4)),
           ("LlamaConfig", (), dict(sp_mode="tree")),
           ("LlamaConfig", (), dict(num_experts=4, moe_layers=())),
           ("LlamaConfig", (), dict(n_layer=2, num_experts=4,
                                    moe_layers=(0, 5)))]
    for fn, args, kw in bad:
        with pytest.raises(ValueError) as je:
            getattr(jax_llama, fn)(*args, **kw)
        with pytest.raises(ValueError) as pe:
            getattr(port_llama, fn)(*args, **kw)
        assert str(pe.value) == str(je.value)


def test_param_counts_of_every_preset_match_jax_eval_shape():
    """Names and shapes of every leaf from the port's meta module against
    JAX's abstract init at one layer (tracing flax at full depth takes
    ~1 s a layer), and each preset's full-depth count against JAX's
    one-layer count plus ``n_layer - 1`` times its layer's; no weights are
    made on either side."""
    for name, preset in jax_llama.PRESETS.items():
        if preset.get("num_experts", 0):
            continue    # the port refuses MoE models (A8)
        jflat = _flatten(jax.tree.map(
            lambda s: np.empty(s.shape, np.int8),
            _shapes(jax_llama.config_for(name, n_layer=1))))
        module = port_llama.LlamaLMModel(port_llama.config_for(
            name, n_layer=1)).module
        assert {k: tuple(p.shape) for k, p in module.named_parameters()} \
            == {k: v.shape for k, v in jflat.items()}, name
        layer = sum(v.size for k, v in jflat.items()
                    if k.startswith("layers_0."))
        full = port_llama.LlamaLMModel(port_llama.config_for(name)).module
        assert sum(p.numel() for p in full.parameters()) == sum(
            v.size for v in jflat.values()) + (preset["n_layer"] - 1) * layer
    counts = {name: sum(p.numel() for p in port_llama.LlamaLMModel(
        port_llama.config_for(name, **kw)).module.parameters())
        for name, kw in (("llama-1b", {}), ("llama-7b-gqa", {"n_layer": 8}))}
    # the chip run's two configurations
    assert counts == {"llama-1b": 940640256, "llama-7b-gqa": 2007044096}


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_logits_match_jax(kv):
    """The ``llama-tiny`` preset (4 heads over 2 KV heads; 4 for MHA)."""
    jcfg = jax_llama.config_for("llama-tiny", n_kv_head=kv,
                                dtype=jnp.float32)
    pcfg = port_llama.config_for("llama-tiny", n_kv_head=kv,
                                 dtype=torch.float32)
    params = numpy_params(jcfg)
    ids = _ids(vocab=jcfg.vocab_size)
    want = np.asarray(jax.jit(jax_llama.LlamaLMModel(jcfg).apply)(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        got = port_llama.LlamaLMModel(pcfg).apply(
            llama_params_from_flax(params), torch.from_numpy(ids))
    assert got.shape == (2, T, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(jcfg, seed):
    """JAX's loss and gradients on ``numpy_params(jcfg, seed)`` and
    ``_ids(seed)``, compiled once a config: remat and the attention
    flag change no number of JAX's on the CPU (both take the einsum
    reference there), so they are off."""
    jmodel = jax_llama.LlamaLMModel(dataclasses.replace(
        jcfg, remat=False, use_flash_attention=False))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        numpy_params(jcfg, seed), {"input_ids": jnp.asarray(_ids(seed))})
    return float(jloss), _flatten(jax.device_get(jgrads))


def _loss_and_grads(jcfg, pcfg, seed):
    params = numpy_params(jcfg, seed)
    jloss, jgrads = _jax_loss_and_grads(
        dataclasses.replace(jcfg, remat=False, use_flash_attention=False),
        seed)
    batch = {"input_ids": _ids(seed)}
    tparams = {k: v.requires_grad_() for k, v in
               llama_params_from_flax(params).items()}
    loss = port_llama.LlamaLMModel(pcfg).loss_fn(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(tparams, torch.autograd.grad(loss,
                                                  list(tparams.values()))))
    assert set(jgrads) == set(grads)
    return jloss, jgrads, loss.item(), grads


def _assert_grads(jgrads, grads, tol):
    for name, g in grads.items():
        ref = jgrads[name]
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("kv,flash,remat,tied", [
    (4, True, True, False), (2, True, True, False), (2, False, False, False),
    (2, True, False, True)], ids=["mha", "gqa", "gqa-plain", "gqa-tied"])
def test_loss_and_grads_match_jax(kv, flash, remat, tied):
    """Every gradient leaf, through the kernels' plain versions under the
    whole-block remat (``flash``) or the einsum oracle; tied embeddings
    share one table, whose gradient sums both uses."""
    jcfg, pcfg = _cfgs(n_kv_head=kv, use_flash_attention=flash, remat=remat,
                       tie_embeddings=tied)
    jloss, jgrads, loss, grads = _loss_and_grads(jcfg, pcfg, seed=1)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)
    _assert_grads(jgrads, grads, GRAD_TOL)
    assert ("lm_head" in grads) is not tied


def test_switchback_loss_and_grads_match_jax():
    jcfg, pcfg = _cfgs(int8_training=True)
    jloss, jgrads, loss, grads = _loss_and_grads(jcfg, pcfg, seed=2)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for name, g in grads.items():
        ref = jgrads[name]
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 2e-2, (name, rel)
        _assert_grads({name: ref}, {name: g}, 3e-2)


def test_labels_outside_the_vocabulary_are_masked():
    """Explicit labels: an ignore index and a label past the vocabulary
    are masked out of the mean, as in JAX (the port clamps its gather, so
    its loss stays finite for any label: ROADMAP.md D)."""
    jcfg, pcfg = _cfgs()
    params = numpy_params(jcfg, seed=3)
    ids, labels = _ids(3), _ids(4)
    labels[0, :5] = -100
    labels[1, 7] = 1000
    with torch.no_grad():
        loss = port_llama.LlamaLMModel(pcfg).loss_fn(
            llama_params_from_flax(params),
            {"input_ids": torch.from_numpy(ids),
             "labels": torch.from_numpy(labels)}).item()
    jloss = float(jax.jit(jax_llama.LlamaLMModel(jcfg).loss_fn)(params, {
        "input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}))
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)


def test_flops_per_token_matches_jax():
    for name, preset in jax_llama.PRESETS.items():
        if preset.get("num_experts", 0):
            continue
        for tied in (False, True):
            j = jax_llama.LlamaLMModel(jax_llama.config_for(
                name, tie_embeddings=tied))
            p = port_llama.LlamaLMModel(port_llama.config_for(
                name, tie_embeddings=tied))
            assert p.flops_per_token() == j.flops_per_token(), name


def test_init_names_shapes_and_distributions():
    jcfg, pcfg = _cfgs(n_embd=256, intermediate_size=512)
    model = port_llama.LlamaLMModel(pcfg)
    params = model.init(torch.Generator().manual_seed(0))
    jflat = _flatten(jax.tree.map(lambda s: np.empty(s.shape, np.int8),
                                  _shapes(jcfg)))
    assert list(params) == [k for k, _ in model.module.named_parameters()]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in jflat.items()}
    assert all(p.dtype == torch.float32 for p in params.values())
    for name in ("embed", "lm_head"):
        assert params[name].std().item() == pytest.approx(0.02, rel=0.05)
    k = params["layers_0.mlp.up.kernel"]
    assert k.std().item() == pytest.approx(256 ** -0.5, rel=0.03)
    assert k.abs().max().item() <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert torch.equal(params["layers_1.ln_mlp"], torch.ones(256))
    assert torch.equal(params["ln_f"], torch.ones(256))
    assert model.param_count(params) == sum(v.size for v in jflat.values())


def test_params_from_hf_match_jax(monkeypatch):
    # transformers without its TensorFlow side, which it would otherwise
    # import with the model classes (most of this test's time)
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["n_embd"],
        intermediate_size=TINY["intermediate_size"], num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    sd = transformers.LlamaForCausalLM(hf_cfg).float().state_dict()
    jcfg, pcfg = _cfgs()
    want = _flatten(jax.device_get(jax_llama.params_from_hf(sd, jcfg)))
    got = port_llama.params_from_hf(sd, pcfg)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # numpy arrays work too; Mixtral's expert keys are refused (A8)
    got_np = port_llama.params_from_hf({k: v.numpy() for k, v in sd.items()},
                                       pcfg)
    assert all(torch.equal(got_np[k], got[k]) for k in got)
    sd["model.layers.0.block_sparse_moe.gate.weight"] = torch.zeros(4, 64)
    with pytest.raises(NotImplementedError, match="A8"):
        port_llama.params_from_hf(sd, pcfg)


def flat_specs(tree, prefix=""):
    """A JAX spec tree as ``{dotted path: tuple}`` (list items by
    index)."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return {prefix[:-1]: tuple(tree)}
    out = {}
    for k, v in (enumerate(tree) if isinstance(tree, list)
                 else tree.items()):
        out.update(flat_specs(v, f"{prefix}{k}."))
    return out


def test_queue_c_refusals_name_their_item():
    for kw, item in (({"num_experts": 4}, "A8"),
                     ({"sequence_parallel": True}, "A8")):
        with pytest.raises(NotImplementedError, match=f"queue C, {item}"):
            port_llama.LlamaLMModel(port_llama.LlamaConfig(**TINY, **kw))
    with pytest.raises(NotImplementedError, match="queue C, A8"):
        port_llama.LlamaLMModel(port_llama.config_for("mixtral-tiny"))
    # tp_specs are ported: JAX's entries, by the port's flat names
    for tie in (False, True):
        kw = dict(TINY, tie_embeddings=tie)
        model = port_llama.LlamaLMModel(port_llama.LlamaConfig(**kw))
        specs = {k: tuple(v) for k, v in model.tp_specs().items()}
        assert specs == flat_specs(jax_llama.LlamaLMModel(
            jax_llama.LlamaConfig(**kw)).tp_specs())
        assert set(specs) == set(model.init(torch.Generator()))
    # flash_block is accepted and changes nothing
    jcfg, pcfg = _cfgs()
    params = llama_params_from_flax(numpy_params(jcfg))
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        a = port_llama.LlamaLMModel(pcfg).apply(params, ids)
        b = port_llama.LlamaLMModel(dataclasses.replace(
            pcfg, flash_block=128)).apply(params, ids)
    assert torch.equal(a, b)
