"""The port's BERT training layer and pre-training model against the JAX
package's on the CPU.

Weights are drawn with numpy into JAX's tree and carried across with
``bert_params_from_jax``; the same inputs go through both. Routing is
JAX's: with no mask and ``T <= 128 or T % 128 == 0`` the layer takes the
flash route, where JAX runs its Pallas kernel in interpret mode and the
port ``FlashAttentionFunction`` non-causal, which on a CPU tensor runs the
kernels' plain versions forward and backward; otherwise both take the
einsum route. Each case checks which route the port took.

Tolerances, in float32: outputs to 2e-5 absolute (activations ~1 after
the LayerNorms; the same function, summed in another order); losses to
1e-5 relative; every gradient (``jax.vjp`` against autograd) to 1e-4
relative to its largest element. The 3-step engine trajectory: losses and
gradient norms to 1e-5 relative, the final f32 master to ``lr / 10``
absolute (Adam divides each gradient element by its own running
magnitude, so last-bit differences of near-zero gradients reach the
update at up to ``lr`` scale; ``tests/test_torch_training.py`` says the
same of GPT-2), but the key third of each ``attn_qkvb``, whose exact
gradient is zero, only to Adam's bound.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.ops import transformer as jax_tf
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.module_inject.from_jax import bert_params_from_jax
from deepspeed_tpu_torch.ops import transformer as port_tf
from test_torch_llama import flat_specs
from test_torch_llama import xla_fast_compiles  # noqa: F401 (autouse)

E, H, FF = 64, 4, 128
OUT_TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TINY = dict(vocab_size=96, hidden_size=E, num_hidden_layers=2,
            num_attention_heads=H, intermediate_size=FF,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _flatten(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if hasattr(v, "items") or isinstance(v, list):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _draw(rng, tree):
    """numpy values in ``tree``'s shapes: matrices N(0, 1/fan_in), vectors
    (biases, norms) N(0, 0.1), norm scales around 1."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if len(s.shape) == 2:
            x = x / np.sqrt(s.shape[0])
        elif any(n in name for n in ("nw", "norm_w", "scale")):
            x = 1 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _layer_cfgs(**kw):
    kw = dict(dict(hidden_size=E, heads=H, intermediate_size=FF,
                   attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0), **kw)
    return (jax_tf.DeepSpeedTransformerConfig(**kw),
            port_tf.DeepSpeedTransformerConfig(**kw))


def _layer_params(seed=0):
    jlayer = jax_tf.DeepSpeedTransformerLayer(_layer_cfgs()[0])
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0))
    return _draw(np.random.default_rng(seed), shapes)


class _Route:
    """Counts the port layer's calls into ``FlashAttentionFunction``."""

    def __enter__(self):
        real = port_tf.FlashAttentionFunction.apply
        self.calls = []

        def spy(q, k, v, causal, scale):
            self.calls.append(causal)
            return real(q, k, v, causal, scale)
        self._p = mock.patch.object(port_tf.FlashAttentionFunction, "apply",
                                    side_effect=spy)
        self._p.start()
        return self

    def __exit__(self, *exc):
        self._p.stop()


def _assert_close_tree(got, want, tol, what):
    for name in want:
        ref = np.asarray(want[name], np.float32)
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(np.asarray(got[name]) / scale,
                                   ref / scale, atol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre-ln", "post-ln"])
@pytest.mark.parametrize("T,masked,flash", [
    (128, False, True), (128, True, False), (200, False, False)],
    ids=["T128-flash", "T128-mask-einsum", "T200-einsum"])
def test_layer_matches_jax(pre_ln, T, masked, flash):
    """Output and ``jax.vjp`` gradients of x and of every weight."""
    jcfg, pcfg = _layer_cfgs(pre_layer_norm=pre_ln)
    params = _layer_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, T, E)).astype(np.float32)
    dy = rng.standard_normal((2, T, E)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, T), np.int32)
        mask[0, 100:] = 0
        mask[1, 37:] = 0
    jlayer = jax_tf.DeepSpeedTransformerLayer(jcfg)

    def jax_vjp(p, xx, m, d):
        y, vjp = jax.vjp(lambda p, xx: jlayer.apply(p, xx, attention_mask=m),
                         p, xx)
        return y, vjp(d)
    jy, (jgp, jgx) = jax.jit(jax_vjp)(
        params, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jnp.asarray(dy))

    player = port_tf.DeepSpeedTransformerLayer(pcfg)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in
          params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    with _Route() as route:
        y = player(tp, tx, attention_mask=None if mask is None
                   else torch.from_numpy(mask))
    assert route.calls == ([False] if flash else [])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=OUT_TOL)
    grads = torch.autograd.grad(y, [tx, *tp.values()],
                                torch.from_numpy(dy))
    _assert_close_tree({"x": grads[0].numpy()}, {"x": jgx}, GRAD_TOL, "dx")
    _assert_close_tree(
        {k: g.numpy() for k, g in zip(tp, grads[1:])},
        jax.device_get(jgp), GRAD_TOL, "dw")


def test_from_torch_layout_and_return_tuple():
    rng = np.random.default_rng(2)
    shapes = [(3 * E, E), (3 * E,), (E, E), (E,), (E,), (E,), (FF, E), (FF,),
              (E, FF), (E,), (E,), (E,)]
    # torch [out, in] weights at 1/sqrt(fan_in): activations ~1
    arrays = [(rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32)
              for s in shapes]
    want = jax_tf.DeepSpeedTransformerLayer.from_torch_layout(*arrays)
    got = port_tf.DeepSpeedTransformerLayer.from_torch_layout(
        *[torch.from_numpy(a) for a in arrays])
    assert set(got) == set(want)
    for k in want:
        assert got[k].is_contiguous() and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jcfg, pcfg = _layer_cfgs(return_tuple=True)
    x = rng.standard_normal((1, 16, E)).astype(np.float32)
    (jy,) = jax.jit(jax_tf.DeepSpeedTransformerLayer(jcfg).apply)(
        want, jnp.asarray(x))
    out = port_tf.DeepSpeedTransformerLayer(pcfg).apply(
        got, torch.from_numpy(x))
    assert isinstance(out, tuple) and len(out) == 1
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jy), atol=OUT_TOL)


def _bert_cfgs(**kw):
    kw = {**TINY, **kw}
    return (jax_bert.BertConfig(**kw, dtype=jnp.float32),
            port_bert.BertConfig(**kw, dtype=torch.float32))


def _bert_params(jcfg, seed=0):
    shapes = jax.eval_shape(jax_bert.BertPreTrainingModel(
        jcfg)._build_params, jax.random.PRNGKey(0))
    return _draw(np.random.default_rng(seed), shapes)


def _bert_batch(seed, B=2, T=64, live=0.15, nsp=True, masked=False):
    rng = np.random.default_rng(seed)
    V = TINY["vocab_size"]
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) > live] = -100
    b = {"input_ids": rng.integers(0, V, (B, T)).astype(np.int32),
         "token_type_ids": (np.arange(T)[None] >= T // 2).repeat(B, 0
                                                                ).astype(
                                                                    np.int32),
         "mlm_labels": labels}
    if nsp:
        b["nsp_labels"] = rng.integers(0, 2, (B,)).astype(np.int32)
    if masked:
        m = np.ones((B, T), np.int32)
        m[:, T - 9:] = 0
        b["attention_mask"] = m
    return b


@pytest.mark.parametrize("nsp,masked,live,int8", [
    (True, False, 0.15, False), (False, True, 0.05, False),
    (True, True, 0.15, True)],
    ids=["mlm-nsp-flash", "mlm-only-mask-einsum", "mlm-nsp-mask-switchback"])
def test_pretraining_loss_and_grads_match_jax(nsp, masked, live, int8):
    """MLM over the live labels only (15% or 5% of the positions), plus
    NSP when the batch has ``nsp_labels``; the unmasked batch takes the
    layers' flash route, the masked ones their einsum route (JAX
    compiles its Pallas kernel in interpret mode for the flash route, the
    bulk of a case's time, so the SwitchBack case, whose int8 GEMMs are in
    the projections, takes the einsum route). With ``int8_training``
    (SwitchBack in every layer's projections and the MLM head) the loss
    is held to 1e-4 relative and the gradients to 2e-2
    relative L2 and 3e-2 of their largest element, as
    ``tests/test_torch_llama.py`` holds the SwitchBack LLaMA (an int8 code
    may flip on last-bit differences of f32 activations)."""
    jcfg, pcfg = _bert_cfgs(int8_training=int8)
    params = _bert_params(jcfg)
    batch = _bert_batch(3, live=live, nsp=nsp, masked=masked)
    jmodel = jax_bert.BertPreTrainingModel(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # compiled once: the batch without live labels below has the same
    # shapes
    jfn = jax.jit(jax.value_and_grad(jmodel.loss_fn))
    jloss, jgrads = jfn(params, jbatch)
    tparams = {k: v.requires_grad_() for k, v in
               bert_params_from_jax(params).items()}
    with _Route() as route:
        loss = port_bert.BertPreTrainingModel(pcfg).loss_fn(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert route.calls == ([] if masked else [False, False])
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=1e-4 if int8 else LOSS_TOL)
    # without nsp_labels the pooler and NSP head get no gradient (JAX's
    # are zeros)
    grads = torch.autograd.grad(loss, list(tparams.values()),
                                allow_unused=True)
    jflat = _flatten(jax.device_get(jgrads))
    assert set(jflat) == set(tparams)
    assert all((g is None) == (not nsp and k.startswith(("pooler", "nsp")))
               for k, g in zip(tparams, grads))
    got = {k: np.zeros(p.shape) if g is None else g.numpy()
           for (k, p), g in zip(tparams.items(), grads)}
    _assert_close_tree(got, jflat, 3e-2 if int8 else GRAD_TOL, "grad")
    if int8:
        for k in jflat:
            rel = np.linalg.norm(got[k] - jflat[k]) / max(
                np.linalg.norm(jflat[k]), 1e-30)
            assert rel <= 2e-2, (k, rel)
    # with no live label the MLM mean is 0, as in JAX (a clamped count)
    none = dict(batch, mlm_labels=np.full_like(batch["mlm_labels"], -100))
    with torch.no_grad():
        got = port_bert.BertPreTrainingModel(pcfg).loss_fn(
            bert_params_from_jax(params),
            {k: torch.from_numpy(v) for k, v in none.items()}).item()
    want = float(jfn(params, {k: jnp.asarray(v)
                              for k, v in none.items()})[0])
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=1e-7)


def test_out_of_range_labels_are_masked():
    """An MLM label outside [0, V) (64 and -5 at V = 64) and an NSP label
    outside [0, 2) are masked out of their losses and clamped in the
    gather, as the GPT-2 and LLaMA losses treat labels: no index error
    (on the card a device-side assert), a finite loss equal to the loss
    of the same batch with those labels set to -100. In-range batches are
    held to JAX's loss by the test above, and the in-range NSP rows here
    to the mean NSP term of the rows that stay."""
    jcfg, pcfg = _bert_cfgs(vocab_size=64)
    params = bert_params_from_jax(_bert_params(jcfg))
    batch = _bert_batch(5, B=4, T=16, live=0.5)
    batch["input_ids"] %= 64
    batch["mlm_labels"] = np.where(batch["mlm_labels"] >= 64, 7,
                                   batch["mlm_labels"]).astype(np.int32)
    bad = dict(batch, mlm_labels=batch["mlm_labels"].copy(),
               nsp_labels=np.array([0, 2, 1, -1], np.int32))
    bad["mlm_labels"][0, 3] = 64
    bad["mlm_labels"][1, 5] = -5
    clean = dict(bad, mlm_labels=bad["mlm_labels"].copy(),
                 nsp_labels=np.array([0, -100, 1, -100], np.int32))
    clean["mlm_labels"][0, 3] = clean["mlm_labels"][1, 5] = -100
    model = port_bert.BertPreTrainingModel(pcfg)

    def loss(b, keep=None):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if keep is not None:
            b = {k: v[keep] for k, v in b.items()}
        with torch.no_grad():
            return model.loss_fn(params, b).item()
    got = loss(bad)
    assert np.isfinite(got)
    assert got == loss(clean)
    # the NSP term averages over the live rows only: rows 0 and 2 alone
    # give the same NSP term, so the gap between the two losses is the
    # MLM terms' gap
    mlm_only = {k: v for k, v in clean.items() if k != "nsp_labels"}
    nsp_term = got - loss(mlm_only)
    keep = torch.tensor([0, 2])
    np.testing.assert_allclose(
        nsp_term, loss(clean, keep) - loss(mlm_only, keep), rtol=1e-5)


def test_init_presets_counts_and_refusals():
    for name in jax_bert.PRESETS:
        jd = dataclasses.asdict(jax_bert.config_for(name))
        pd = dataclasses.asdict(port_bert.config_for(name))
        assert jd.pop("dtype") == jnp.bfloat16
        assert pd.pop("dtype") == torch.bfloat16
        assert jd == pd
    with pytest.raises(ValueError, match="unknown preset"):
        port_bert.config_for("bert-huge")
    # bert-large's count, and a 2-layer tree's names, shapes and dtypes,
    # against JAX's abstract init
    def jax_shapes(cfg):
        return jax.eval_shape(jax_bert.BertPreTrainingModel(
            cfg)._build_params, jax.random.PRNGKey(0))
    assert sum(s.size for s in jax.tree.leaves(jax_shapes(
        jax_bert.config_for("bert-large")))) == 336226108
    small = dict(num_hidden_layers=2, max_position_embeddings=64,
                 vocab_size=1000)
    model = port_bert.BertPreTrainingModel(port_bert.config_for(
        "bert-base", **small))
    params = model.init(torch.Generator().manual_seed(0))
    jsmall = jax_shapes(jax_bert.config_for("bert-base", **small))
    jflat = dict(zip(_flatten(jax.tree.map(lambda s: np.empty(0), jsmall)),
                     jax.tree.leaves(jsmall)))
    assert set(params) == set(jflat)
    for k, s in jflat.items():
        assert tuple(params[k].shape) == s.shape, k
        assert str(params[k].dtype) == f"torch.{s.dtype}", k
    assert params["wte"].float().std().item() == pytest.approx(0.02,
                                                               rel=0.05)
    out_std = 0.02 / np.sqrt(4)
    assert params["layers.1.output_w"].float().std().item() == \
        pytest.approx(out_std, rel=0.05)
    assert not params["layers.0.attn_qkvb"].any()
    assert torch.equal(params["layers.0.norm_w"].float(), torch.ones(768))
    assert model.param_count(params) == sum(s.size for s in jflat.values())
    for name in jax_bert.PRESETS:
        assert port_bert.BertPreTrainingModel(port_bert.config_for(
            name)).flops_per_token() == jax_bert.BertPreTrainingModel(
                jax_bert.config_for(name)).flops_per_token()
    # tp_specs: JAX's entries, by the port's flat names, one a leaf
    specs = {k: tuple(v) for k, v in model.tp_specs().items()}
    assert specs == flat_specs(jax_bert.BertPreTrainingModel(
        jax_bert.config_for("bert-base", **small)).tp_specs())
    assert set(specs) == set(params)


def test_dropout_is_refused_where_it_would_apply():
    """Dropout (A9): refused when it would really be applied (training,
    a rate above 0 and an rng); never applied with rng=None, as the
    engine calls loss_fn, or deterministic."""
    _, pcfg = _layer_cfgs(attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1)
    layer = port_tf.DeepSpeedTransformerLayer(pcfg)
    params = {k: torch.from_numpy(v) for k, v in _layer_params().items()}
    x = torch.randn(1, 16, E)
    with pytest.raises(NotImplementedError, match="queue C, A9"):
        layer(params, x, rng=torch.Generator())
    with pytest.raises(NotImplementedError, match="queue C, A9"):
        port_tf.DeepSpeedTransformerLayer(dataclasses.replace(
            pcfg, attn_dropout_ratio=0.0))(params, x, rng=torch.Generator())
    a = layer(params, x)
    b = layer(params, x, rng=torch.Generator(), deterministic=True)
    assert torch.equal(a, b)
    _, bcfg = _bert_cfgs(hidden_dropout_prob=0.1)
    bparams = bert_params_from_jax(_bert_params(_bert_cfgs()[0]))
    batch = {k: torch.from_numpy(v) for k, v in _bert_batch(4).items()}
    with pytest.raises(NotImplementedError, match="queue C, A9"):
        port_bert.BertPreTrainingModel(bcfg).loss_fn(bparams, batch,
                                                     rng=torch.Generator())
    with torch.no_grad():
        a = port_bert.BertPreTrainingModel(bcfg).loss_fn(bparams, batch)
        b = port_bert.BertPreTrainingModel(bcfg, train=False).loss_fn(
            bparams, batch, rng=torch.Generator())
    assert torch.equal(a, b)


def test_engine_trajectory_matches_jax():
    """3 ``train_batch`` steps (AdamW, WarmupLR, clipping, gas 2, f32,
    dropout 0) from the same weights and batches; the JAX engine on a
    one-device mesh threads an rng into loss_fn, which dropout ratios of
    0 leave unused. The batches carry a key padding mask, so both take
    the einsum route: the flash route is held by the tests above, and
    JAX's engine would compile its Pallas kernels in interpret mode."""
    lr = 1e-3
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "gradient_clipping": 0.5,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": lr, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0.0,
                                    "warmup_max_lr": lr,
                                    "warmup_num_steps": 2,
                                    "warmup_type": "linear"}}}
    jcfg, pcfg = _bert_cfgs()
    params = _bert_params(jcfg, seed=5)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jax_bert.BertPreTrainingModel(jcfg), model_parameters=params,
        config=dict(cfg),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=port_bert.BertPreTrainingModel(pcfg),
        model_parameters=bert_params_from_jax(params), config=dict(cfg),
        device="cpu")
    losses = []
    for step in range(3):
        b = _bert_batch(10 + step, B=4, masked=True)
        j = jeng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        t = teng.train_batch(b)
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]),
                                   float(j["grad_norm"]), rtol=LOSS_TOL)
        losses.append(float(t["loss"]))
    assert all(np.isfinite(losses))
    init = _flatten(params)
    jm = _flatten(jax.device_get(jeng.fp32_master_params()))
    tm = {k: v.detach().numpy() for k, v in teng.fp32_master_params().items()}
    assert set(jm) == set(tm)
    for k in jm:
        if k.endswith("attn_qkvb"):
            # the key third's exact gradient is zero (a bias on every key
            # shifts a row's scores by one constant): both engines move it
            # from rounding noise, held to Adam's bound (warm-up lrs 0,
            # lr/2, lr: at most 1.5 lr)
            assert np.abs(tm[k] - init[k])[E:2 * E].max() <= 1.5 * lr * 1.01
            tm[k], jm[k] = (np.delete(x, np.s_[E:2 * E])
                            for x in (tm[k], jm[k]))
        np.testing.assert_allclose(tm[k], jm[k], atol=lr / 10, err_msg=k)


def test_bf16_pooler_and_nsp_step_one_agree_with_jax():
    """ROADMAP.md D4, by design: in bf16 on the tiny BERT of
    ``tests/test_torch_tp_training.py`` (one micro-batch of 2 rows of 32
    masked tokens, NSP) the NSP head's forward (the pooler's
    pre-activation, the pooled output, the logits) and the gradients of
    ``nsp.w`` and ``nsp.b`` equal JAX's bit for bit, given the same
    encoder output. The pooler's gradients differ only through ``tanh``'s
    backward: XLA rounds ``t = g * (1 - y)``, ``t * y`` and ``t + t * y``
    each in bf16 (that sequence, run in torch, gives JAX's bits exactly),
    where torch's ``tanh_backward`` rounds ``g * (1 - y * y)`` once. The
    pooler's gradients are pinned at under 1e-2 relative L2 from JAX's
    (0.49% and 0.41% measured); Adam's normalisation of a leaf that sees
    one position of 4 rows grows that over 3 steps."""
    jm = jax_bert.BertPreTrainingModel(jax_bert.BertConfig(
        **TINY, dtype=jnp.bfloat16))
    tree = jax.device_get(_draw(np.random.default_rng(5), jax.eval_shape(
        jm._build_params, jax.random.PRNGKey(0))))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    tp = {k: v.float().to(torch.bfloat16) for k, v in
          bert_params_from_jax(tree).items()}
    b = _bert_batch(10, B=2, T=32, masked=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    x0 = jm.encode(jp, jb["input_ids"], jb["attention_mask"],
                   jb["token_type_ids"], deterministic=True)[:, 0]

    def jhead(pw, pb, nw, nb, x0):
        pre = x0 @ pw + pb
        pooled = jnp.tanh(pre)
        lg = (pooled @ nw.astype(pooled.dtype)).astype(jnp.float32) + nb
        ll = jnp.take_along_axis(jax.nn.log_softmax(lg, -1),
                                 jb["nsp_labels"][:, None], -1)[:, 0]
        return -jnp.mean(ll), (pre, pooled, lg)

    names = ("pooler.w", "pooler.b", "nsp.w", "nsp.b")
    (_, jfwd), jg = jax.value_and_grad(jhead, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jp["pooler"]["w"], jp["pooler"]["b"], jp["nsp"]["w"],
        jp["nsp"]["b"], x0)
    w = [tp[n].clone().requires_grad_(True) for n in names]
    xt = torch.tensor(np.asarray(x0, np.float32)).to(torch.bfloat16)
    pre = port_tf.matmul(xt, w[0]) + w[1]
    pre.retain_grad()
    pooled = torch.tanh(pre)
    pooled.retain_grad()
    lg = (pooled @ w[2].to(pooled.dtype)).float() + w[3]
    nsp = torch.as_tensor(b["nsp_labels"]).long()
    (-torch.log_softmax(lg, -1).gather(-1, nsp[:, None])[:, 0].mean()
     ).backward()
    f32 = lambda t: np.asarray(t, np.float32)   # noqa: E731
    for got, want in zip((pre, pooled, lg), jfwd):
        np.testing.assert_array_equal(f32(got.detach().float()), f32(want))
    for n, t, j in zip(names, w, jg):
        got, want = f32(t.grad.float()), f32(j)
        if n.startswith("nsp."):
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert 0 < rel < 1e-2, (n, rel)
    # XLA's rounding order, run in torch, is JAX's pooler gradient
    g, y = pooled.grad, pooled.detach()
    t = g * (1 - y)
    jdpre = jax.grad(lambda p: jhead(jp["pooler"]["w"], p, jp["nsp"]["w"],
                                     jp["nsp"]["b"], x0)[0])(
        jp["pooler"]["b"])
    np.testing.assert_array_equal(f32((t + t * y).sum(0).float()),
                                  f32(jdpre))
