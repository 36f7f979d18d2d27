"""Training on the tensor and seq axes: the port over gloo ranks against
the JAX engine on a host mesh of the same shape.

The port runs one process per rank (the rank programs are in the JAX-free
``tests/test_torch_tp_workers.py``: one spawn group of 2 ranks for every
tensor-2 and seq-2 case, one of 4 for data 2 x tensor 2). The JAX engine
runs on the host devices ``tests/conftest.py`` forces, with XLA's CPU
optimisations off for this module. Both start from the same numpy
weights of the tiny GPT-2, LLaMA (GQA) and BERT of their parity tests,
and take the same global batches (each data index its rows).

Tolerances are those of ``tests/test_torch_dist_parity.py``: fp32 losses
and gradient norms to 1e-5 relative and the final master to ``lr / 10``
absolute (the row-parallel products and the vocab-parallel loss sum the
same terms in another order than XLA's partitioned program); bf16 losses
to 1e-2 and each leaf's update to 0.1 relative L2. The whole tree
gathered from the shards before any step equals the input bit for bit:
the fused ``c_attn``/``attn_qkvw`` leaves are cut by q, k and v heads
and put back in JAX's layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import test_torch_dist_workers as W
import test_torch_tp_workers as TW
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu_torch.module_inject.from_jax import (
    bert_params_from_jax, gpt2_params_to_numpy, llama_params_from_flax)
from deepspeed_tpu_torch.parallel.tensor_parallel import TensorLayout
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from test_torch_bert import _bert_batch, _draw
from test_torch_dist_parity import assert_bf16, assert_fp32
from test_torch_llama import flat_specs, numpy_params

LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def xla_fast_compiles():
    """JAX's side compiled with XLA's CPU backend optimisations off: the
    same HLO, compiled in about half the time; its executables are
    dropped afterwards."""
    prev = jax.config._read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _flat(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if hasattr(v, "items") or isinstance(v, list):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmesh_mod.build_mesh(jmesh_mod.MeshConfig(**axes),
                                devices=jax.devices()[:n])


def _jax_model(kind, dtype=jnp.float32):
    if kind == "gpt2":
        return jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**W.TINY,
                                                       dtype=dtype))
    if kind == "llama":
        return jax_llama.LlamaLMModel(jax_llama.LlamaConfig(
            **TW.LLAMA, dtype=dtype, remat=False))
    return jax_bert.BertPreTrainingModel(jax_bert.BertConfig(**TW.BERT,
                                                             dtype=dtype))


def jax_train(kind, tree, ds, mesh, batches, dtype=jnp.float32):
    """The JAX engine's metrics and final f32 master (flat names)."""
    eng = deepspeed_tpu.initialize(model=_jax_model(kind, dtype),
                                   model_parameters=tree, config=dict(ds),
                                   mesh=mesh)[0]
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["master"] = _flat(jax.device_get(eng.fp32_master_params()))
    return out


def _ds(stage, precision=None, **mesh):
    ds = dict(W.BASE, zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": 1000},
        mesh=mesh)
    if precision:
        ds[precision] = {"enabled": True}
    return ds


def _trees():
    """JAX's tree and the port's flat numpy tree of each model."""
    g = W.numpy_gpt2_params()
    lt = numpy_params(jax_llama.LlamaConfig(**TW.LLAMA, dtype=jnp.float32))
    bt = _draw(np.random.default_rng(5), jax.eval_shape(
        _jax_model("bert")._build_params, jax.random.PRNGKey(0)))
    bt = jax.device_get(bt)
    return {"gpt2": (gpt2_params_to_numpy({k: torch.tensor(v)
                                           for k, v in g.items()}), g),
            "llama": (lt, {k: v.numpy() for k, v in
                           llama_params_from_flax(lt).items()}),
            "bert": (bt, {k: v.float().numpy() for k, v in
                          bert_params_from_jax(bt).items()})}


def _batches(kind, rows=4):
    if kind == "bert":
        return [_bert_batch(10 + s, B=rows, T=32, masked=True)
                for s in range(3)]
    return W.batches(3, rows)


# name: (model, ds, dtype, steps kwargs)
TWO = {
    "gpt2": ("gpt2", _ds(0, tensor=2), "float32"),
    "gpt2_bf16": ("gpt2", _ds(2, "bf16", tensor=2), "bfloat16"),
    "llama_bf16": ("llama", _ds(2, "bf16", tensor=2), "bfloat16"),
    "bert_bf16": ("bert", _ds(0, "bf16", tensor=2), "bfloat16"),
    "llama": ("llama", _ds(1, tensor=2), "float32"),
    "bert": ("bert", _ds(0, tensor=2), "float32"),
    "gpt2_seq": ("gpt2", _ds(0, seq=2), "float32"),
    "llama_seq": ("llama", _ds(0, seq=2), "float32"),
    "bert_seq": ("bert", _ds(0, seq=2), "float32"),
}
ONE = _ds(0)


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.fixture(scope="module")
def two(tmp_path_factory, trees):
    """Every 2-rank run, in one spawn group, and the 1-rank runs of the
    checkpoint cases."""
    tmp = tmp_path_factory.mktemp("tp_train")
    runs = {name: dict(kind=k, params=trees[k][1], ds=ds,
                       batches=_batches(k), dtype=dt)
            for name, (k, ds, dt) in TWO.items()}
    gb = _batches("gpt2")
    g = trees["gpt2"][1]
    one_ck = str(tmp / "ck_t1")
    TW.train_case("gpt2", g, ONE, gb, steps=1, tag_dir=one_ck,
                  save_after=1)
    runs["ck_save"] = dict(kind="gpt2", params=g, ds=TWO["gpt2"][1],
                           batches=gb, steps=1, tag_dir="ck_t2",
                           save_after=1)
    runs["ck_load"] = dict(kind="gpt2", params=g, ds=TWO["gpt2"][1],
                           batches=gb, first=1, load=True, tag_dir=one_ck)
    ranks = W.run_ranks(TW.train_runs, 2, tmp, runs)
    resumed = TW.train_case("gpt2", g, ONE, gb, first=1, load=True,
                            tag_dir=str(tmp / "train_runs_2" / "ck_t2"))
    one = TW.train_case("gpt2", g, ONE, gb)
    return {"ranks": ranks, "resumed": resumed, "one": one}


@pytest.mark.parametrize("name", ["gpt2", "llama", "bert", "gpt2_seq",
                                  "llama_seq", "bert_seq"])
def test_fp32_trajectory_matches_jax(two, trees, name):
    kind, ds, _ = TWO[name]
    mesh = ds["mesh"]
    ref = jax_train(kind, trees[kind][0], ds, jmesh(data=1, **mesh),
                    _batches(kind))
    for rank in two["ranks"]:
        got = rank[name]
        assert got["mesh"] == mesh
        assert_fp32(got, ref)
        # gathered from the shards before any step: the input exactly
        for k, v in trees[kind][1].items():
            np.testing.assert_array_equal(got["init"][k], v, err_msg=k)
    # under tensor each rank holds half of a column-parallel leaf
    local = two["ranks"][0][name]["local"]
    if kind == "gpt2" and "tensor" in mesh:
        assert local["h_0.attn.c_attn.kernel"] == (64, 96)
        assert local["wte"] == (64, 64)   # 128 padded rows over 2
    if kind == "llama" and "tensor" in mesh:
        assert local["layers_0.attn.wk.kernel"] == (64, 16)   # 1 kv head
    if kind == "bert" and "tensor" in mesh:
        assert local["layers.0.attn_qkvw"] == (64, 96)


@pytest.mark.parametrize("name", ["gpt2_bf16", "llama_bf16", "bert_bf16"])
def test_bf16_trajectory_matches_jax(two, trees, name):
    """bf16 at tensor 2 against JAX's engine on the same mesh. BERT's
    pooler and NSP head part from JAX's in bf16 on one process already
    (their 3-step updates 0.09-0.41 relative L2 apart; ROADMAP.md D4):
    they are held to Adam's bound, every other leaf to the tolerance."""
    kind, ds, _ = TWO[name]
    ref = jax_train(kind, trees[kind][0], ds, jmesh(data=1, tensor=2),
                    _batches(kind), jnp.bfloat16)
    init = trees[kind][1]
    for rank in two["ranks"]:
        got = rank[name]
        if kind == "bert":
            got, want = (dict(x, master=dict(x["master"]))
                         for x in (got, ref))
            start = dict(init)
            E = TW.BERT["hidden_size"]
            for k in list(start):
                moved = np.abs(got["master"][k] - start[k])
                if k.startswith(("pooler.", "nsp.")):
                    assert moved.max() <= 3 * LR + 1e-6, k
                    for x in (got["master"], want["master"], start):
                        del x[k]
                elif k.endswith("attn_qkvb"):
                    # the key third's exact gradient is zero, as GPT-2's
                    # c_attn.bias (assert_bf16): Adam's bound
                    assert moved[E:2 * E].max() <= 3 * LR + 1e-6, k
                    for x in (got["master"], want["master"], start):
                        x[k] = np.delete(x[k], np.s_[E:2 * E])
            assert_bf16(got, want, start)
        else:
            assert_bf16(got, ref, init)


def test_tensor_ranks_agree_and_equal_one_process(two):
    """Both ranks report the same numbers; the tensor-2 run equals the
    one-process run to the fp32 tolerances."""
    r0, r1 = (r["gpt2"] for r in two["ranks"])
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    for k in r0["master"]:
        np.testing.assert_array_equal(r0["master"][k], r1["master"][k])
    assert_fp32(r0, two["one"])


def test_checkpoint_tensor2_resumes_at_tensor1(two):
    ref = two["ranks"][0]["gpt2"]
    assert_fp32(two["resumed"], ref, n=2)


def test_checkpoint_tensor1_resumes_at_tensor2(two):
    ref = two["one"]
    for rank in two["ranks"]:
        assert_fp32(rank["ck_load"], ref, n=2)


def test_data2_by_tensor2_zero3_matches_jax(tmp_path, trees):
    ds = _ds(3, data=2, tensor=2)
    gb = W.batches(3, 8)
    # stage 3's per-layer fetch (GPT-2's offload_params hook) and the
    # whole-tree gather
    ranks = W.run_ranks(TW.train_runs, 4, tmp_path, {
        f"z3_{fetch}": dict(kind="gpt2", params=trees["gpt2"][1], ds=ds,
                            batches=gb, model_kw={"offload_params": fetch})
        for fetch in (True, False)})
    ref = jax_train("gpt2", trees["gpt2"][0], ds, jmesh(data=2, tensor=2),
                    gb)
    for rank in ranks:
        for fetch in (True, False):
            assert rank[f"z3_{fetch}"]["mesh"] == {"data": 2, "tensor": 2}
            assert_fp32(rank[f"z3_{fetch}"], ref)


def test_tp_specs_and_policy_equal_jax():
    """The models' ``tp_specs`` are JAX's entry for entry, and the ZeRO
    policy composed on them places every leaf as JAX's does on a data 2
    x tensor 2 mesh. (BERT's JAX specs hold its layers in a list, which
    JAX's policy does not descend into: it is given them, as the shapes,
    keyed by index, so that the rule itself is compared.)"""
    jm = jmesh(data=2, tensor=2)
    for kind in ("gpt2", "llama", "bert"):
        port = TW.train_model(kind)
        jspecs = _jax_model(kind).tp_specs()
        specs = port.tp_specs()
        assert {k: tuple(v) for k, v in specs.items()} == \
            flat_specs(jspecs), kind
        shapes = {n: tuple(p.shape) for n, p in
                  port.init(torch.Generator().manual_seed(0)).items()}
        assert set(shapes) == set(specs)
        nest = jax.eval_shape(lambda: jax.tree.map(
            lambda s: jnp.zeros(s), _nest(shapes),
            is_leaf=lambda x: isinstance(x, tuple)))
        jspecs = _nest({k: jax.sharding.PartitionSpec(*v)
                        for k, v in flat_specs(jspecs).items()})
        for stage in (1, 2, 3):
            tp = tpart.ZeroShardingPolicy(stage, {"data": 2, "tensor": 2},
                                          tp_specs=specs,
                                          param_persistence_threshold=0)
            jp = jpart.ZeroShardingPolicy(stage, jm, tp_specs=jspecs)
            for place in ("param_sharding", "grad_sharding",
                          "master_sharding"):
                ref = {k: tuple(v.spec) for k, v in _flat_shardings(
                    getattr(jp, place)(nest)).items()}
                got = {k: tuple(v) for k, v in
                       getattr(tp, place)(shapes).items()}
                assert got == ref, (kind, stage, place)


def _nest(shapes):
    tree = {}
    for name, shape in shapes.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = shape
    return tree


def _flat_shardings(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_shardings(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_fused_qkv_shards_are_heads_and_gather_to_jax():
    """A rank's ``c_attn`` holds its heads of q, of k and of v; the shards
    put back together are JAX's leaf bit for bit."""
    full = torch.arange(64 * 192, dtype=torch.float32).reshape(64, 192)
    layout = TensorLayout({"c": (None, "tensor")}, {"c": (64, 192)},
                          {"c": 3}, size=2, rank=0)
    shards = [TensorLayout({"c": (None, "tensor")}, {"c": (64, 192)},
                           {"c": 3}, size=2, rank=r).shard("c", full)
              for r in range(2)]
    for r, s in enumerate(shards):
        assert s.shape == (64, 96)
        for part in range(3):   # q, k, v: this rank's 32 columns of each
            np.testing.assert_array_equal(
                s[:, part * 32:(part + 1) * 32],
                full[:, part * 64 + r * 32:part * 64 + (r + 1) * 32])
    # the gather's layout, without a group: [parts, ranks, n] -> columns
    g = torch.stack([s.unflatten(1, (3, 32)) for s in shards], 2)
    np.testing.assert_array_equal(g.flatten(1, 3), full)
    assert layout.local_shape("c", (64, 192)) == (64, 96)
    with pytest.raises(ValueError, match="evenly"):
        TensorLayout({"c": (None, "tensor")}, {"c": (64, 190)}, {"c": 3},
                     size=2, rank=0)


def test_vocab_parallel_loss_matches_plain(tmp_path):
    """Labels in the other rank's columns and out of range (clamped and
    masked, the port's rule): the loss and the logits' gradient of the
    plain loss."""
    rng = np.random.default_rng(0)
    V = 16
    logits = rng.standard_normal((3, 5, V)).astype(np.float32) * 3
    labels = rng.integers(0, V - 3, (3, 5))
    labels[0, :3] = [1, V - 4, V + 5]   # rank 0's, rank 1's, out of range
    labels[1, 0] = -100
    x = torch.tensor(logits, requires_grad=True)
    y = torch.tensor(labels)
    lse = torch.logsumexp(x, -1)
    gold = x.gather(-1, y.clamp(0, V - 1)[..., None])[..., 0]
    mask = (y >= 0) & (y < V - 3)
    want = ((lse - gold) * mask).sum() / mask.sum()
    want.backward()
    ranks = W.run_ranks(TW.loss_program, 2, tmp_path, logits, labels)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], float(want.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            got["grad"], x.grad.numpy()[..., r * 8:(r + 1) * 8],
            rtol=1e-5, atol=1e-7)
