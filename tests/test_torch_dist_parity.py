"""Several ranks of the port against the JAX package on the CPU.

The port runs one process per rank over gloo (the harness and the rank
programs are in the JAX-free ``tests/test_torch_dist_workers.py``; two
spawn groups here: 2 ranks and 4 ranks). The JAX package runs one
controller over a mesh of the same shape on the host devices
``tests/conftest.py`` forces, with XLA's CPU optimisations off for this
module (faster compiles). Both start from the same numpy weights of a tiny
GPT-2 (2 layers, n_embd 64, 4 heads, T = 16), and the JAX global batch is
the ranks' local batches concatenated in rank order. Tolerances, each
with its reason:

* collectives, the 1-bit exchange, ``zero.Init`` and ``materialize``:
  equal, or to 1e-6 where floats are summed (the same sums in another
  order); ``sparse_all_mean`` to 1e-6 (duplicate rows summed in another
  order).
* the engine in fp32 (AdamW, WarmupLR, clipping, gas 2): losses and
  gradient norms to 1e-5 relative, the final f32 master to ``lr / 10``
  absolute (JAX reshapes the global batch ``(gas, micro * dp)``, so the
  same mean gradient is summed in another order, and Adam divides each
  element by its own running magnitude: last-bit differences of
  near-zero elements reach the update at up to ``lr`` scale;
  tests/test_torch_training.py).
* bf16: losses to 1e-2 relative; each leaf's 3-step update of the f32
  master (final minus initial) to 0.1 relative L2 (activations and
  gradients are rounded to bf16 at other places in the two frameworks;
  tests/test_torch_training.py), except the key third of ``c_attn.bias``,
  whose exact gradient is zero (a bias on every key shifts a row's scores
  by one constant), held to Adam's bound.
* fp16 with a batch that overflows on one rank only: the skips, the
  skipped-step count and the loss-scale trajectory exactly; the loss of
  the steps taken to 1e-2.
* host offload (the C++ Adam): as bf16.
* a checkpoint saved at 2 ranks and resumed at 1, and the reverse: the
  uninterrupted 2-rank run to the fp32 tolerances.

JAX's ZeRO stages place the same arithmetic differently (its losses agree
to every printed digit across stages); it runs stages 0 and 3 in fp32 and
stage 3 in bf16 here, and the port's other stages (and its host offload,
bf16 stage 2) are held to its stage 3.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import test_torch_dist_workers as W
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.comm import mesh as jmesh_mod
from deepspeed_tpu.comm.compressed import compressed_allreduce as jcompressed
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime.sparse_tensor import sparse_all_mean as jsparse
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu.utils.init_on_device import materialize as jmaterialize
from deepspeed_tpu_torch.comm import mesh as tmesh
from deepspeed_tpu_torch.module_inject.from_jax import gpt2_params_to_numpy
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling

LR = 1e-3
DPX = ("data", "fsdp")


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


def jmesh(data, fsdp=1):
    return jmesh_mod.build_mesh(jmesh_mod.MeshConfig(data=data, fsdp=fsdp),
                                devices=jax.devices()[:data * fsdp])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _tree(params):
    return gpt2_params_to_numpy({k: torch.tensor(v)
                                 for k, v in params.items()})


def jax_run(ds, mesh, global_batches, dtype=jnp.float32, weights=False,
            model=None, params=None):
    """The JAX engine's metrics and final f32 master over the global
    batches."""
    params = W.numpy_gpt2_params() if params is None else params
    jm = model or jax_gpt2.GPT2LMModel(jax_gpt2.GPT2Config(**W.TINY,
                                                           dtype=dtype))
    loss_fn = None
    if weights:
        def loss_fn(p, b, rng=None):
            return jm.loss_fn(p, b, rng) * b["w"].mean()
    tree = params if model is not None else _tree(params)
    eng = deepspeed_tpu.initialize(model=jm, model_parameters=tree,
                                   config=dict(ds), mesh=mesh,
                                   loss_fn=loss_fn)[0]
    out = {"loss": [], "grad_norm": [], "skipped": [], "loss_scale": []}
    for b in global_batches:
        m = eng.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "loss_scale"):
            out[k].append(float(m[k]))
        out["skipped"].append(bool(m["skipped"]))
    if eng.host_opt is not None:
        out["master"] = {k.replace("/", "."): v.reshape(
            eng.host_opt.shapes[k]) for k, v in eng.host_opt.master.items()}
    else:
        out["master"] = _flat(jax.device_get(eng.fp32_master_params()))
    out["skipped_steps"] = eng.skipped_steps
    out["engine"] = eng
    return out


def assert_fp32(port, ref, n=None):
    n = n if n is not None else len(ref["loss"])
    np.testing.assert_allclose(port["loss"], ref["loss"][-n:], rtol=1e-5)
    np.testing.assert_allclose(port["grad_norm"], ref["grad_norm"][-n:],
                               rtol=1e-5)
    for k, v in ref["master"].items():
        np.testing.assert_allclose(port["master"][k], v, atol=LR / 10,
                                   err_msg=k)


def assert_bf16(port, ref, init):
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-2)
    np.testing.assert_allclose(port["grad_norm"], ref["grad_norm"],
                               rtol=1e-2)
    for k, v in ref["master"].items():
        dp, dj = port["master"][k] - init[k], v - init[k]
        if k.endswith("c_attn.bias"):
            C = dp.shape[0] // 3
            assert np.abs(dp[C:2 * C]).max() <= 3 * LR + 1e-6
            dp, dj = np.delete(dp, np.s_[C:2 * C]), np.delete(dj, np.s_[C:2 * C])
        rel = np.linalg.norm(dp - dj) / max(np.linalg.norm(dj), 1e-12)
        assert rel < 0.1, (k, rel)


# ---------------------------------------------------------------------------
# 2 ranks: the engine at stages 0-3, fp16, host offload, sparse gradients,
# checkpoints across world sizes
# ---------------------------------------------------------------------------

def _ds(stage, precision=None, **extra):
    # stage 3 keeps leaves under 1000 elements whole (biases, LayerNorms)
    # and splits the others
    zc = {"stage": stage, "stage3_param_persistence_threshold": 1000,
          **extra.pop("zero_optimization", {})}
    ds = dict(W.BASE, zero_optimization=zc, **extra)
    if precision:
        ds[precision] = {"enabled": True}
    return ds


FP16 = {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 2,
        "hysteresis": 2}
HOST = {"device": "cpu", "implementation": "host"}
FP16_DS = {k: v for k, v in _ds(1, fp16=FP16).items() if k != "scheduler"}
ONE = dict(W.BASE, train_micro_batch_size_per_gpu=4)   # 1 rank, 2 ranks' rows


def _fp16_batches():
    """Step 2's batch overflows on rank 1's rows only."""
    out = W.batches(3, 8, seed=5)
    for i, b in enumerate(out):
        b["w"] = np.ones(8, np.float32)
        if i == 1:
            b["w"][4:] = 1e9
    return out


def _sparse_batches():
    rng = np.random.default_rng(7)
    return [{"input_ids": rng.integers(0, W.UntiedEmbed.V, (4, 9)).astype(
        np.int32)} for _ in range(3)]


SPARSE_DS = {"train_micro_batch_size_per_gpu": 2,
             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
             "zero_optimization": {"stage": 0}, "sparse_gradients": True}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every 2-rank run, in one spawn group, and the 1-rank runs they are
    compared with."""
    tmp = tmp_path_factory.mktemp("two")
    params = W.numpy_gpt2_params()
    gb = W.batches(3, 8)
    s3 = _ds(3)
    # the 1-rank half of the reverse resume: one step, saved
    one_ck = str(tmp / "ck_dp1")
    W.train_run(params, dict(s3, train_micro_batch_size_per_gpu=4), gb, 0, 1,
                steps=1, tag_dir=one_ck, save_after=1)
    runs = {f"s{s}_{d}": (_ds(s, None if d == "f32" else "bf16"),
                          {"dtype": "float32" if d == "f32" else "bfloat16",
                           "fetch": s == 3})
            for s in range(4) for d in ("f32", "bf16")}
    runs["s3_f32_tree"] = (s3, {"fetch": False})
    runs["fp16"] = (FP16_DS, {"dtype": "float16", "weights": True,
                              "batches": _fp16_batches()})
    runs["offload"] = (_ds(2, "bf16", zero_optimization={
        "stage": 2, "offload_optimizer": HOST}), {"dtype": "bfloat16"})
    # host offload across world sizes: 1 rank's tag resumed at 2, and
    # 2 ranks' tag (rank 0 writes whole leaves) resumed at 1
    off = _ds(2, zero_optimization={"stage": 2, "offload_optimizer": HOST})
    off_one = dict(off, train_micro_batch_size_per_gpu=4)
    off_ck1 = str(tmp / "off_dp1")
    W.train_run(params, off_one, gb, 0, 1, steps=1, tag_dir=off_ck1,
                save_after=1)
    runs["off_save"] = (off, {"steps": 1, "tag_dir": "off_dp2",
                              "save_after": 1})
    runs["off_load"] = (off, {"first": 1, "load": True, "tag_dir": off_ck1})
    runs["sparse"] = (SPARSE_DS, {"sparse": True, "params":
                                  W.untied_params(),
                                  "batches": _sparse_batches()})
    # the NVMe tier over 2 ranks: each rank swaps its blocks under
    # nvme_path/rank<r>
    nv = str(tmp / "nvme")
    runs["nvme"] = (_ds(3, zero_optimization={
        "stage": 3, "offload_optimizer": {"device": "nvme",
                                          "nvme_path": nv},
        "offload_param": {"device": "nvme", "nvme_path": nv}},
        telemetry={"numerics_enabled": True}), {"fetch": True})
    runs["ck_save"] = (s3, {"fetch": True, "steps": 1, "tag_dir": "ck_dp2",
                            "save_after": 1})
    runs["ck_load"] = (s3, {"fetch": True, "first": 1, "load": True,
                            "tag_dir": one_ck})
    ranks = W.run_ranks(W.engine_runs, 2, tmp, params, gb, runs)
    ck_dp2 = str(tmp / "engine_runs_2" / "ck_dp2")
    resumed = W.train_run(params, dict(s3, train_micro_batch_size_per_gpu=4),
                          gb, 0, 1, first=1, load=True, tag_dir=ck_dp2)
    one = W.train_run(params, ONE, gb, 0, 1)
    off_resumed = W.train_run(params, off_one, gb, 0, 1, first=1, load=True,
                              tag_dir=str(tmp / "engine_runs_2" / "off_dp2"))
    swapped = {r: sorted(os.listdir(os.path.join(nv, r)))
               for r in sorted(os.listdir(nv))}
    return {"ranks": ranks, "params": params, "gb": gb, "resumed": resumed,
            "one": one, "off_resumed": off_resumed, "swapped": swapped}


@pytest.fixture(scope="module")
def jax_dp2(two):
    gb = two["gb"]
    m2 = jmesh(2)
    out = {f"s{s}_{d}": jax_run(_ds(s, None if d == "f32" else "bf16"), m2,
                                gb, jnp.float32 if d == "f32"
                                else jnp.bfloat16)
           for s, d in ((0, "f32"), (3, "f32"), (3, "bf16"))}
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fp32_trajectory_matches_jax_at_dp2(two, jax_dp2, stage):
    ref = jax_dp2[f"s{0 if stage == 0 else 3}_f32"]
    for rank in two["ranks"]:
        assert_fp32(rank[f"s{stage}_f32"], ref)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16_trajectory_matches_jax_at_dp2(two, jax_dp2, stage):
    ref = jax_dp2["s3_bf16"]
    for rank in two["ranks"]:
        assert_bf16(rank[f"s{stage}_bf16"], ref, two["params"])


def test_jax_stages_agree(jax_dp2):
    """The premise of holding the port's stages 1-2 to JAX's stage 3."""
    assert_fp32(jax_dp2["s0_f32"], jax_dp2["s3_f32"])


def test_stage3_whole_tree_gather_equals_layer_gather(two):
    for rank in two["ranks"]:
        a, b = rank["s3_f32_tree"], rank["s3_f32"]
        assert a["loss"] == b["loss"]
        for k in a["master"]:
            np.testing.assert_array_equal(a["master"][k], b["master"][k])


def test_ranks_hold_blocks_and_agree(two):
    r0, r1 = two["ranks"]
    for name in ("s1_f32", "s2_bf16", "s3_f32"):
        assert r0[name]["loss"] == r1[name]["loss"]
        for k, v in r0[name]["params"].items():
            np.testing.assert_array_equal(v, r1[name]["params"][k])
    dims = r0["s3_f32"]["dims"]
    # the model's tp_specs reach the policy, as in JAX: wte [128, 64]
    # leaves its vocab rows to the tensor axis and splits its 64 columns,
    # c_attn [64, 192] its 192 columns and splits its 64 rows
    assert dims["wte"] == 1 and dims["h_0.attn.c_attn.kernel"] == 0
    assert r0["s0_f32"]["dims"]["wte"] is None


def test_two_ranks_equal_one_process(two):
    assert_fp32(two["ranks"][0]["s0_f32"], two["one"])


def test_fp16_overflow_skip_agrees_on_every_rank(two):
    gb = _fp16_batches()
    ref = jax_run(FP16_DS, jmesh(2), gb, jnp.float16, weights=True)
    for rank in two["ranks"]:
        t = rank["fp16"]
        assert t["skipped"] == ref["skipped"] == [False, True, False]
        assert t["loss_scale"] == ref["loss_scale"]
        assert t["skipped_steps"] == ref["skipped_steps"] == 1
        for i in (0, 2):
            np.testing.assert_allclose(t["loss"][i], ref["loss"][i],
                                       rtol=1e-2)


def test_host_offload_at_dp2_matches_jax(two, jax_dp2):
    """The rank's blocks of the master and moments on the host, the C++
    Adam (JAX's arithmetic bit for bit, tests/test_torch_cpu_adam.py),
    the new blocks all-gathered."""
    for rank in two["ranks"]:
        assert_bf16(rank["offload"], jax_dp2["s3_bf16"], two["params"])
    r0, r1 = two["ranks"]
    for k, v in r0["offload"]["params"].items():
        np.testing.assert_array_equal(v, r1["offload"]["params"][k])


def test_nvme_at_dp2_equals_one_process(two):
    """``offload_optimizer`` and ``offload_param`` on NVMe at stage 3 over
    2 ranks: the ranks agree and equal one process to the fp32
    tolerances; each rank's swap files (its blocks' moments and params)
    sit under its own ``rank<r>``. Numerics is on in this run."""
    r0, r1 = (r["nvme"] for r in two["ranks"])
    assert_fp32(r0, two["one"])
    assert r0["loss"] == r1["loss"]
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k])
    # numerics over ranks: each rank's block shares, one all-reduce; the
    # blocks' squared grad norms sum to the step's global one
    assert r0["numerics"] == r1["numerics"]
    gsq = sum(b["grad_norm"] ** 2 for b in r0["numerics"]["blocks"])
    np.testing.assert_allclose(gsq, r0["grad_norm"][-1] ** 2, rtol=1e-5)
    sw = two["swapped"]
    assert list(sw) == ["rank0", "rank1"]
    assert sw["rank0"] == sw["rank1"]
    assert any(f.startswith("param_") for f in sw["rank0"])
    assert any(f.endswith(".m.swp") for f in sw["rank0"])


class JaxUntied:
    """tests/test_sparse_gradients.py's model at the worker's size."""
    sparse_grad_paths = ("emb",)

    def loss_fn(self, params, batch, rng):
        ids = batch["input_ids"]
        x = params["emb"][ids[:, :-1]]
        logits = x @ params["head"]["kernel"] + params["head"]["bias"]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, ids[:, 1:, None],
                                             axis=-1))


def test_sparse_gradients_match_jax(two):
    p = W.untied_params()
    tree = {"emb": p["emb"], "head": {"kernel": p["head.kernel"],
                                      "bias": p["head.bias"]}}
    ref = jax_run(SPARSE_DS, jmesh(2), _sparse_batches(), model=JaxUntied(),
                  params=tree)
    assert ref["engine"]._sparse_grad_caps["emb"] == 18
    for rank in two["ranks"]:
        t = rank["sparse"]
        # 2 rows x 9 tokens a rank; 2 * 18 * 2 < 512 rows
        assert t["sparse_caps"] == {"emb": 18, "head.kernel": None,
                                    "head.bias": None}
        np.testing.assert_allclose(t["loss"], ref["loss"], rtol=1e-5)
        for k, v in ref["master"].items():
            np.testing.assert_allclose(t["master"][k], v, atol=LR / 10)


def test_checkpoint_dp2_resumes_at_dp1(two):
    full = two["ranks"][0]["s3_f32"]
    resumed = two["resumed"]
    assert resumed["global_steps"] == 3
    assert_fp32(resumed, full, n=2)


def test_checkpoint_dp1_resumes_at_dp2(two):
    full = two["ranks"][0]["s3_f32"]
    for rank in two["ranks"]:
        assert rank["ck_load"]["global_steps"] == 3
        assert_fp32(rank["ck_load"], full, n=2)


def test_host_offload_checkpoint_across_world_sizes(two):
    """``host_optimizer.npz`` written by rank 0 leaf by leaf (rank 1
    holds no whole leaf), resumed at 1 rank; a 1-rank tag resumed at 2
    ranks, each loading its blocks: both equal the uninterrupted 2-rank
    stage-2 run to the fp32 tolerances."""
    full = two["ranks"][0]["s2_f32"]
    r0, r1 = two["ranks"]
    assert r0["off_save"]["host_leaves_held"] and \
        all(r0["off_save"]["host_leaves_held"])
    assert len(r1["off_save"]["host_leaves_held"]) == \
        len(r0["off_save"]["host_leaves_held"])
    assert not any(r1["off_save"]["host_leaves_held"])
    assert two["off_resumed"]["global_steps"] == 3
    assert_fp32(two["off_resumed"], full, n=2)
    for rank in two["ranks"]:
        assert rank["off_load"]["global_steps"] == 3
        assert_fp32(rank["off_load"], full, n=2)


# ---------------------------------------------------------------------------
# 4 ranks, data 2 x fsdp 2: collectives, the 1-bit and sparse exchanges,
# the accessors, zero.Init, OnDevice, stage 3, GatheredParameters
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((4, 4, 8)).astype(np.float32)
    sp = np.zeros((4, 40, 3), np.float32)
    for r in range(4):
        for row in rng.choice(40, size=5, replace=False):
            sp[r, row] = rng.standard_normal(3)
    sp[:, 7] += 1.0   # one row every rank touches
    comp = rng.standard_normal((4, 32)).astype(np.float32)
    return xs, sp, comp


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    xs, sp, comp = _inputs()
    params = W.numpy_gpt2_params()
    gb = W.batches(3, 16)
    mesh_ds = {"mesh": {"data": 2, "fsdp": 2}}
    runs = {f"s3_{d}": (dict(_ds(3, None if d == "f32" else "bf16"),
                             **mesh_ds),
                        {"dtype": "float32" if d == "f32" else "bfloat16",
                         "fetch": True})
            for d in ("f32", "bf16")}
    ranks = W.run_ranks(W.mesh4_program, 4, tmp_path_factory.mktemp("four"),
                        xs, sp, comp, params, gb, runs)
    return {"ranks": ranks, "xs": xs, "sp": sp, "comp": comp,
            "params": params, "gb": gb}


def _jax_per_device(fn, x, mesh):
    f = jax.jit(jax.shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                              in_specs=P(DPX), out_specs=P(DPX),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


def test_collectives_match_shard_map(four):
    mesh = jmesh(2, 2)
    for name, call in W.CALLS.items():
        ref = _jax_per_device(lambda a: call(jcomm, a), four["xs"], mesh)
        for r, rank in enumerate(four["ranks"]):
            np.testing.assert_allclose(rank["calls"][name], ref[r],
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_prod_and_axis_index(four):
    xs = four["xs"]
    for r, rank in enumerate(four["ranks"]):
        np.testing.assert_allclose(rank["prod"], np.prod(xs, axis=0),
                                   rtol=1e-6)
    mesh = jmesh(2, 2)
    for key, axes in W.AXES.items():
        ref = _jax_per_device(lambda a: jnp.asarray(jax.lax.axis_index(axes)),
                              xs, mesh)
        assert [rank["axis_index"][key] for rank in four["ranks"]] == \
            ref.tolist()


def test_comms_logger_counts_match_jax(four):
    mesh = jmesh(2, 2)
    jcomm.comms_logger.configure(enabled=True)
    jcomm.comms_logger.comms_dict = {}
    try:
        for call in W.CALLS.values():
            _jax_per_device(lambda a: call(jcomm, a), four["xs"], mesh)
        ref = {k: dict(v) for k, v in jcomm.comms_logger.comms_dict.items()}
    finally:
        jcomm.comms_logger.configure(enabled=False)
        jcomm.comms_logger.comms_dict = {}
    for rank in four["ranks"]:
        # PROD is the port's alone (JAX's all_reduce refuses it)
        counts = dict(rank["counts"])
        counts[f"all_reduce[{DPX}]"]["count"] -= 1
        counts[f"all_reduce[{DPX}]"]["elements"] -= four["xs"][0].size
        assert counts == ref


def test_compressed_allreduce_matches_jax(four):
    mesh = jmesh(2, 2)
    comp = four["comp"]

    def two_rounds(x):
        w = jnp.zeros(x.shape)
        s = jnp.zeros(x.shape)
        out = []
        for _ in range(2):
            r, w, s = jcompressed(x, w, s, "data")
            out.append(jnp.stack([r, w, s]))
        return jnp.stack(out)
    ref = _jax_per_device(two_rounds, comp, mesh)
    for r, rank in enumerate(four["ranks"]):
        for i in range(2):
            np.testing.assert_allclose(np.stack(rank["compressed"][i]),
                                       ref[r, i], rtol=1e-6, atol=1e-6)


def test_sparse_all_mean_matches_jax(four):
    ref = _jax_per_device(lambda a: jsparse(a, 6, ("data", "fsdp")),
                          four["sp"], jmesh(2, 2))
    dense_mean = four["sp"].mean(axis=0)
    for r, rank in enumerate(four["ranks"]):
        np.testing.assert_allclose(rank["sparse"], ref[r], atol=1e-6)
        np.testing.assert_allclose(rank["sparse"], dense_mean, atol=1e-6)


def test_mesh_accessors_match_jax(four):
    mesh = jmesh(2, 2)
    ref = {"dp": jmesh_mod.get_data_parallel_world_size(mesh),
           "tp": jmesh_mod.get_model_parallel_world_size(mesh),
           "sp": jmesh_mod.get_sequence_parallel_world_size(mesh),
           "pp": jmesh_mod.get_pipe_parallel_world_size(mesh),
           "ep": jmesh_mod.get_expert_parallel_world_size(mesh, 3),
           "seq_active": False}
    for rank in four["ranks"]:
        assert rank["sizes"] == ref
    for cfg in (dict(), dict(data=4, fsdp=2), dict(fsdp=4), dict(tensor=2)):
        assert tmesh.MeshConfig(**cfg).resolve(8) == \
            jmesh_mod.MeshConfig(**cfg).resolve(8)
    with pytest.raises(ValueError):
        tmesh.MeshConfig(data=3).resolve(8)
    assert tmesh.MESH_AXES == jmesh_mod.MESH_AXES
    assert tmesh.DATA_AXES == jmesh_mod.DATA_AXES


def _jax_blocks(tree_of_arrays, mesh):
    """Device ``i``'s block of each leaf, by dotted name."""
    out = []
    for i, dev in enumerate(mesh.devices.reshape(-1)):
        blocks = {}
        for name, leaf in _flat_leaves(tree_of_arrays).items():
            shard = [s for s in leaf.addressable_shards if s.device == dev]
            blocks[name] = np.asarray(shard[0].data, np.float32)
        out.append(blocks)
    return out


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_zero_init_and_materialize_match_jax(four):
    mesh = jmesh(2, 2)
    tree = _tree(four["params"])
    jax_init = _jax_blocks(jzero.Init({"zero_optimization": {"stage": 3}},
                                      mesh=mesh).shard(tree), mesh)
    pol = jpart.ZeroShardingPolicy(3, mesh)
    jax_made = _jax_blocks(jmaterialize(
        jax.eval_shape(lambda: tree), lambda: tree,
        pol.param_sharding(tree)), mesh)
    for r, rank in enumerate(four["ranks"]):
        for k, v in jax_init[r].items():
            np.testing.assert_array_equal(rank["init"][k], v, err_msg=k)
            np.testing.assert_array_equal(
                rank["materialized"][k],
                torch.tensor(jax_made[r][k]).bfloat16().float().numpy())
        shape, dtype, dev = rank["meta"]["wte"]
        assert (shape, dtype, dev) == ((128, 64), "torch.bfloat16", "meta")


def test_stage3_on_data2_fsdp2_matches_jax(four):
    mesh = jmesh(2, 2)
    for d, jd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        ds = dict(_ds(3, None if d == "f32" else "bf16"),
                  mesh={"data": 2, "fsdp": 2})
        ref = jax_run(ds, mesh, four["gb"], jd)
        for rank in four["ranks"]:
            got = rank["runs"][f"s3_{d}"]
            if d == "f32":
                assert_fp32(got, ref)
            else:
                assert_bf16(got, ref, four["params"])


def test_gathered_parameters(four):
    for r, rank in enumerate(four["ranks"]):
        assert rank["gathered_keys"] == ["h_0.mlp.c_fc.kernel", "ln_f.bias",
                                         "ln_f.scale"]
        np.testing.assert_array_equal(
            rank["gathered_kernel"],
            rank["runs"]["s3_bf16"]["params"]["h_0.mlp.c_fc.kernel"])
        # rank 1's writes reached every rank: the kernel's block of
        # [64 / 4, 256] (its columns are the tensor axis's, as JAX's
        # tp_specs leave them) and the whole (under the threshold) bias
        assert (rank["after_write"]["h_0.mlp.c_fc.kernel"] == 7.0).all()
        assert (rank["after_write"]["ln_f.bias"] == 7.0).all()
        assert rank["param_block"] == (16, 256)


# ---------------------------------------------------------------------------
# In one process: the policy's specs, the topology, TiledLinear
# ---------------------------------------------------------------------------

def _shapes(name):
    from deepspeed_tpu_torch.models import bert, gpt2, llama
    if name == "gpt2":
        m = gpt2.GPT2LMModel(gpt2.GPT2Config(**W.TINY))
    elif name == "llama":
        m = llama.LlamaLMModel(llama.config_for("llama-tiny"))
    else:
        m = bert.BertPreTrainingModel(bert.config_for(
            "bert-base", hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, vocab_size=1000))
    return {n: tuple(p.shape) for n, p in
            m.init(torch.Generator().manual_seed(0)).items()}


def _nest(shapes):
    tree = {}
    for name, shape in shapes.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return tree


@pytest.mark.parametrize("model", ["gpt2", "llama", "bert"])
@pytest.mark.parametrize("data,fsdp,threshold", [
    (2, 1, 0), (4, 1, 0), (2, 2, 0), (2, 2, 5000)])
def test_policy_specs_equal_jax(model, data, fsdp, threshold):
    shapes = _shapes(model)
    jm = jmesh(data, fsdp)
    for stage in (1, 2, 3):
        tp = tpart.ZeroShardingPolicy(stage, {"data": data, "fsdp": fsdp},
                                      param_persistence_threshold=threshold)
        jp = jpart.ZeroShardingPolicy(stage, jm,
                                      param_persistence_threshold=threshold)
        for place in ("param_sharding", "grad_sharding", "master_sharding"):
            ref = {k: tuple(v.spec) for k, v in _flat_leaves(
                getattr(jp, place)(_nest(shapes))).items()}
            got = {k: tuple(v) for k, v in
                   getattr(tp, place)(shapes).items()}
            assert got == ref, (stage, place)
        # the engine's blocks are cut along the dim of the master's spec
        part = tpart.ZeroPartition(tp, shapes, index=0)
        specs = tp.master_sharding(shapes)
        assert part.parts == data * fsdp
        assert part.dims == {
            k: next((i for i, e in enumerate(specs[k]) if e is not None),
                    None) for k in shapes}, stage
    # a shape the rule cannot split stays whole; the biggest dim wins
    assert tuple(tpart.shard_leaf_spec((7, 5), None, {"data": 2}, 0)) == ()
    assert tuple(tpart.shard_leaf_spec((8, 16), None, {"data": 2})) == \
        tuple(jpart.shard_leaf_spec((8, 16), None, jmesh(2)))


@pytest.mark.parametrize("env", [
    {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
     "DS_COORDINATOR_ADDR": "h0"},
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
     "AZUREML_EXPERIMENT_ID": "x", "AZ_BATCH_MASTER_NODE": "m:6000"},
    {"SM_CURRENT_HOST": "b", "SM_HOSTS": '["b", "a"]'},
    {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "0",
     "SM_HOSTS": '["z", "y"]', "DLTS_JOB_ID": "1"},
])
def test_launcher_discovery_matches_jax(monkeypatch, env):
    from deepspeed_tpu_torch.comm import comm as tcomm
    for k in W._LAUNCH_VARS + ("AZ_BATCH_MASTER_NODE",):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcomm.mpi_discovery() == jcomm.mpi_discovery()
    assert (tcomm.in_aml(), tcomm.in_aws_sm(), tcomm.in_dlts()) == \
        (jcomm.in_aml(), jcomm.in_aws_sm(), jcomm.in_dlts())


def test_topology_matches_jax():
    for axes, dims in ((["pipe", "data"], [2, 4]),
                       (["pipe", "data", "model"], [2, 2, 2])):
        t, j = ttopo.ProcessTopology(axes, dims), jtopo.ProcessTopology(
            axes, dims)
        assert t.mapping == j.mapping
        for a in axes:
            assert t.get_axis_comm_lists(a) == j.get_axis_comm_lists(a)
        assert [t.get_rank_repr(r) for r in range(t.world_size)] == \
            [j.get_rank_repr(r) for r in range(j.world_size)]
    tg = ttopo.PipelineParallelGrid(ttopo.PipeDataParallelTopology(2, 2), 3)
    jg = jtopo.PipelineParallelGrid(jtopo.PipeDataParallelTopology(2, 2), 3)
    assert (tg.get_stage_id(), tg.get_data_parallel_id(), tg.stage_prev(),
            tg.stage_next()) == (jg.get_stage_id(), jg.get_data_parallel_id(),
                                 jg.stage_prev(), jg.stage_next())


@pytest.mark.parametrize("cls", ["TiledLinear", "TiledLinearReturnBias"])
def test_tiled_linear_matches_jax(cls):
    rng = np.random.default_rng(2)
    kernel = rng.standard_normal((12, 10)).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    x = rng.standard_normal((3, 12)).astype(np.float32)
    kw = dict(in_splits=3, out_splits=2)
    jl = getattr(jtiling, cls)(12, 10, **kw)
    tl = getattr(ttiling, cls)(12, 10, **kw)
    jp = jl.from_dense(kernel, bias)
    tp = {k: v.requires_grad_(True) for k, v in
          tl.from_dense(kernel, bias).items()}
    assert sorted(jp) == sorted(tp)
    jy, ty = jl(jp, jnp.asarray(x)), tl(tp, torch.tensor(x))
    if cls == "TiledLinearReturnBias":
        np.testing.assert_allclose(ty[1].detach(), jy[1], rtol=1e-6)
        jy, ty = jy[0], ty[0]
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-5,
                               atol=1e-6)

    # gradients of every tile through the checkpointed tiles
    def jloss(p):
        y = jl(p, jnp.asarray(x))
        return jnp.sum(jnp.square(y[0] if isinstance(y, tuple) else y))
    jg = jax.grad(jloss)(jp)
    y = tl(tp, torch.tensor(x))
    (y[0] if isinstance(y, tuple) else y).square().sum().backward()
    for k, v in jg.items():
        if tp[k].grad is None:   # ReturnBias leaves the bias to the caller
            assert not np.any(np.asarray(v))
            continue
        np.testing.assert_allclose(tp[k].grad.numpy(), v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # each tile is its own leaf with its own ZeRO-3 spec
    specs = tpart.ZeroShardingPolicy(3, {"data": 2}).param_sharding(tp)
    jspecs = jpart.ZeroShardingPolicy(3, jmesh(2)).param_sharding(jp)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v.spec) for k, v in jspecs.items()}
