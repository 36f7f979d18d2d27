"""The port's checkpoint toolkit against the JAX package's, on the CPU.

* ``zero_to_fp32`` on a port checkpoint (bf16 training) equals the
  engine's ``fp32_master_params()`` bit for bit, through the dict, the
  written file and the params-shaped re-load.
* ``DeepSpeedCheckpoint`` inspection (tag, step, stage, tags, the meta's
  keys and counters, the master's shapes) and ``reshape_checkpoint``
  (the same sidecar files, ``latest``, a copy that loads and verifies)
  match the JAX toolkit on the same run: the same MLP, weights and
  batches through both engines.
* ``import_deepspeed`` on the synthetic DeepSpeed v0.8 checkpoints that
  ``tests/test_import_deepspeed.py`` writes (stage 0, i.e. module weights
  only, stage 2 at world 1/2/4, stage 3 at world 2/3) gives the JAX
  importer's fp32 dict exactly, and ``to_param_tree`` /
  ``import_into_engine`` install it into a port engine.
"""
import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_import_deepspeed import (make_params, write_model_states,
                                   write_zero2, write_zero3)

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import DeepSpeedCheckpoint as JaxCheckpoint
from deepspeed_tpu.checkpoint import reshape_checkpoint as jax_reshape
from deepspeed_tpu.checkpoint.import_deepspeed import (
    load_reference_fp32_state_dict as jax_import)
from deepspeed_tpu.checkpoint.import_deepspeed import \
    to_param_tree as jax_to_param_tree
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh
from deepspeed_tpu_torch.checkpoint import (
    DeepSpeedCheckpoint, convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint, import_into_engine,
    load_reference_fp32_state_dict, load_state_dict_from_zero_checkpoint,
    make_checkpoint_engine, reshape_checkpoint, to_param_tree)
from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
    AsyncCheckpointEngine, TorchCheckpointEngine)
from deepspeed_tpu_torch.checkpoint.integrity import verify_checkpoint
from deepspeed_tpu_torch.models import gpt2 as port_gpt2

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
D_IN, D_OUT, ROWS = 8, 4, 4
CFG = {"train_micro_batch_size_per_gpu": ROWS,
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}


def _mlp_init():
    rng = np.random.default_rng(3)
    return (rng.normal(0, 0.1, (D_IN, D_IN)).astype(np.float32),
            rng.normal(0, 0.1, (D_IN, D_OUT)).astype(np.float32))


def _batch(step):
    rng = np.random.default_rng(500 + step)
    return {"x": rng.normal(size=(ROWS, D_IN)).astype(np.float32),
            "y": rng.normal(size=(ROWS, D_OUT)).astype(np.float32)}


def _jax_mlp():
    w0, w1 = _mlp_init()

    def loss_fn(p, b, rng_):
        h = jnp.tanh(b["x"] @ p["blk0"]["w"])
        return jnp.mean((h @ p["blk1"]["w"] - b["y"]) ** 2)
    return deepspeed_tpu.initialize(
        loss_fn=loss_fn, model_parameters={"blk0": {"w": jnp.asarray(w0)},
                                           "blk1": {"w": jnp.asarray(w1)}},
        config=dict(CFG),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


def _port_mlp():
    w0, w1 = _mlp_init()

    def loss_fn(p, b, rng_):
        h = torch.tanh(b["x"] @ p["blk0.w"])
        return torch.mean((h @ p["blk1.w"] - b["y"]) ** 2)
    return deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, model_parameters={"blk0.w": torch.from_numpy(w0),
                                           "blk1.w": torch.from_numpy(w1)},
        config=dict(CFG), device="cpu")[0]


def test_zero_to_fp32_equals_the_engine_master(tmp_path):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=model.init(
            torch.Generator().manual_seed(1)),
        config={"train_micro_batch_size_per_gpu": 2,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")[0]
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.train_batch({"input_ids": rng.integers(0, 96, (2, 64))})
    eng.save_checkpoint(str(tmp_path / "ck"))
    live = eng.fp32_master_params()
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ck"))
    assert set(sd) == set(live)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, live[k]), k
    out = convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp_path / "ck"), str(tmp_path / "consolidated.pt"))
    blob = torch.load(out, weights_only=True)
    assert set(blob) == set(sd)
    tree = load_state_dict_from_zero_checkpoint(eng.params,
                                                str(tmp_path / "ck"))
    for k, v in tree.items():
        assert tuple(v.shape) == tuple(eng.params[k].shape)
        assert torch.equal(v, live[k])
    # the master differs from the bf16 compute params it is cast to
    assert any(not torch.equal(live[k], eng.params[k].float())
               for k in live)


def _train_and_save(engine, save_dir):
    for s in range(2):
        engine.train_batch(_batch(s))
    engine.save_checkpoint(save_dir, tag="mytag", client_state={"e": 1})


def test_inspection_and_reshape_match_jax(tmp_path):
    jeng, teng = _jax_mlp(), _port_mlp()
    _train_and_save(jeng, str(tmp_path / "jax"))
    _train_and_save(teng, str(tmp_path / "port"))
    jck = JaxCheckpoint(str(tmp_path / "jax"))
    tck = DeepSpeedCheckpoint(str(tmp_path / "port"))
    assert (tck.tag, tck.global_steps, tck.zero_stage, tck.tags()) == \
        (jck.tag, jck.global_steps, jck.zero_stage, jck.tags()) == \
        ("mytag", 2, 0, ["mytag"])
    # the same keys but the PRNG key: the port's loss_fn gets none
    assert set(tck.meta) == set(jck.meta) - {"rng_key"}
    for k in ("global_steps", "skipped_steps", "micro_steps", "zero_stage",
              "precision", "client_state"):
        assert tck.meta[k] == jck.meta[k], k
    md = tck.metadata()
    jparams = jck.load()["params"]
    assert md["master"] == {
        f"{a}.w": {"shape": tuple(np.asarray(jparams[a]["w"]).shape),
                   "dtype": "float32"} for a in ("blk0", "blk1")}
    assert md["optimizer"]["count"] == 2
    assert md["loss_scale"]["scale"] == {"shape": (), "dtype": "float32"}

    jout = jax_reshape(str(tmp_path / "jax"), str(tmp_path / "jax_dst"))
    tout = reshape_checkpoint(str(tmp_path / "port"),
                              str(tmp_path / "port_dst"))
    side = sorted(n for n in os.listdir(tout) if n != "state")
    assert side == sorted(n for n in os.listdir(jout) if n != "state") == \
        ["client_state.json", "manifest.json"]
    assert (tmp_path / "port_dst" / "latest").read_text() == "mytag"
    assert verify_checkpoint(tout) == (True, "ok")
    fresh = _port_mlp()
    fresh.load_checkpoint(str(tmp_path / "port_dst"))
    for k, v in fresh.fp32_master_params().items():
        assert torch.equal(v, teng.fp32_master_params()[k])
    assert fresh.global_steps == 2
    jeng.destroy()


def test_checkpoint_engine_kinds_and_round_trip(tmp_path):
    assert isinstance(make_checkpoint_engine("sync"), TorchCheckpointEngine)
    assert isinstance(make_checkpoint_engine("orbax"), TorchCheckpointEngine)
    assert isinstance(make_checkpoint_engine("nebula"),
                      AsyncCheckpointEngine)
    with pytest.raises(ValueError):
        make_checkpoint_engine("bogus")
    state = {"g": {"a": torch.arange(6.).reshape(2, 3), "n": 3}}
    for kind in ("sync", "async"):
        ce = make_checkpoint_engine(kind)
        ce.save(state, str(tmp_path / kind))
        assert ce.commit("t")
        got = ce.load(str(tmp_path / kind))
        assert got["g"]["n"] == 3 and torch.equal(got["g"]["a"],
                                                  state["g"]["a"])
        ce.close()


# ------------------------------------------------------- import_deepspeed

def _same(port_sd, jax_sd):
    assert set(port_sd) == set(jax_sd)
    for k, v in jax_sd.items():
        t = port_sd[k]
        assert torch.is_tensor(t)
        assert t.numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("stage,world", [(0, 1), (2, 1), (2, 2), (2, 4),
                                         (3, 2), (3, 3)])
def test_import_matches_the_jax_importer(tmp_path, stage, world):
    params = make_params()
    d = str(tmp_path)
    if stage == 0:   # a non-ZeRO save: the weights live in the module blob
        torch.save({"module": {k: torch.tensor(v)
                               for k, v in params.items()}},
                   os.path.join(d, "mp_rank_00_model_states.pt"))
    else:
        bufs = {"layer.0.running_stat": np.arange(3, dtype=np.float32)}
        write_model_states(d, params, bufs, stage3=stage == 3)
        (write_zero3 if stage == 3 else write_zero2)(d, params, world)
    _same(load_reference_fp32_state_dict(d), jax_import(d))


def test_param_tree_and_import_into_engine(tmp_path):
    ref = OrderedDict([("blk0.w", np.random.default_rng(5).normal(
        size=(D_IN, D_IN)).astype(np.float32)),
        ("blk1.w", np.random.default_rng(6).normal(
            size=(D_OUT, D_IN)).astype(np.float32))])
    write_model_states(str(tmp_path), ref)
    write_zero2(str(tmp_path), ref, 2)
    sd = load_reference_fp32_state_dict(str(tmp_path))
    keys = ("blk1.*",)   # [out, in] → [in, out]
    tree = to_param_tree(sd, transpose_linear_keys=keys)
    jtree = jax_to_param_tree({k: v.numpy() for k, v in sd.items()},
                              transpose_linear_keys=keys)
    for k, v in tree.items():
        a, b = k.split(".")
        np.testing.assert_array_equal(v.numpy(), np.asarray(jtree[a][b]))
    eng = _port_mlp()
    eng.train_batch(_batch(0))
    import_into_engine(eng, tree)
    for k, v in eng.fp32_master_params().items():
        assert torch.equal(v, tree[k])
    assert eng.opt_state.count == 0          # the optimizer restarts
    losses = [float(eng.train_batch(_batch(s))["loss"]) for s in range(2)]
    assert all(np.isfinite(losses))
    with pytest.raises(ValueError, match="do not match"):
        import_into_engine(eng, {"blk0.w": tree["blk0.w"]})
    with pytest.raises(ValueError, match="ndim"):
        to_param_tree({"c.weight": torch.ones(2, 2, 3)},
                      transpose_linear_keys=("*.weight",))
