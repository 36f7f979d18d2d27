"""Several ranks of the port on the CPU, over gloo: the spawn harness and
the rank programs of the multi-rank tests, and the tests that need no JAX.

This file imports no JAX: the ranks import it (and nothing of a parity
test module) to find their program. ``run_ranks`` starts one process per
rank, forked from a fork server (a fresh interpreter, no JAX) that
imported torch and the port once; each joins a gloo process group through a
``FileStore`` under the test's ``tmp_path`` (no TCP port, so xdist
workers do not collide) with a 60 s collective timeout, runs its program
and saves what it returns. The parent joins the ranks against a deadline
and kills them when it passes: a hung collective fails its test instead
of eating the suite's time limit.

Tolerances here: the engine over 2 ranks against the same engine in one
process at stage 0, fp32: losses and grad norms to 1e-5 relative (the
mean of two ranks' micro-batch means against one mean over both ranks'
rows: the same f32 sums in another order), the final master to ``lr /
10`` absolute (Adam divides each gradient element by its own running
magnitude, so last-bit differences of near-zero elements reach the update
at up to ``lr`` scale; tests/test_torch_training.py).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import pytest
import torch

DEADLINE = 240   # seconds a spawn group may take before it is killed
TIMEOUT = datetime.timedelta(seconds=60)   # any one collective

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
T = 16


def _child(fn_module, fn_name, rank, ws, store_path, out_dir, args):
    torch.set_num_threads(1)
    import importlib

    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.mesh import reset_global_mesh
    try:
        comm.init_distributed(store=dist.FileStore(store_path, ws),
                              num_processes=ws, process_id=rank,
                              dist_backend="gloo", timeout=TIMEOUT,
                              device="cpu")
        fn = getattr(importlib.import_module(fn_module), fn_name)
        res = fn(rank, ws, out_dir, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        reset_global_mesh()
        comm.destroy_process_group()


# what every rank imports, once, in the fork server the ranks are forked
# from (a fresh interpreter: no JAX, no threads); torch._dynamo is what
# torch.utils.checkpoint imports on its first call (~5 s a process)
PRELOAD = ["torch", "torch._dynamo", "deepspeed_tpu_torch.runtime.engine",
           "deepspeed_tpu_torch.models.gpt2",
           "deepspeed_tpu_torch.inference.server", "test_torch_dist_workers",
           "test_torch_tp_workers"]


def run_ranks(fn, ws, tmp_path, *args, deadline=DEADLINE):
    """Run ``fn(rank, ws, out_dir, *args)`` (a function of a JAX-free test
    module) on ``ws`` ranks forked from a fork server that imported
    ``PRELOAD``; the list of their return values, by rank."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    out_dir = tmp_path / f"{fn.__name__}_{ws}"
    out_dir.mkdir(parents=True, exist_ok=True)
    store = str(out_dir / "store")
    procs = [ctx.Process(target=_child, args=(fn.__module__, fn.__name__, r,
                                              ws, store, str(out_dir), args))
             for r in range(ws)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "".join((out_dir / f"rank{r}.err").read_text()
                   for r in range(ws) if (out_dir / f"rank{r}.err").exists())
    if hung:
        pytest.fail(f"{fn.__name__}: ranks {hung} still running after "
                    f"{deadline} s, killed\n{errs}")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        pytest.fail(f"{fn.__name__}: ranks exited with {bad}\n{errs}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(ws)]


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------

def numpy_gpt2_params(seed=0):
    """The tiny GPT-2's weights from numpy (flax's layout, dotted
    names): normal(0.02) embeddings, normal(0.05) kernels, small biases,
    LayerNorm scales near 1."""
    from deepspeed_tpu_torch.models import gpt2 as port_gpt2
    rng = np.random.default_rng(seed)
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(**TINY))
    out = {}
    for name, p in model.module.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".scale"):
            out[name] = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith(".bias"):
            out[name] = 0.02 * rng.standard_normal(shape)
        elif name in ("wte", "wpe"):
            out[name] = 0.02 * rng.standard_normal(shape)
        else:
            out[name] = 0.05 * rng.standard_normal(shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def batches(n, rows, seed=4, vocab=TINY["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, T)).astype(np.int32)}
            for _ in range(n)]


def rank_rows(batch, rank, ws):
    """Rank ``rank``'s rows of a global batch (its own ``micro * gas``)."""
    rows = next(iter(batch.values())).shape[0] // ws
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def weighted(loss_fn):
    """A loss scaled by the batch's mean weight ``w`` (1 normally; a huge
    weight makes the fp16 gradients overflow)."""
    def fn(params, batch, rng=None):
        return loss_fn(params, batch, rng) * batch["w"].float().mean()
    return fn


class UntiedEmbed:
    """An embedding and a separate dense head: the embedding's gradient is
    row-sparse (a tied one is dense through the logits and must not be
    declared)."""
    V, D = 512, 16
    sparse_grad_paths = ("emb",)

    def loss_fn(self, params, batch, rng=None):
        ids = batch["input_ids"].long()
        x = params["emb"][ids[:, :-1]]
        logits = x @ params["head.kernel"] + params["head.bias"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, ids[:, 1:, None]).mean()


def untied_params(seed=3):
    rng = np.random.default_rng(seed)
    V, D = UntiedEmbed.V, UntiedEmbed.D
    return {"emb": (0.02 * rng.standard_normal((V, D))).astype(np.float32),
            "head.kernel": (0.02 * rng.standard_normal((D, V))
                            ).astype(np.float32),
            "head.bias": np.zeros(V, np.float32)}


def train_run(params, ds, global_batches, rank, ws, dtype="float32",
              fetch=False, model=None, steps=None, first=0, tag_dir=None,
              save_after=None, load=False, weights=False, sparse=False):
    """One engine over ``global_batches[first:steps]`` (each rank its
    rows): the steps' metrics, and the final whole master and params.
    ``save_after``: checkpoint under ``tag_dir`` after that many steps;
    ``load``: resume from ``tag_dir`` first; ``weights``: the loss scaled
    by the batch's ``w``; ``sparse``: the :class:`UntiedEmbed` model."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2 as port_gpt2
    if sparse:
        model = UntiedEmbed()
    elif model is None:
        model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
            **TINY, dtype=getattr(torch, dtype), offload_params=fetch))
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters={k: torch.tensor(v)
                                       for k, v in params.items()},
        config=dict(ds), device="cpu",
        loss_fn=weighted(model.loss_fn) if weights else None)[0]
    if load:
        eng.load_checkpoint(tag_dir)
    out = {"loss": [], "grad_norm": [], "skipped": [], "loss_scale": []}
    for i, b in enumerate(global_batches[first:steps]):
        m = eng.train_batch(rank_rows(b, rank, ws))
        for k in ("loss", "grad_norm", "loss_scale"):
            out[k].append(float(m[k]))
        out["skipped"].append(bool(m["skipped"]))
        if save_after is not None and i + 1 == save_after:
            out["host_leaves_held"] = save_watching_host_leaves(eng, tag_dir)
    out["master"] = {k: v.numpy() for k, v in
                     eng.fp32_master_params().items()}
    out["params"] = {k: v.float().numpy() for k, v in
                     eng.module_state_dict().items()}
    out["global_steps"] = eng.global_steps
    out["skipped_steps"] = eng.skipped_steps
    out["dims"] = dict(eng.part.dims) if eng.part is not None else None
    out["sparse_caps"] = dict(eng._sparse_grad_caps)
    if eng._numerics_on:
        out["numerics"] = eng.numerics.snapshot()["last"]
    out["engine"] = eng
    return out


def save_watching_host_leaves(eng, tag_dir):
    """``eng.save_checkpoint(tag_dir)``; with a host optimizer, for each
    leaf of ``host_optimizer.npz`` in turn whether this rank held it
    whole while the file was written (rank 0 writes; the others hold
    none)."""
    from deepspeed_tpu_torch.runtime import checkpointing
    held = []
    save = checkpointing._save_host_optimizer

    def watched(step, leaves, *args, **kwargs):
        def watch():
            for key, leaf in leaves:
                held.append(leaf is not None and
                            leaf.numel() == math.prod(eng._shapes[key[1]]))
                yield key, leaf
        return save(step, watch(), *args, **kwargs)
    checkpointing._save_host_optimizer = watched
    try:
        eng.save_checkpoint(tag_dir)
    finally:
        checkpointing._save_host_optimizer = save
    return held


BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 0.5,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 3,
                                 "warmup_type": "linear"}}}


def engine_runs(rank, ws, out_dir, params, global_batches, runs):
    """``runs``: ``{name: (ds_config, kwargs of train_run)}``; a run's
    ``tag_dir`` is relative to ``out_dir`` unless absolute."""
    out = {}
    for name, (ds, kw) in runs.items():
        kw = dict(kw)
        if "tag_dir" in kw:
            kw["tag_dir"] = os.path.join(out_dir, kw["tag_dir"])
        gb = kw.pop("batches", global_batches)
        p = kw.pop("params", params)
        out[name] = train_run(p, ds, gb, rank, ws, **kw)
        out[name].pop("engine")
    return out


# the collectives of both facades, called the same way (``C`` is the
# JAX package's comm module inside ``shard_map``, or the port's)
DP = ("data", "fsdp")
CALLS = {
    "all_reduce_sum": lambda C, x: C.all_reduce(x, C.SUM, axis_name="data"),
    "all_reduce_avg": lambda C, x: C.all_reduce(x, C.AVG, axis_name=DP),
    "all_reduce_max": lambda C, x: C.all_reduce(x, C.MAX, axis_name="fsdp"),
    "all_reduce_min": lambda C, x: C.all_reduce(x, C.MIN, axis_name="data"),
    "all_gather_fsdp_dim1": lambda C, x: C.all_gather(x, axis_name="fsdp",
                                                      axis=1),
    "all_gather_dp_stacked": lambda C, x: C.all_gather(
        x, axis_name=DP, axis=1, tiled=False),
    "reduce_scatter_data": lambda C, x: C.reduce_scatter(x, axis_name="data"),
    "reduce_scatter_dp_dim1": lambda C, x: C.reduce_scatter(
        x, axis_name=DP, axis=1),
    "reduce_scatter_untiled": lambda C, x: C.reduce_scatter(
        x[:2], axis_name="fsdp", tiled=False),
    "all_to_all": lambda C, x: C.all_to_all(x, axis_name=DP, split_axis=0,
                                            concat_axis=1),
    "all_to_all_single": lambda C, x: C.all_to_all_single(
        x, axis_name="data", split_axis=1, concat_axis=0),
    "broadcast": lambda C, x: C.broadcast(x, src_index=1, axis_name="data"),
    "reduce": lambda C, x: C.reduce(x, dst_index=1, op=C.SUM,
                                    axis_name="fsdp"),
    "gather": lambda C, x: C.gather(x, dst_index=2, axis_name=DP, axis=0),
    "scatter": lambda C, x: C.scatter(x, src_index=1, axis_name="data",
                                      axis=1),
    "ppermute": lambda C, x: C.ppermute(x, [(0, 1), (1, 2), (2, 3), (3, 0)],
                                        axis_name=DP),
    "send_recv": lambda C, x: C.send_recv(x, [(0, 2), (3, 1)], axis_name=DP),
}
AXES = {"data": "data", "fsdp": "fsdp", "dp": DP}


def mesh4_program(rank, ws, out_dir, xs, sparse_xs, comp_xs, params, gb,
                  runs):
    """On the data 2 x fsdp 2 mesh: every collective on this rank's
    ``xs[rank]`` (and the comms logger's counts), the 1-bit and sparse
    exchanges, the mesh accessors, ``zero.Init``, ``OnDevice`` +
    ``materialize``, the stage-3 engines of ``runs`` and
    ``GatheredParameters`` on the last of them."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import comm, mesh
    from deepspeed_tpu_torch.comm.compressed import compressed_allreduce
    from deepspeed_tpu_torch.runtime.sparse_tensor import sparse_all_mean
    from deepspeed_tpu_torch.runtime.zero.partition import (
        ZeroPartition, ZeroShardingPolicy)
    from deepspeed_tpu_torch.utils.init_on_device import (OnDevice,
                                                          materialize)
    m = mesh.build_mesh(mesh.MeshConfig(data=2, fsdp=2))
    mesh.set_global_mesh(m)
    out = {}
    x = torch.tensor(xs[rank])
    comm.comms_logger.configure(enabled=True)
    comm.comms_logger.reset()
    out["calls"] = {k: f(comm, x).numpy() for k, f in CALLS.items()}
    out["prod"] = comm.all_reduce(x, comm.PROD, axis_name=DP).numpy()
    out["counts"] = {k: dict(v) for k, v in
                     comm.comms_logger.comms_dict.items()}
    comm.comms_logger.configure(enabled=False)
    out["axis_index"] = {k: comm.axis_index(a) for k, a in AXES.items()}
    out["sizes"] = {
        "dp": mesh.get_data_parallel_world_size(),
        "tp": mesh.get_model_parallel_world_size(),
        "sp": mesh.get_sequence_parallel_world_size(),
        "pp": mesh.get_pipe_parallel_world_size(),
        "ep": mesh.get_expert_parallel_world_size(max_experts=3),
        "seq_active": mesh.seq_axis_active()}
    # two rounds: the second carries the first's error feedback
    w = torch.zeros(comp_xs.shape[1:])
    sv = torch.zeros(comp_xs.shape[1:])
    comp = []
    for _ in range(2):
        r, w, sv = compressed_allreduce(torch.tensor(comp_xs[rank]), w, sv,
                                        axis_name="data")
        comp.append((r.numpy(), w.numpy(), sv.numpy()))
    out["compressed"] = comp
    out["sparse"] = sparse_all_mean(torch.tensor(sparse_xs[rank]), 6,
                                    ["data", "fsdp"]).numpy()
    whole = {k: torch.tensor(v) for k, v in params.items()}
    with zero.Init({"zero_optimization": {"stage": 3}}) as zi:
        out["init"] = {k: v.numpy() for k, v in zi.shard(whole).items()}
    with OnDevice(dtype=torch.bfloat16, device="meta"):
        abstract = OnDevice.current().init(
            lambda: {k: torch.zeros(v.shape) for k, v in whole.items()})
    out["meta"] = {k: (tuple(v.shape), str(v.dtype), v.device.type)
                   for k, v in abstract.items()}
    part = ZeroPartition(ZeroShardingPolicy(3, m),
                         {k: v.shape for k, v in abstract.items()})
    made = materialize(abstract, lambda k, a: whole[k].clone(), part,
                       dtype=torch.bfloat16, device="cpu")
    out["materialized"] = {k: v.float().numpy() for k, v in made.items()}
    last = None
    out["runs"] = {}
    for name, (ds, kw) in runs.items():
        res = train_run(params, ds, gb, rank, ws, **kw)
        last = res.pop("engine")
        out["runs"][name] = res
    with zero.GatheredParameters(last, ["ln_f", "h_0/mlp/c_fc/kernel"],
                                 modifier_rank=1) as g:
        out["gathered_keys"] = sorted(g.keys())
        out["gathered_kernel"] = g["h_0.mlp.c_fc.kernel"].float().numpy()
        for k in ("ln_f.bias", "h_0.mlp.c_fc.kernel"):
            g[k].fill_(7.0 if rank == 1 else -1.0)
    sd = last.module_state_dict()
    out["after_write"] = {k: sd[k].float().numpy()
                          for k in ("ln_f.bias", "h_0.mlp.c_fc.kernel")}
    out["param_block"] = tuple(last.params["h_0.mlp.c_fc.kernel"].shape)
    return out


# ---------------------------------------------------------------------------
# Tests with no JAX
# ---------------------------------------------------------------------------

def test_hung_collective_fails_on_its_deadline(tmp_path):
    started = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="still running"):
        run_ranks(hang, 2, tmp_path, deadline=4)
    assert time.monotonic() - started < 20


def hang(rank, ws, out_dir):
    """Rank 1 waits in a collective rank 0 never joins."""
    from deepspeed_tpu_torch.comm import comm
    if rank == 1:
        comm.all_reduce(torch.ones(2), axis_name="data")
    else:
        time.sleep(60)
    return None


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "DS_COORDINATOR_ADDR", "DS_NUM_PROCESSES",
                "DS_PROCESS_ID", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
                "PROCESS_ID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                "SM_TRAINING_ENV", "SM_CURRENT_HOST", "SM_HOSTS",
                "AZUREML_EXPERIMENT_ID", "DLTS_JOB_ID")


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1234", "DS_PROCESS_ID": "1"}, ("h0:1234", 4, 3)),
    ({"DS_COORDINATOR_ADDR": "h1:9", "DS_NUM_PROCESSES": "2",
      "DS_PROCESS_ID": "1", "NUM_PROCESSES": "8"}, ("h1:9", 2, 1)),
    ({"COORDINATOR_ADDRESS": "h2:7", "NUM_PROCESSES": "3",
      "PROCESS_ID": "2"}, ("h2:7", 3, 2)),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "DS_COORDINATOR_ADDR": "h3"}, ("h3", 2, 1)),
    ({}, (None, None, None)),
])
def test_discovery_order(monkeypatch, env, want):
    """torchrun's variables, then the JAX launcher's, then MPI's."""
    from deepspeed_tpu_torch.comm import comm
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert comm.discover() == want


def test_no_launcher_stays_at_world_size_1(monkeypatch):
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(comm, "_INITIALIZED", False)
    comm.init_distributed()
    assert comm.is_initialized() and not dist.is_initialized()
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    # without a group an axis has one member: JAX over a one-device axis
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(comm.all_gather(x, "data", axis=1), x)
    assert torch.equal(comm.ppermute(x, [(0, 0)], "data"), x)
    assert comm.axis_index(("data", "fsdp")) == 0
    with pytest.raises(ValueError, match="unknown mesh axes"):
        comm.all_reduce(x, axis_name="model")


def test_run_sweep_at_one_rank(monkeypatch):
    """Every collective of the sweep runs through the facade and gets a
    record (no process group: an axis of one rank)."""
    from deepspeed_tpu_torch import benchmarks_comm
    from deepspeed_tpu_torch.comm import comm
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(comm, "_INITIALIZED", False)
    comm.init_distributed()
    out = benchmarks_comm.run_sweep((0.001, 0.002), trials=2, device="cpu")
    assert [(r["collective"], r["size_mb"]) for r in out] == [
        (c, mb) for c in benchmarks_comm.COLLECTIVES for mb in (0.001, 0.002)]
    assert all(r["devices"] == 1 and r["latency_ms"] >= 0 for r in out)


def test_run_sweep_device_defaults_to_the_card(monkeypatch):
    """Without a process group (``python -m`` without torchrun) the sweep
    times the rank's card, and with no card it raises: it never times
    host copies as a collective unless asked for the CPU."""
    from deepspeed_tpu_torch import benchmarks_comm
    from deepspeed_tpu_torch.comm import comm
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(comm, "_INITIALIZED", False)
    comm.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks_comm.run_sweep((0.001,), trials=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert benchmarks_comm._sweep_device(None) == torch.device("cuda", 1)
    assert benchmarks_comm._sweep_device("cpu") == torch.device("cpu")
