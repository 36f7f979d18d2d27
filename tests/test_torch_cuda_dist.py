"""The collective path on the card: NCCL at world size 1.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX (nor the
tests' conftest), so it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dist.py -q

The box has one card, and NCCL refuses two ranks on one device, so NCCL
runs here with one rank (a ``FileStore`` under ``tmp_path``). Over one
rank every collective of ``comm/comm.py`` returns what JAX's gives over a
one-device axis, on CUDA tensors through NCCL; and the training engine's
ZeRO-3 path (GPT-2's per-layer gather, the gradients reduce-scattered
onto the rank's block) and ZeRO-2 path equal the single-process engine
bit for bit: a small GPT-2 (2 layers, 256 wide, 2 heads of 128, T 128,
bf16, remat) trains 3 steps through B1-B3 from the same weights.
"""
import datetime

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.ops import flash_attention as fa

CFG = dict(vocab_size=512, n_positions=128, n_embd=256, n_layer=2, n_head=2)
STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _start(tmp_path):
    import torch.distributed as dist
    comm.init_distributed(store=dist.FileStore(str(tmp_path / "store"), 1),
                          num_processes=1, process_id=0, dist_backend="nccl",
                          timeout=datetime.timedelta(seconds=60))


@pytest.fixture
def nccl(cuda_device, tmp_path):
    _start(tmp_path)
    from deepspeed_tpu_torch.comm import mesh
    mesh.set_global_mesh(mesh.build_mesh())
    yield cuda_device
    comm.destroy_process_group()


DP = ("data", "fsdp")
ONE_RANK = {
    "all_reduce sum": (lambda x: comm.all_reduce(x, comm.SUM, DP),
                       lambda x: x),
    "all_reduce avg": (lambda x: comm.all_reduce(x, comm.AVG, "data"),
                       lambda x: x),
    "all_reduce max": (lambda x: comm.all_reduce(x, comm.MAX, "fsdp"),
                       lambda x: x),
    "all_reduce prod": (lambda x: comm.all_reduce(x, comm.PROD, DP),
                        lambda x: x),
    "all_gather": (lambda x: comm.all_gather(x, DP, axis=1), lambda x: x),
    "all_gather stacked": (lambda x: comm.all_gather(x, DP, axis=1,
                                                     tiled=False),
                           lambda x: x[:, None]),
    "reduce_scatter": (lambda x: comm.reduce_scatter(x, DP, axis=1),
                       lambda x: x),
    "reduce_scatter untiled": (lambda x: comm.reduce_scatter(
        x[:1], "data", tiled=False), lambda x: x[0]),
    "all_to_all": (lambda x: comm.all_to_all(x, DP, 0, 1), lambda x: x),
    "broadcast": (lambda x: comm.broadcast(x, 0, DP), lambda x: x),
    "reduce": (lambda x: comm.reduce(x, 0, comm.SUM, DP), lambda x: x),
    "gather": (lambda x: comm.gather(x, 0, DP, axis=0), lambda x: x),
    "scatter": (lambda x: comm.scatter(x, 0, DP, axis=1), lambda x: x),
    "ppermute": (lambda x: comm.ppermute(x, [(0, 0)], DP), lambda x: x),
    "send_recv nothing": (lambda x: comm.send_recv(x, [], DP),
                          lambda x: torch.zeros_like(x)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ONE_RANK))
def test_collective_at_world_size_1(nccl, name):
    run, want = ONE_RANK[name]
    x = torch.randn(4, 6, device=nccl)
    comm.comms_logger.configure(enabled=True)
    comm.comms_logger.reset()
    try:
        got = run(x)
        counts = dict(comm.comms_logger.comms_dict)
    finally:
        comm.comms_logger.configure(enabled=False)
    torch.cuda.synchronize()
    assert got.is_cuda
    assert torch.equal(got, want(x))
    assert counts and all(v["count"] >= 1 for v in counts.values())
    assert comm.axis_index(DP) == 0


def _batches():
    g = torch.Generator().manual_seed(3)
    return [{"input_ids": torch.randint(0, CFG["vocab_size"], (4, 128),
                                        generator=g, dtype=torch.int32)}
            for _ in range(STEPS)]


def _run(zero, fetch=False):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **CFG, dtype=torch.bfloat16, offload_params=fetch))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "bf16": {"enabled": True},
            "zero_optimization": dict(
                zero, stage3_param_persistence_threshold=1000),
            "comms_logger": {"enabled": True},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}}})[0]
    comm.comms_logger.reset()
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    before = [k.launches for k in kernels]
    losses = [float(eng.train_batch(b)["loss"]) for b in _batches()]
    return {"losses": losses, "master": eng.fp32_master_params(),
            "params": eng.module_state_dict(),
            "launches": [k.launches - b for k, b in zip(kernels, before)],
            "comms": dict(comm.comms_logger.comms_dict), "dist": eng._dist}


@pytest.mark.cuda
def test_zero3_and_zero2_over_nccl_equal_single_process(cuda_device,
                                                        tmp_path):
    ref = _run({"stage": 0})
    assert not ref["dist"]
    _start(tmp_path)
    try:
        got = {"3": _run({"stage": 3}, fetch=True),
               "2": _run({"stage": 2})}
    finally:
        comm.destroy_process_group()
    for stage, r in got.items():
        assert r["dist"]
        assert r["losses"] == ref["losses"], stage
        for k, v in ref["master"].items():
            assert torch.equal(r["master"][k], v), (stage, k)
            assert torch.equal(r["params"][k], ref["params"][k]), (stage, k)
        assert r["launches"] == ref["launches"] and min(r["launches"]) > 0
        kinds = {k.split("[")[0] for k in r["comms"]}
        assert {"all_gather", "reduce_scatter"} <= kinds, (stage, kinds)
