"""ZeRO-Offload and parameter offload on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX (nor the
tests' conftest, which imports JAX), so it runs on the GPU machine as it
is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_offload.py -q

A small GPT-2 (2 layers, 256 wide, 2 heads of 128, T 128, bf16, remat)
trains 3 steps through B1-B3 from the same weights on the same batches:

* ``implementation='stream'`` (master and moments in pinned host memory,
  each leaf updated on the card) equals the in-HBM engine bit for bit:
  losses, masters and params.
* ``implementation='host'`` (the C++ Adam, the chunk pipeline) is within
  1e-2 relative of the in-HBM losses and within 0.05 relative L2 of each
  leaf's update of the master (the C++ step orders its f32 arithmetic
  differently from ``ops/adam.py``), the key third of each
  ``c_attn.bias`` (an exact gradient of zero, so both move it by rounding
  noise) within Adam's bound; its bf16 params are the RNE cast of its host
  master bit for bit.
* The chunk pipeline (gradients on the card, small chunks, every slot
  reused) equals the optimizer's own step on the same gradients on the
  host, bit for bit, with bf16 and f32 gradients and params on the card
  or on the host.
* ``offload_param`` with the per-layer fetch equals the host path without
  it bit for bit, keeps the params in pinned host memory between steps,
  and lowers the device peak.
"""
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

CFG = dict(vocab_size=512, n_positions=128, n_embd=256, n_layer=2, n_head=2)
STEPS = 3
LR = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batches():
    g = torch.Generator().manual_seed(3)
    return [{"input_ids": torch.randint(0, CFG["vocab_size"], (4, 128),
                                        generator=g, dtype=torch.int32)}
            for _ in range(STEPS)]


def _engine(zero, fetch=False):
    model = port_gpt2.GPT2LMModel(port_gpt2.GPT2Config(
        **CFG, dtype=torch.bfloat16, offload_params=fetch))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, device="cuda", config={
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.01}}})[0]


def _train(engine):
    launches = fa.flash_attention_bwd_dkv.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [engine.train_batch(b)["loss"].item() for b in _batches()]
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches > launches   # B3 ran
    return losses, engine.fp32_master_params(), torch.cuda.max_memory_allocated()


@pytest.mark.cuda
def test_stream_equals_the_in_hbm_path(cuda_device):
    ref = _engine({"stage": 0})
    init = ref.fp32_master_params()
    la, ma, _ = _train(ref)
    eng = _engine({"stage": 1, "offload_optimizer": {
        "device": "cpu", "implementation": "stream"}})
    assert eng._stream_opt is not None and eng.host_opt is None
    assert all(m.is_pinned() for m in eng.master.values())
    lb, mb, _ = _train(eng)
    assert la == lb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
        assert torch.equal(ref.params[k], eng.params[k]), k
        assert not torch.equal(ma[k], init[k]), k
    # auto resolves to stream on the card without fp16
    assert _engine({"stage": 2, "offload_optimizer": {
        "device": "cpu"}})._stream_opt is not None


@pytest.mark.cuda
def test_host_is_within_tolerance_of_the_in_hbm_path(cuda_device):
    ref = _engine({"stage": 0})
    init = ref.fp32_master_params()
    la, ma, _ = _train(ref)
    eng = _engine({"stage": 1, "offload_optimizer": {
        "device": "cpu", "implementation": "host"}})
    assert eng.host_opt is not None
    lb, mb, _ = _train(eng)
    for a, b in zip(la, lb):
        assert abs(a - b) <= 1e-2 * abs(a), (la, lb)
    C = CFG["n_embd"]
    for k in ma:
        da, db = ma[k] - init[k], mb[k] - init[k]
        if k.endswith("c_attn.bias"):
            # the key third's exact gradient is zero: Adam's bound only
            assert db[C:2 * C].abs().max().item() <= STEPS * LR * 1.01, k
            keep = torch.cat([torch.arange(C), torch.arange(2 * C, 3 * C)])
            da, db = da[keep], db[keep]
        assert ((db - da).norm() / da.norm()).item() <= 0.05, k
        assert torch.equal(eng.params[k].cpu(), mb[k].to(torch.bfloat16)), k
    t = eng.offload_step_times
    assert t["device_s"] > 0 and t["adam_s"] > 0 and t["d2h_s"] > 0 and \
        t["h2d_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype,pdtype,where", [
    (torch.float32, torch.bfloat16, "cuda"),
    (torch.bfloat16, torch.bfloat16, "cuda"),
    (torch.float32, torch.float32, "cuda"),
    (torch.float32, torch.bfloat16, "cpu")])
def test_chunk_pipeline_equals_the_host_step(cuda_device, gdtype, pdtype,
                                             where):
    g = torch.Generator().manual_seed(1)
    shapes = {"a": (3, 5000), "b": (4096 * 5 + 7,), "c": (11,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    opt = {"lr": 1e-2, "weight_decay": 0.01}
    piped = HostOffloadOptimizer(params, opt, chunk=8192, slots=2)
    plain = HostOffloadOptimizer(params, opt)
    dst_p = {k: torch.zeros(s, dtype=pdtype, device=where) for k, s in
             shapes.items()}
    if where == "cpu":
        dst_p = {k: v.pin_memory() for k, v in dst_p.items()}
    dst_h = {k: torch.zeros(s, dtype=pdtype) for k, s in shapes.items()}
    for step in range(3):
        grads = {k: torch.randn(s, generator=g).to(gdtype)
                 for k, s in shapes.items()}
        piped.step_streamed({k: v.cuda() for k, v in grads.items()},
                            1e-2, dst_p)
        plain.step_streamed(grads, 1e-2, dst_h)
    torch.cuda.synchronize()
    for k in shapes:
        assert torch.equal(piped.master[k], plain.master[k]), k
        assert torch.equal(piped.state[k]["v"], plain.state[k]["v"]), k
        assert torch.equal(dst_p[k].cpu(), dst_h[k]), k
    assert piped.last_times["chunks"] == 2 + 3 + 1


@pytest.mark.cuda
def test_param_offload_keeps_params_on_the_host(cuda_device):
    host = {"device": "cpu", "implementation": "host"}
    ref = _engine({"stage": 1, "offload_optimizer": host})
    la, ma, peak_a = _train(ref)
    pa = {k: v.detach().cpu() for k, v in ref.params.items()}
    del ref   # the peaks count every engine on the card
    torch.cuda.empty_cache()
    eng = _engine({"stage": 3, "offload_optimizer": host,
                   "offload_param": {"device": "cpu"}}, fetch=True)
    assert all(p.device.type == "cpu" and p.is_pinned()
               for p in eng.params.values())
    lb, mb, peak_b = _train(eng)
    assert la == lb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
        assert torch.equal(pa[k], eng.params[k]), k
    assert all(p.device.type == "cpu" and p.is_pinned()
               for p in eng.params.values())
    assert peak_b < peak_a, (peak_b, peak_a)
