"""Checkpoints of the port's training engine on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: what they check exists only on a
card, where a step's kernels run asynchronously to the host. The file
imports no JAX (nor the tests' conftest, which does), so it runs on the
GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_checkpoint.py -q

* An async save taken while a step's kernels are still queued, followed
  at once by another in-place step: the checkpoint holds the state the
  stream had reached at the save, bit for bit.
* Save at step 2 (sync and async), load into an engine built from other
  weights, take steps 3-4: bit for bit the uninterrupted 4-step run, and
  the load leaves no second copy of the state on the card.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel

CFG = GPT2Config(vocab_size=500, n_positions=256, n_embd=256, n_layer=2,
                 n_head=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _engine(seed, kind="sync"):
    model = GPT2LMModel(CFG)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "bf16": {"enabled": True}, "checkpoint": {"engine": kind},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})[0]


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, CFG.vocab_size, (4, 256),
                                       np.int32)} for _ in range(n)]


@pytest.mark.cuda
def test_async_save_while_a_step_is_in_flight(cuda_device, tmp_path):
    batches = _batches(2)
    e = _engine(0, "async")
    e.train_batch(batches[0])      # returns with its kernels queued
    # stream-ordered after step 1, as the save's own snapshot is
    expect = {k: v.detach().clone() for k, v in e.master.items()}
    e.save_checkpoint(str(tmp_path))
    e.train_batch(batches[1])      # updates the master in place at once
    e.destroy()
    f = _engine(1, "async")
    f.load_checkpoint(str(tmp_path))
    for k, v in expect.items():
        assert torch.equal(f.master[k], v), k
    for k, p in f.params.items():
        assert torch.equal(p, f.master[k].to(p.dtype)), k
    assert f.global_steps == 1
    f.destroy()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sync", "async"])
def test_resume_on_card_is_bit_identical(cuda_device, tmp_path, kind):
    batches = _batches(4)
    a = _engine(0, kind)
    la = [float(a.train_batch(b)["loss"]) for b in batches]
    b = _engine(0, kind)
    for x in batches[:2]:
        b.train_batch(x)
    b.save_checkpoint(str(tmp_path))
    b.destroy()
    c = _engine(1, kind)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c.load_checkpoint(str(tmp_path))
    torch.cuda.synchronize()
    # copied into the engine's tensors: at most one leaf's staging copy
    biggest = max(v.numel() * 4 for v in c.master.values())
    assert torch.cuda.max_memory_allocated() - before <= biggest
    lc = [float(c.train_batch(x)["loss"]) for x in batches[2:]]
    assert lc == la[2:]
    for k in a.master:
        assert torch.equal(a.master[k], c.master[k]), k
        assert torch.equal(a.params[k], c.params[k]), k
    assert c.global_steps == 4
    c.destroy()
