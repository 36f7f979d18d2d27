"""Tensor-parallel serving on the card: two gloo ranks on one H100.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX (nor the
tests' conftest), so it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp.py -q

NCCL refuses two ranks on one device, so the two ranks join a gloo group
(``tests/test_torch_dist_workers.py``'s ``run_ranks``) and every
collective moves CUDA tensors through the host; the steps run eagerly
(a graph cannot capture a host collective). A tiny GQA model (2 layers,
256 wide, 4 heads of 64 over 2 KV heads, float32) serves at tp 2: each
rank's ``generate`` and server give the tokens of the one-process engine
over the same weights, and each rank's counts show B1, B4 and B5
launched on its 2 query heads over 1 KV head.
"""
import pytest
import torch

import test_torch_dist_workers as W

CFG = dict(vocab_size=512, n_positions=256, n_embd=256, n_layer=2, n_head=4,
           n_kv_head=2, positional="rotary", norm_type="rmsnorm",
           gated_mlp=True, activation="silu", tied_lm_head=False)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11, 12, 13, 14, 15], [20, 21, 22]]
NEW = 8
CONF = dict(dtype="float32", max_out_tokens=256, num_slots=4, block_size=32)


def _serve(tp):
    """The engine at ``tp`` from seeded weights on the card: generate's
    tokens and counts, the server's tokens and counts, the heads held."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    from deepspeed_tpu_torch.ops import launch_counters
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = InferenceTransformerConfig(**CFG, dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    extra = {"tensor_parallel": {"tp_size": tp}} if tp > 1 else {}
    eng = deepspeed_tpu_torch.init_inference((cfg, params), **CONF, **extra)
    fns = launch_counters()

    def counts(reset=False):
        if reset:
            for f in fns.values():
                f.launches = 0
        return {n: f.launches for n, f in fns.items()}
    counts(reset=True)
    out = {"generate": eng.generate(PROMPTS, max_new_tokens=NEW)}
    out["generate_counts"] = counts()
    srv = ContinuousBatchingServer(eng)
    counts(reset=True)
    ids = [srv.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    res = srv.drain()
    out["server"] = [res[i] for i in ids]
    out["server_counts"] = counts()
    out["decode_traces"] = srv.stats["decode_traces"]
    out["graphs"] = eng._cuda_graphs
    a = eng.params["layers"][0]["attn"]
    out["heads"] = (a["wq"].shape[1], a["wk"].shape[1])
    srv.close()
    return out


def tp_program(rank, ws, out_dir):
    return _serve(ws)


@pytest.mark.cuda
def test_tp2_on_two_gloo_ranks_equals_tp1(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    one = _serve(1)
    ranks = W.run_ranks(tp_program, 2, tmp_path)
    L = CFG["n_layer"]
    for r in ranks:
        assert r["generate"] == one["generate"]
        assert r["server"] == one["server"]
        assert r["heads"] == (2, 1) and one["heads"] == (4, 2)
        assert not r["graphs"] and r["decode_traces"] == 0
        g, s = r["generate_counts"], r["server_counts"]
        assert g["flash_attention_fwd"] == L
        assert g["decode_attention"] == L * (NEW - 1)
        assert s["flash_attention_fwd"] > 0 and s["decode_attention"] == 0
        assert s["paged_decode_attention"] > 0
        assert s["paged_decode_attention"] % L == 0
