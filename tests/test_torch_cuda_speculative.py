"""Speculative decoding, beam search and the draft-model server as CUDA
graphs, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: a CUDA graph has no CPU mode. The
file imports no JAX (nor the tests' conftest, which does), so it runs on
the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_speculative.py -q

A small bf16 target (2 layers, 4 heads of 64) and a smaller draft (1
layer, 2 heads of 64) over one vocabulary:

* the verify chunk replayed gives the eager chunk's logits bit for bit,
  from the same state, and its attention reads a bf16 cache without an
  f32 copy;
* ``generate_speculative`` (a draft, the target as its own draft, prompt
  lookup) gives the same tokens and stats with and without its graphs,
  and the target as its own draft keeps two caches;
* beams give the same tokens with and without the decode graph, and the
  parent reorder keeps the cache's addresses, while a reorder that
  rebinds the cache's tensors raises at the next replay;
* the draft-model server captures one graph of each kind (verify, draft
  decode), launches the paged decode kernel on the draft pool and the
  verify kernel on the target's, and serves the eager control's tokens;
* ``profile_model_time`` times ``forward`` calls with CUDA events.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import ContinuousBatchingServer
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, _chunk_attention, decode_chunk, init_params,
    prefill)
from deepspeed_tpu_torch.ops import launch_counters

L = 2
VOCAB = 512
K = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _engine(n_embd=256, n_layer=L, n_head=4, seed=0, **knobs):
    cfg = InferenceTransformerConfig(vocab_size=VOCAB, n_positions=512,
                                     n_embd=n_embd, n_layer=n_layer,
                                     n_head=n_head)
    params = init_params(torch.Generator(device="cuda").manual_seed(seed),
                         cfg)
    conf = dict(dtype="bfloat16", block_size=32, max_out_tokens=256,
                num_slots=4)
    conf.update(knobs)
    return deepspeed_tpu_torch.init_inference((cfg, params), **conf)


def _draft():
    return _engine(n_embd=128, n_layer=1, n_head=2, seed=1)


def _prompts(seed, n=4):
    rng = np.random.default_rng(seed)
    phrase = rng.integers(1, VOCAB, 12).tolist()
    return [rng.integers(1, VOCAB, int(k)).tolist() + phrase * int(r)
            for k, r in zip(rng.integers(1, 40, n), rng.integers(1, 4, n))]


@pytest.mark.cuda
def test_graphed_verify_chunk_matches_eager_bit_for_bit(cuda_device):
    eng = _engine()
    prompts = _prompts(1)
    ids = np.zeros((len(prompts), 128), np.int64)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    lens = torch.as_tensor([len(p) for p in prompts], device=cuda_device)
    toks = torch.randint(1, VOCAB, (len(prompts), K), device=cuda_device,
                         generator=torch.Generator(
                             device="cuda").manual_seed(2))
    with torch.inference_mode():
        cache = eng._make_cache(len(prompts), 256)
        prefill(eng.params, eng.model_config,
                torch.as_tensor(ids, device=cuda_device), lens, cache)
        verify = eng._chunk_fn(cache, K)
        outs = [verify(toks) for _ in range(3)]   # warm-up, capture, replay
        graph = eng._chunk_graph[1]
        ref = decode_chunk(eng.params, eng.model_config, toks, cache)[0]
    assert graph.captures == 1 and graph.replays == 2
    assert torch.equal(cache.lengths, lens.int())
    for out in outs:
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_verify_attention_reads_a_bf16_cache_without_copying_it(cuda_device):
    """The verify attention over a bf16 cache allocates far less than one
    f32 copy of its keys, and agrees with an f64 attention over the same
    bf16 values within one bf16 step."""
    g = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, KH, D = 4, 4096, 16, 8, 128
    q = torch.randn(B, K, H, D, device=cuda_device, generator=g).bfloat16()
    k, v = (torch.randn(B, S, KH, D, device=cuda_device,
                        generator=g).bfloat16() for _ in range(2))
    lengths = torch.tensor([0, 100, 2000, S - K], device=cuda_device)
    cfg = InferenceTransformerConfig(vocab_size=VOCAB, n_positions=S,
                                     n_embd=H * D, n_layer=1, n_head=H,
                                     n_kv_head=KH)
    _chunk_attention(q, k, v, lengths, cfg)   # the GEMMs' workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = _chunk_attention(q, k, v, lengths, cfg)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < k.numel() * 4 // 2, extra
    kr = k.double().repeat_interleave(H // KH, dim=2)
    vr = v.double().repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bkhd,bshd->bhks", q.double(), kr) * cfg.scale
    qpos = lengths[:, None] + torch.arange(K, device=cuda_device)[None, :]
    pos = torch.arange(S, device=cuda_device)
    s = s.masked_fill(pos >= (qpos + 1)[:, None, :, None], float("-inf"))
    ref = torch.einsum("bhks,bshd->bkhd", torch.softmax(s, -1), vr)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.double(), ref, rtol=2 ** -7, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["model", "self", "lookup"])
def test_speculative_graphed_equals_eager(cuda_device, draft):
    eng = _engine()
    d = {"model": _draft(), "self": eng, "lookup": None}[draft]
    prompts = _prompts(3)
    got = eng.generate_speculative(prompts, d, max_new_tokens=24,
                                   draft_tokens=K)
    stats = eng.last_speculative_stats
    assert eng._chunk_graph[1].captures == 1
    if d is not None:
        assert d._kept_draft[2].captures == 1 \
            and d._kept_draft[2].replays > 0
    eng._cuda_graphs = False
    if d is not None:
        d._cuda_graphs = False
    assert eng.generate_speculative(prompts, d, max_new_tokens=24,
                                    draft_tokens=K) == got
    assert eng.last_speculative_stats == stats
    if draft == "self":
        assert stats["tokens_per_round"] >= 3.5
        main, other = eng._kept[1], eng._kept_draft[1]
        assert main is not other and \
            main.k.data_ptr() != other.k.data_ptr()


@pytest.mark.cuda
def test_beams_graphed_equal_eager_and_keep_the_cache_in_place(cuda_device):
    eng = _engine()
    prompts = _prompts(4, n=2)
    got = eng.generate(prompts, max_new_tokens=16, num_beams=4)
    key, cache, graph = eng._kept
    assert key[0] == 8 and graph.captures == 1 and graph.replays > 0
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr(), cache.lengths.data_ptr())
    assert eng.generate(prompts, max_new_tokens=16, num_beams=4) == got
    assert eng._kept[1] is cache and graph.captures == 1
    assert (cache.k.data_ptr(), cache.v.data_ptr(),
            cache.lengths.data_ptr()) == ptrs
    eng._cuda_graphs = False
    assert eng.generate(prompts, max_new_tokens=16, num_beams=4) == got


@pytest.mark.cuda
def test_rebinding_reorder_raises_at_replay(cuda_device):
    """JAX writes the reorder as ``cache.k = cache.k[:, parent]``; over a
    captured graph that rebinding must fail loudly, not decode from freed
    memory."""
    eng = _engine()
    eng.generate(_prompts(5, n=2), max_new_tokens=6, num_beams=2)
    cache = eng._kept[1]
    step = eng._decode_fn(cache)
    parent = torch.tensor([1, 0, 3, 2], device=cuda_device)
    with torch.inference_mode():
        cache.k = cache.k[:, parent]
        with pytest.raises(RuntimeError, match="moved since the capture"):
            step(torch.zeros(4, dtype=torch.long, device=cuda_device))


def _serve(srv, prompts, new):
    ids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    out = srv.drain()
    return [out[i] for i in ids]


@pytest.mark.cuda
@pytest.mark.parametrize("async_loop", [True, False])
def test_draft_server_graphed_matches_eager(cuda_device, async_loop):
    prompts = _prompts(6, n=6)
    outs = []
    for graphs in (True, False):
        eng = _engine(speculation_tokens=K, async_loop=async_loop)
        srv = ContinuousBatchingServer(eng, draft_engine=_draft())
        srv._cuda_graphs = graphs
        for f in launch_counters().values():
            f.launches = 0
        outs.append(_serve(srv, prompts, 20))
        counts = {k: f.launches for k, f in launch_counters().items()}
        sp = srv.stats["speculation"]
        assert sp["draft"] == "model" and sp["accepted"] > 0
        assert counts["paged_decode_attention"] > 0
        assert counts["paged_verify_attention"] == L * (
            sp["verify_steps"] + srv.stats["async_loop"]["garbage_steps"])
        assert counts["decode_attention"] == 0
        if graphs:
            assert sp["verify_traces"] == 1 and sp["draft_decode_traces"] == 1
            assert sp["draft_prefill_traces"] == -1
            assert srv._graphs["draft_decode"].replays > 0
        else:
            assert not srv._graphs
        srv.close()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_profile_model_time_with_cuda_events(cuda_device):
    eng = _engine()
    with pytest.raises(AssertionError, match="profile_model_time"):
        eng.model_times()
    eng.profile_model_time()
    for _ in range(3):
        eng.forward(np.ones((2, 64), np.int64))
    times = eng.model_times()
    assert len(times) == 3 and all(0 < t < 10 for t in times)
    assert eng.model_times() == []
