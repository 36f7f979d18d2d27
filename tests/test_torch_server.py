"""The port's paged serving path against the JAX package on the CPU, below
the server: the paged model functions, the block allocator and scheduler,
the speculation helpers, and the options this slice leaves out.

Sizes are the JAX serving tests' (tests/test_continuous_batching.py:21-31):
2 layers, ``n_embd`` 32, 4 heads, vocabulary 128, float32, block size 32.
Both packages start from the same weights (``params_from_numpy``) and the
same pool (``paged_cache_from_numpy``). Logits agree to 1e-4 absolute
(float32 products and softmaxes summed in other orders over two layers);
the k/v the steps write into the pool to 1e-5. Block 0, the null block, is
garbage by contract and is not compared. The server-level parity matrix is
in test_torch_server_parity.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.inference import scheduler as jsched
from deepspeed_tpu.inference import speculation as jspec
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu.telemetry import MetricRegistry as JaxRegistry
from deepspeed_tpu_torch.inference import kv_cache as tkv
from deepspeed_tpu_torch.inference import scheduler as tsched
from deepspeed_tpu_torch.inference import speculation as tspec
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import (paged_cache_from_numpy,
                                               params_from_numpy)
from deepspeed_tpu_torch.telemetry import MetricRegistry

TOL = 1e-4
V, NB, BS, MB = 128, 12, 32, 4
TABLES = np.array([[3, 5, 0, 0], [1, 2, 7, 9], [11, 4, 6, 0]], np.int32)
VARIANTS = {
    "gpt2": dict(),
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False),
    "alibi": dict(positional="alibi"),
    "windowed": dict(local_windows=(None, 4)),
}


def _pair(variant, seed=0):
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=V, n_positions=256, n_embd=32, n_layer=2, n_head=4,
        dtype=jnp.float32, **VARIANTS[variant])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), "cpu",
                                             torch.float32)


def _pools(jcfg, lengths, seed=1):
    """A random pool in both packages: S=3 slots over TABLES."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layer, NB, BS, jcfg.kv_heads, jcfg.head_dim)
    jc = jkv.PagedKVCache(
        k=jnp.asarray(rng.standard_normal(shape, np.float32)),
        v=jnp.asarray(rng.standard_normal(shape, np.float32)),
        block_tables=jnp.asarray(TABLES),
        lengths=jnp.asarray(np.asarray(lengths, np.int32)))
    return jc, paged_cache_from_numpy(jax.device_get(jc), "cpu",
                                      torch.float32)


def _close(tc, jc, tl, jl):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy()[:, 1:], np.asarray(b)[:, 1:],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_prefill_and_decode_steps_match_jax(variant):
    """paged_prefill into slot 1, then three paged_decode_steps over all
    slots (slot 2 idle), from one pool."""
    jcfg, jp, tcfg, tp = _pair(variant)
    jc, tc = _pools(jcfg, [40, 0, 0])
    ids = np.random.default_rng(2).integers(0, V, (1, 64)).astype(np.int32)
    jl, jc = jt.paged_prefill(jp, jcfg, jnp.asarray(ids),
                              jnp.asarray([37], jnp.int32), jc, jnp.int32(1))
    tl, tc = tt.paged_prefill(tp, tcfg, torch.from_numpy(ids).long(), 37, tc,
                              1)
    _close(tc, jc, tl, jl)
    active = np.array([True, True, False])
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tok = np.resize(tok, 3)
        jl, jc = jt.paged_decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                      jnp.asarray(active))
        tl, tc = tt.paged_decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                      tc, torch.from_numpy(active))
        _close(tc, jc, tl, jl)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_prefill_chunk_matches_jax(variant):
    """Two chunks of one prompt in slot 1: the second attends the first
    through the table; the final one's logits are the prompt's last
    token's."""
    jcfg, jp, tcfg, tp = _pair(variant)
    jc, tc = _pools(jcfg, [40, 0, 17])
    prompt = np.random.default_rng(3).integers(0, V, 50).astype(np.int32)
    for start in (0, 32):
        ids = np.zeros((1, 32), np.int32)
        n = min(50 - start, 32)
        ids[0, :n] = prompt[start:start + n]
        jl, jc = jt.paged_prefill_chunk(
            jp, jcfg, jnp.asarray(ids), jnp.int32(start),
            jnp.asarray([50], jnp.int32), jc, jnp.int32(1))
        tl, tc = tt.paged_prefill_chunk(tp, tcfg, torch.from_numpy(ids).long(),
                                        start, 50, tc, 1)
        _close(tc, jc, tl, jl)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_verify_step_matches_jax(variant):
    """K=4 candidates for every slot; lengths are not advanced."""
    jcfg, jp, tcfg, tp = _pair(variant)
    jc, tc = _pools(jcfg, [40, 100, 0])
    toks = np.random.default_rng(4).integers(0, V, (3, 4)).astype(np.int32)
    jl, jc = jt.paged_verify_step(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = tt.paged_verify_step(tp, tcfg, torch.from_numpy(toks).long(), tc)
    _close(tc, jc, tl, jl)


@pytest.mark.parametrize("variant", ["gpt2", "windowed"])
def test_paged_decode_step_never_reaches_the_dense_decode(variant,
                                                          monkeypatch):
    """Causal layers take the paged wrapper, windowed ones the gather +
    plain path; neither reaches the dense decode kernel's wrapper."""
    jcfg, _, tcfg, tp = _pair(variant)
    _, tc = _pools(jcfg, [40, 5, 0])

    def dense(*args, **kwargs):
        raise AssertionError("a paged step reached the dense decode")

    monkeypatch.setattr(tt, "decode_attention", dense)
    tt.paged_decode_step(tp, tcfg, torch.zeros(3, dtype=torch.long), tc,
                         torch.ones(3, dtype=torch.bool))


# ------------------------------------------------- allocator and scheduler


def _ops(seed):
    """A seeded op sequence over a tight prefix-caching pool: submits
    (some sharing a prefix), admissions, prefix commits, releases and
    preemptions."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, V, 70).tolist()
    ops = []
    for i in range(60):
        r = rng.random()
        if r < 0.35:
            if rng.random() < 0.5:
                prompt = shared[:int(rng.integers(33, 70))]
            else:
                prompt = rng.integers(0, V, int(rng.integers(1, 90))).tolist()
            ops.append(("submit", i, prompt, int(rng.integers(1, 40)),
                        int(rng.integers(0, 3))))
        elif r < 0.7:
            ops.append(("admit",))
        elif r < 0.85:
            ops.append(("release", int(rng.integers(0, 3))))
        else:
            ops.append(("preempt", int(rng.integers(0, 3))))
    return ops


def _run_ops(mod, registry, ops):
    sched = mod.Scheduler(num_slots=3, num_blocks=13, block_size=BS,
                          max_blocks_per_slot=5, max_queued_requests=64,
                          registry=registry, enable_prefix_caching=True,
                          spec_margin=1)
    log, tick = [], 0
    for op in ops:
        tick += 1
        if op[0] == "submit":
            _, rid, prompt, new, prio = op
            try:
                sched.submit(mod.Request(request_id=rid, prompt=prompt,
                                         max_new_tokens=new, priority=prio))
                log.append(("queued", rid))
            except (ValueError, RuntimeError) as e:
                log.append(("rejected", rid, type(e).__name__))
        elif op[0] == "admit":
            adm = sched.admit_next(tick)
            if adm is not None:
                slot, st = adm
                st.generated.append(7)
                sched.commit_prefix(st)
                log.append(("admitted", slot, st.request.request_id,
                            tuple(st.blocks), st.cached_blocks))
        elif op[0] in ("release", "preempt") and op[1] in sched.slots:
            if op[0] == "release":
                sched.release(op[1])
            else:
                sched.preempt(op[1], tick, 2)
            log.append((op[0], op[1]))
        a = sched.allocator
        log.append((a.free_blocks, a.live_blocks, a.cached_blocks,
                    a.evictions, sched.prefix_hits, sched.prefix_misses,
                    len(sched.queue)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_and_allocator_match_jax_under_one_op_sequence(seed):
    ops = _ops(seed)
    want = _run_ops(jsched, JaxRegistry(), ops)
    got = _run_ops(tsched, MetricRegistry(), ops)
    assert got == want
    assert any(e[0] == "admitted" and e[4] > 0 for e in got
               if isinstance(e[0], str))


def test_allocator_refcounts_and_errors_match_jax():
    for allocator in (jkv.BlockAllocator, tkv.BlockAllocator):
        a = allocator(6, enable_prefix_caching=True)
        b = a.allocate(3)
        assert b == [1, 2, 3]
        assert a.register_prefix(b[0], b"h0")
        a.release(b)
        assert a.free_blocks == 5 and a.cached_blocks == 1
        assert a.match_prefix([b"h0", b"h1"]) == [1]
        with pytest.raises(ValueError, match="null block"):
            a.release([0])
        with pytest.raises(ValueError, match="double free"):
            a.release([2])
        assert a.allocate(6) is None


# ------------------------------------------------------------ speculation


def test_lookup_and_greedy_accept_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        hist = rng.integers(0, 6, int(rng.integers(1, 40))).tolist()
        for k in (1, 3, 5):
            assert tspec.lookup_proposals_host(hist, k) == \
                jspec.lookup_proposals_host(hist, k)
        ti, ji = tspec.LookupIndex(hist[:3]), jspec.LookupIndex(hist[:3])
        for t in hist[3:]:
            ti.extend([t])
            ji.extend([t])
            assert ti.proposals(3) == ji.proposals(3)
        t_row = rng.integers(0, 3, 4).tolist()
        props = rng.integers(0, 3, 3).tolist()
        assert tspec.greedy_accept_host(t_row, props) == \
            jspec.greedy_accept_host(t_row, props)


# --------------------------------------------------- left out of the slice


def _engine(**knobs):
    _, _, tcfg, tp = _pair("gpt2")
    return InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(
        dtype="float32", max_out_tokens=256, block_size=32, num_slots=2,
        **knobs), device="cpu")


@pytest.mark.parametrize("case", ["int8", "host_offload"])
def test_kv_tiering_options_build(case):
    """int8 pools and the host tier are ported: the server builds them
    (tests/test_torch_server_parity.py serves through them)."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    knobs = {"int8": dict(kv_cache_dtype="int8"),
             "host_offload": dict(kv_host_offload=True,
                                  enable_prefix_caching=True)}[case]
    srv = ContinuousBatchingServer(_engine(**knobs))
    tier = srv.stats["kv_tier"]
    assert srv._cache.quantized == (case == "int8")
    assert tier["host_offload"] == (case == "host_offload")
    alloc = srv.scheduler.allocator
    assert (alloc.on_demote is not None) == (case == "host_offload")
    srv.close()


@pytest.mark.parametrize("case", [
    "draft_engine", "speculation_draft",
    "supervised", "role", "handoff_import",
    "export_prefix", "import_prefix", "tp_mesh"])
def test_out_of_slice_options_raise_not_implemented(case):
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    knobs = {
        "draft_engine": dict(speculation_tokens=4),
        "speculation_draft": dict(speculation_tokens=4),
    }.get(case, {})
    sharded = None
    if case in ("draft_engine", "speculation_draft", "tp_mesh"):
        # draft-model speculation is ported; a draft over a
        # sequence-sharded KV cache is not. tp/sp meshes are ported
        # (tests/test_torch_tp_serving.py); a server over a seq-sharded
        # cache is refused with JAX's message
        _, _, tcfg, tp = _pair("gpt2")
        sharded = InferenceEngine(
            (dataclasses.replace(tcfg, seq_shard_kv=True), tp),
            DeepSpeedInferenceConfig(dtype="float32"), device="cpu")
    kwargs = {"draft_engine": dict(draft_engine=sharded),
              "supervised": dict(supervised=True),
              "role": dict(role="prefill"),
              "handoff_import": dict(handoff_import=True)}.get(case, {})
    match = "seq-sharded KV cache" if case == "tp_mesh" else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        eng = sharded if case == "tp_mesh" else _engine(**knobs)
        if case == "speculation_draft":
            eng.config.speculation_draft = sharded
        srv = ContinuousBatchingServer(eng, **kwargs)
        if case == "export_prefix":
            srv.export_prefix([b"h"])
        elif case == "import_prefix":
            srv.import_prefix([])
