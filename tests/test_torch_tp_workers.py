"""Rank programs of the tensor- and sequence-parallel tests, and the
tests of them that need no JAX.

This file imports no JAX: the ranks import it to find their program
(``tests/test_torch_dist_workers.py``'s ``run_ranks``, which forks them
from a fork server that preloaded it). ``tests/test_torch_tp_serving.py``
and ``tests/test_torch_tp_training.py`` hold what the ranks return to the
JAX package on a host mesh of the same shape.

The serving programs build an engine (and a server) per case from a
numpy tree of the JAX layout, cut to the rank's shard by the engine. The
training programs start an engine per case from a flat numpy tree,
whole, and return the metrics and the gathered whole master.
"""
from __future__ import annotations

import numpy as np
import torch

import test_torch_dist_workers as W

SERVE = dict(vocab_size=128, n_positions=256, n_embd=32, n_layer=2,
             n_head=4)
VARIANTS = {
    "gpt2": dict(),
    "gqa": dict(positional="rotary", norm_type="rmsnorm", gated_mlp=True,
                activation="silu", n_kv_head=2, tied_lm_head=False),
    "parallel": dict(positional="rotary", rotary_dim=4,
                     parallel_attn_mlp=True),
    "mqa": dict(positional="rotary", norm_type="rmsnorm", gated_mlp=True,
                activation="silu", n_kv_head=1, tied_lm_head=False),
}
PROMPTS = [[1, 2, 3, 4], [7, 8], [5, 6, 7, 8, 9, 10], [11, 12, 13]]
SERVE_PROMPTS = PROMPTS + [[20, 21], [30], [40, 41, 42, 43, 44], [50, 51]]
SHARED = [1 + (i * 7) % 120 for i in range(70)]
REPETITIVE = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5], [9, 8, 7, 9, 8],
              [4, 4, 4, 4]]
# a prompt across the two blocks of a 128-position cache split over seq 2
LONG = [list(range(1, 61)), [5, 6, 7]]


def serve_params(variant, seed=0, n_layer=2):
    """A serving tree of the JAX layout from numpy: N(0, 1) / sqrt(fan_in)
    weights (JAX's ``init_params`` scheme), biases of 0.02 (so a bias
    added on every rank would show), norm scales near 1."""
    from deepspeed_tpu_torch.model_implementations import transformer as tt
    cfg = tt.InferenceTransformerConfig(**{**SERVE, "n_layer": n_layer},
                                        **VARIANTS[variant],
                                        dtype=torch.float32)
    shapes = tt.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(seed)

    def draw(path, t):
        if isinstance(t, dict):
            return {k: draw(f"{path}.{k}", v) for k, v in t.items()}
        if isinstance(t, list):
            return [draw(path, v) for v in t]
        shape = tuple(t.shape)
        leaf = path.rsplit(".", 1)[-1]
        if leaf == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf.startswith("b") or leaf == "bias":
            x = 0.02 * rng.standard_normal(shape)
        else:
            fan = shape[0] * (shape[1] if leaf == "wo" and len(shape) == 3
                              else 1)
            x = rng.standard_normal(shape) / np.sqrt(
                SERVE["n_embd"] if leaf in ("wte", "wpe") else fan)
        return x.astype(np.float32)
    return draw("", shapes)


def _engine(variant, params, conf, n_layer=2):
    from deepspeed_tpu_torch.inference import (DeepSpeedInferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.model_implementations import transformer as tt
    from deepspeed_tpu_torch.module_inject import params_from_numpy
    cfg = tt.InferenceTransformerConfig(**{**SERVE, "n_layer": n_layer},
                                        **VARIANTS[variant],
                                        dtype=torch.float32)
    return InferenceEngine((cfg, params_from_numpy(params, "cpu",
                                                   torch.float32)),
                           DeepSpeedInferenceConfig(**conf), device="cpu")


def _server_drive(srv, kind):
    """Submits and drains as ``tests/test_torch_server_parity.py`` does;
    the outputs by submit order."""
    if kind == "prefix":
        prompts = [SHARED + [100 + i] * (i + 1) for i in range(4)]
        ids = [srv.submit(prompts[0], max_new_tokens=6)]
        for _ in range(4):
            srv.step()
        ids += [srv.submit(p, max_new_tokens=6) for p in prompts[1:]]
    elif kind == "repetitive":   # prompt lookup finds proposals
        ids = [srv.submit(p, max_new_tokens=10) for p in REPETITIVE]
    else:
        ids = [srv.submit(p, max_new_tokens=8) for p in SERVE_PROMPTS]
    res = srv.drain()
    return [res[i] for i in ids]


def serve_case(variant, params, conf, mode, draft=None, prompts=None):
    """One serving case on this rank: ``generate``'s tokens and the full
    forward's logits, or a server's outputs; and the shapes the rank
    holds."""
    eng = _engine(variant, params, conf)
    out = {"wq": tuple(eng.params["layers"][0]["attn"]["wq"]["q"].shape
                       if isinstance(eng.params["layers"][0]["attn"]["wq"],
                                     dict)
                       else eng.params["layers"][0]["attn"]["wq"].shape)}
    if mode == "generate":
        prompts = prompts or PROMPTS
        out["tokens"] = eng.generate(prompts, max_new_tokens=8)
        out["cache"] = tuple(eng._kept[1].k.shape)
        out["logits"] = eng.forward(pad(prompts)).float().numpy()
        return out
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    d = None
    if draft is not None:
        d = _engine(draft[0], draft[1], conf, n_layer=1)
    srv = ContinuousBatchingServer(eng, draft_engine=d)
    out["outputs"] = _server_drive(srv, mode)
    out["pool"] = tuple(srv._cache.k.shape)
    out["stats"] = {k: srv.stats[k] for k in ("decode_traces",
                                              "prefix_cache_hits")}
    return out


def pad(prompts):
    n = max(map(len, prompts))
    return np.array([p + [0] * (n - len(p)) for p in prompts])


def serve_runs(rank, ws, out_dir, cases):
    return {name: serve_case(**spec) for name, spec in cases.items()}


def refusals(rank, ws, out_dir, params):
    """The refusals of a process group's serving mesh, by message."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    catch("tp_heads", lambda: _engine("mqa", serve_params("mqa"), dict(
        dtype="float32", tensor_parallel={"tp_size": 2})))
    sp = _engine("gpt2", params, dict(dtype="float32", sp_size=2,
                                      max_out_tokens=256))
    catch("server_seq", lambda: ContinuousBatchingServer(sp))
    catch("chunk_seq", lambda: sp.generate_speculative(
        [[1, 2, 3]], draft=None, max_new_tokens=4))
    tp = _engine("gpt2", params, dict(dtype="float32",
                                      tensor_parallel={"tp_size": 2}))
    srv = ContinuousBatchingServer(tp)
    catch("deadline", lambda: srv.submit([1, 2], deadline_s=5.0))
    return out


# ---------------------------------------------------------------------------
# Tests that need no JAX
# ---------------------------------------------------------------------------

def test_tp2_generate_equals_one_process(tmp_path):
    """The GQA model at tp 2 gives the one-process engine's tokens, and
    each rank holds half the heads and half the cache."""
    params = serve_params("gqa")
    conf = dict(dtype="float32", max_out_tokens=256)
    one = serve_case("gqa", params, conf, "generate")
    ranks = W.run_ranks(serve_runs, 2, tmp_path, {"g": dict(
        variant="gqa", params=params, mode="generate",
        conf=dict(conf, tensor_parallel={"tp_size": 2}))})
    for r in ranks:
        g = r["g"]
        assert g["tokens"] == one["tokens"]
        np.testing.assert_allclose(g["logits"], one["logits"], rtol=1e-4,
                                   atol=1e-5)
        assert g["wq"] == (32, 2, 8) and g["cache"][3] == 1


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_model(kind, dtype="float32", **kw):
    """The port's training model ``kind`` at the tiny sizes of its JAX
    parity tests."""
    dt = getattr(torch, dtype)
    if kind == "gpt2":
        from deepspeed_tpu_torch.models import gpt2
        return gpt2.GPT2LMModel(gpt2.GPT2Config(**W.TINY, dtype=dt, **kw))
    if kind == "llama":
        from deepspeed_tpu_torch.models import llama
        return llama.LlamaLMModel(llama.LlamaConfig(**LLAMA, dtype=dt,
                                                    **kw))
    from deepspeed_tpu_torch.models import bert
    return bert.BertPreTrainingModel(bert.BertConfig(**BERT, dtype=dt,
                                                     **kw))


LLAMA = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
             n_kv_head=2, intermediate_size=96)
BERT = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def dp_rows(batch, eng):
    """The engine's data-parallel rows of a global batch (every tensor and
    seq rank of one data index takes the same rows)."""
    rows = next(iter(batch.values())).shape[0] // eng.dp
    i = eng._dp_index
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def train_case(kind, params, ds, batches, dtype="float32", model_kw=None,
               first=0, steps=None, tag_dir=None, save_after=None,
               load=False):
    """One engine over ``batches[first:steps]``: the metrics, the whole
    master and params (gathered), and the shapes the rank holds."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.mesh import mesh_shape
    model = train_model(kind, dtype, **(model_kw or {}))
    eng = deepspeed_tpu_torch.initialize(
        model=model, model_parameters={k: torch.tensor(v)
                                       for k, v in params.items()},
        config=dict(ds), device="cpu")[0]
    out = {"loss": [], "grad_norm": [],
           # the whole tree gathered from the shards, before any step
           "init": {k: v.float().numpy() for k, v in
                    eng.module_state_dict().items()}}
    if load:
        eng.load_checkpoint(tag_dir)
    for i, b in enumerate(batches[first:steps]):
        m = eng.train_batch(dp_rows(b, eng))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if save_after is not None and i + 1 == save_after:
            eng.save_checkpoint(tag_dir)
    out["master"] = {k: v.numpy() for k, v in
                     eng.fp32_master_params().items()}
    out["params"] = {k: v.float().numpy() for k, v in
                     eng.module_state_dict().items()}
    out["local"] = {k: tuple(p.shape) for k, p in eng.params.items()}
    out["mesh"] = {a: n for a, n in mesh_shape(eng.mesh).items() if n > 1}
    return out


def train_runs(rank, ws, out_dir, runs):
    """``runs``: ``{name: kwargs of train_case}``; a ``tag_dir`` is
    relative to ``out_dir`` unless absolute."""
    import os
    out = {}
    for name, kw in runs.items():
        kw = dict(kw)
        if "tag_dir" in kw:
            kw["tag_dir"] = os.path.join(out_dir, kw["tag_dir"])
        out[name] = train_case(**kw)
    return out


def loss_program(rank, ws, out_dir, logits, labels):
    """The vocab-parallel loss on this rank's columns of ``logits``, its
    value and the gradient of the rank's columns."""
    from deepspeed_tpu_torch.comm import mesh
    from deepspeed_tpu_torch.parallel import tensor_parallel as tp
    mesh.set_global_mesh(mesh.build_mesh(mesh.MeshConfig(data=1,
                                                         tensor=ws)))
    n = logits.shape[-1] // ws
    x = torch.tensor(logits[..., rank * n:(rank + 1) * n],
                     requires_grad=True)
    y = torch.tensor(labels)
    nll = tp.vocab_parallel_nll(x, y.clamp(0, logits.shape[-1] - 1))
    mask = (y >= 0) & (y < logits.shape[-1] - 3)
    loss = (nll * mask).sum() / mask.sum()
    loss.backward()
    return {"loss": float(loss.detach()), "grad": x.grad.numpy()}


def save_program(rank, ws, out_dir, params):
    """A tp-2 engine's serving checkpoint, written under ``out_dir``."""
    import os

    from deepspeed_tpu_torch.inference.engine import save_serving_checkpoint
    eng = _engine("gqa", params, dict(dtype="float32",
                                      tensor_parallel={"tp_size": ws}))
    save_serving_checkpoint(eng, os.path.join(out_dir, "ck"))
    return {}


def test_tp2_serving_checkpoint_holds_whole_leaves(tmp_path):
    """Saved from tp 2 ranks, the serving checkpoint holds the whole
    leaves, bit for bit the one-process engine's."""
    from deepspeed_tpu_torch.inference.engine import save_serving_checkpoint
    from deepspeed_tpu_torch.utils.safetensors_io import load_file
    params = serve_params("gqa")
    save_serving_checkpoint(_engine("gqa", params, dict(dtype="float32")),
                            str(tmp_path / "one"))
    W.run_ranks(save_program, 2, tmp_path, params)
    one = load_file(str(tmp_path / "one" / "serving.safetensors"))
    two = load_file(str(tmp_path / "save_program_2" / "ck" /
                        "serving.safetensors"))
    assert set(one) == set(two)
    for k, v in one.items():
        assert torch.equal(two[k], v), k
