"""The JAX package's parameter tree and paged KV pool → the port's
tensors.

``deepspeed_tpu.model_implementations.transformer`` keeps its weights as a
nested dict/list pytree (``wte``, ``wpe``, ``ln_f``, ``lm_head``,
``layers[i].{ln1, attn.{wq, wk, wv, bq, bk, bv, wo, bo}, mlp.{wi, bi, wo,
bo}, ln2}``). The port's transformer reads the same keys with the same
shapes, so converting the leaves is all it takes for both to compute the
same function. :func:`paged_cache_from_numpy` does the same for a
``PagedKVCache`` (int8 pools with their scale tiles too), so both packages
can start a step from one pool, and
:func:`gpt2_params_from_flax` for the training GPT-2's flax params (with
its inverse :func:`gpt2_params_to_numpy`), :func:`llama_params_from_flax`
and :func:`bert_params_from_jax` for the training LLaMA's and BERT's, and
:func:`load_engine_state_from_numpy` carries a JAX training engine's state
(the master, the optimizer's moments and count, the loss scale and the
step counters) into a port engine. All take numpy arrays
(``jax.device_get``); this module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device=None, dtype=None):
    """Nested dict/list of numpy arrays → the same structure of tensors on
    ``device``; floating leaves are cast to ``dtype`` when given, except
    an int8 node's scales (``{"q", "scale"|"oscale"}``), which stay f32 as
    in JAX. bfloat16 arrays (``ml_dtypes``) go through float32, which
    holds them exactly."""
    if isinstance(tree, dict):
        if "q" in tree:
            dtype = None
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    a = np.array(tree)   # a writable copy: device_get may return read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def paged_cache_from_numpy(cache, device=None, dtype=None):
    """A JAX ``PagedKVCache`` whose leaves are numpy arrays (any object
    with ``k``, ``v``, ``block_tables`` and ``lengths``, and the scale
    tiles ``k_scale``/``v_scale`` of an int8 pool) → the port's
    :class:`~deepspeed_tpu_torch.inference.kv_cache.PagedKVCache`. ``dtype``
    casts an fp pool; an int8 payload stays int8 and its scales f32."""
    from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache
    k, v = (params_from_numpy(x, device, dtype) for x in (cache.k, cache.v))
    tables, lengths = (params_from_numpy(x, device).to(torch.int32)
                       for x in (cache.block_tables, cache.lengths))
    scales = {f: params_from_numpy(getattr(cache, f), device).float()
              for f in ("k_scale", "v_scale")
              if getattr(cache, f, None) is not None}
    return PagedKVCache(k=k, v=v, block_tables=tables, lengths=lengths,
                        **scales)


def _flat(tree: Any, prefix: str = "") -> dict:
    """A nested dict (or list) of leaves → ``{dotted path: leaf}`` (the
    port's parameter names; a list's items by index); a flat dict passes
    through."""
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if hasattr(v, "items") or isinstance(v, (list, tuple)):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def gpt2_params_from_flax(tree: Any, device=None, dtype=None):
    """A JAX training model's nested params (numpy leaves, from
    ``jax.device_get``) → the port's flat dict of tensors, keyed by the
    paths joined with dots (GPT-2's ``h_0.attn.c_attn.kernel``, LLaMA's
    ``layers_0.attn.wq.kernel``, BERT's ``layers.0.attn_qkvw``: its
    ``layers`` list by index). The port keeps JAX's layouts, so nothing is
    transposed; leaves keep their dtypes unless ``dtype`` is given."""
    return {k: params_from_numpy(v, device, dtype)
            for k, v in _flat(tree).items()}


# the training LLaMA's and BERT's trees flatten the same way
llama_params_from_flax = bert_params_from_jax = gpt2_params_from_flax


def gpt2_params_to_numpy(params) -> dict:
    """The inverse of :func:`gpt2_params_from_flax`: a flat dict of
    tensors → the flax nested dict of numpy arrays (floating leaves as
    float32), to compare with the JAX model's params."""
    tree: dict = {}
    for name, t in params.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.is_floating_point() else t).numpy()
    return tree


def load_engine_state_from_numpy(engine, state: dict) -> None:
    """Install a JAX training engine's state into a port
    ``DeepSpeedEngine`` built on the same model and config, so the port
    continues the JAX run. ``state`` holds numpy leaves:

    * ``master`` — the f32 weights (``state.master``, or ``state.params``
      in fp32), nested as the flax params or flat by dotted name;
    * ``opt_state`` — the optimizer state's fields: ``count`` and the
      moment trees (``mu``/``nu``, or ``accum``), nested like ``master``;
    * ``loss_scale`` — ``scale``, ``growth_tracker`` and ``hysteresis``;
    * ``global_steps``, ``skipped_steps`` and ``micro_steps``.

    The compute params are cast from the master by the step's own cast."""
    import dataclasses

    def host(tree):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in _flat(tree).items()}

    opt = {"type": type(engine.opt_state).__name__}
    for f in dataclasses.fields(engine.opt_state):
        v = state["opt_state"].get(f.name)
        if v is not None:
            opt[f.name] = host(v) if hasattr(v, "items") else int(np.asarray(v))
    ls = state["loss_scale"]
    engine._load_checkpoint_state({
        "master": host(state["master"]),
        "optimizer": opt,
        "loss_scale": {
            "scale": torch.tensor(float(np.asarray(ls["scale"])),
                                  dtype=torch.float32),
            "growth_tracker": torch.tensor(
                int(np.asarray(ls["growth_tracker"])), dtype=torch.int32),
            "hysteresis": torch.tensor(int(np.asarray(ls["hysteresis"])),
                                       dtype=torch.int32)}})
    engine.global_steps = int(state["global_steps"])
    engine.skipped_steps = int(state["skipped_steps"])
    engine._micro_steps = int(state["micro_steps"])
