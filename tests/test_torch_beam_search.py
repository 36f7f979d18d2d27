"""Beam search in the port against the JAX package on the CPU.

``generate(num_beams > 1)`` on the same model in both packages (float32,
2 layers, ``n_embd`` 64, vocab 256, the same weights drawn with numpy from
a seed) must give JAX ``_beam_loop``'s tokens, token for token: beams are
deterministic.
The cases cover ``length_penalty`` other than 1, a beam that ends on EOS
(frozen beams emitting pad 0 at an unchanged score), rotary/GQA, a padded
array with its ``attention_mask``, the validation errors with JAX's
messages, and the parent reorder writing into the kept cache in place.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.model_implementations import transformer as jt
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.model_implementations import transformer as tt
from deepspeed_tpu_torch.module_inject import params_from_numpy
from test_torch_speculative import numpy_params

V = 256
VARIANTS = {
    "gpt2": dict(),
    "gqa-rotary": dict(positional="rotary", norm_type="rmsnorm",
                       gated_mlp=True, activation="silu", n_kv_head=2,
                       tied_lm_head=False, intermediate_size=176),
}
PROMPTS = [[5, 9, 3, 17, 2], [11, 4], [7, 1, 7, 8]]


@functools.lru_cache(maxsize=None)
def _engines(variant="gpt2", seed=0):
    """(JAX engine, port engine) over the same weights, shared by the
    tests so that each JAX loop compiles once."""
    jcfg = jt.InferenceTransformerConfig(
        vocab_size=V, n_positions=256, n_embd=64, n_layer=2, n_head=4,
        dtype=jnp.float32, **VARIANTS[variant])
    jp = numpy_params(jcfg, seed)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tt.InferenceTransformerConfig(**fields, dtype=torch.float32)
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.float32)
    conf = dict(dtype="float32", max_out_tokens=512)
    return (JaxEngine((jcfg, jp), JaxConfig(**conf)),
            InferenceEngine((tcfg, tp), DeepSpeedInferenceConfig(**conf),
                            device="cpu"))


@pytest.mark.parametrize("variant,beams,penalty", [
    ("gpt2", 2, 1.0), ("gpt2", 4, 0.6), ("gqa-rotary", 3, 1.5)])
def test_beams_match_jax(variant, beams, penalty):
    jeng, peng = _engines(variant)
    kw = dict(max_new_tokens=12, num_beams=beams, length_penalty=penalty)
    assert peng.generate(PROMPTS, **kw) == jeng.generate(PROMPTS, **kw)


def test_beam_ending_on_eos_matches_jax():
    """A beam that emits EOS freezes (pad 0 at its score) while the others
    go on; the ranking by ``score / full_len ** penalty`` then chooses
    between finished and unfinished beams, as JAX's does."""
    jeng, peng = _engines()
    kw = dict(max_new_tokens=12, num_beams=2)
    base = jeng.generate(PROMPTS, **kw)
    # an EOS each row's best beam emits mid-way: a frozen beam
    ended = 0
    for eos in {row[len(p) + 3] for row, p in zip(base, PROMPTS)}:
        for lp in (0.5, 2.0):
            want = jeng.generate(PROMPTS, eos_token_id=eos,
                                 length_penalty=lp, **kw)
            assert peng.generate(PROMPTS, eos_token_id=eos,
                                 length_penalty=lp, **kw) == want
            ended += sum(len(r) < len(p) + 12 for r, p in zip(want, PROMPTS))
    assert ended > 0


def test_beams_padded_array_and_one_beam_equals_greedy():
    jeng, peng = _engines()
    ids = np.array([[5, 9, 3, 0, 0], [11, 4, 8, 8, 2]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5], np.int32)
    kw = dict(max_new_tokens=9, num_beams=2, attention_mask=mask)
    assert peng.generate(ids, **kw) == jeng.generate(ids, **kw)
    assert peng.generate(PROMPTS, max_new_tokens=6, num_beams=1) == \
        peng.generate(PROMPTS, max_new_tokens=6)


def test_beam_reorder_keeps_the_cache_in_place():
    """The beams' cache is the engine's kept cache, reordered by parent
    in place: a second call of the same shape reuses it at the same
    addresses."""
    _, peng = _engines()
    peng.generate(PROMPTS, max_new_tokens=12, num_beams=2)
    (key, cache, _) = peng._kept
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr(), cache.lengths.data_ptr())
    assert key[0] == len(PROMPTS) * 2
    peng.generate(PROMPTS, max_new_tokens=12, num_beams=2)
    assert peng._kept[1] is cache
    assert (cache.k.data_ptr(), cache.v.data_ptr(),
            cache.lengths.data_ptr()) == ptrs


def test_beam_validation_matches_jax():
    jeng, peng = _engines()
    cases = [(ValueError, "greedy scoring only", dict(temperature=0.7)),
             (ValueError, "greedy scoring only", dict(top_k=5)),
             (NotImplementedError, "not beam search",
              dict(repetition_penalty=1.3)),
             (NotImplementedError, "not beam search",
              dict(min_new_tokens=2))]
    for err, msg, kw in cases:
        for eng in (jeng, peng):
            with pytest.raises(err, match=msg):
                eng.generate([[1, 2]], max_new_tokens=4, num_beams=2, **kw)
