"""Megatron tensor-parallel shards in the port
(``deepspeed_tpu_torch/module_inject/megatron_shards.py``) against the JAX
package's ``megatron_shards.py``: the round trips and errors of JAX's
``tests/test_megatron_shards.py``, each case run through both packages'
functions on the same numpy arrays (the port's results are torch tensors,
JAX's numpy; the values must be equal)."""
import argparse
import os
import sys
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu.module_inject import megatron_shards as jms
from deepspeed_tpu_torch.checkpoint import import_deepspeed
from deepspeed_tpu_torch.module_inject import megatron_shards as tms
from deepspeed_tpu_torch.module_inject.state_dict_loader import (
    load_state_dict)

H = 8      # hidden
QKV_W = "language_model.transformer.layers.0.attention.query_key_value.weight"


def full_sd():
    rng = np.random.default_rng(0)
    pfx = "language_model.transformer.layers.0"
    shapes = {
        f"{pfx}.attention.query_key_value.weight": (3 * H, H),
        f"{pfx}.attention.query_key_value.bias": (3 * H,),
        f"{pfx}.attention.dense.weight": (H, H),
        f"{pfx}.attention.dense.bias": (H,),
        f"{pfx}.mlp.dense_h_to_4h.weight": (4 * H, H),
        f"{pfx}.mlp.dense_h_to_4h.bias": (4 * H,),
        f"{pfx}.mlp.dense_4h_to_h.weight": (H, 4 * H),
        f"{pfx}.mlp.dense_4h_to_h.bias": (H,),
        f"{pfx}.input_layernorm.weight": (H,),
        "language_model.embedding.word_embeddings.weight": (32, H),
    }
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def _same(port: dict, ref: dict):
    assert list(port) == list(ref)
    for k in ref:
        assert isinstance(port[k], torch.Tensor), k
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ver", [0, 1.0, 2.0])
def test_split_merge_round_trip(world, ver):
    sd = full_sd()
    shards = [tms.split_megatron_state_dict(sd, world, r,
                                            checkpoint_version=ver)
              for r in range(world)]
    for r, shard in enumerate(shards):
        _same(shard, jms.split_megatron_state_dict(sd, world, r,
                                                   checkpoint_version=ver))
    k = "language_model.transformer.layers.0.mlp.dense_h_to_4h.weight"
    assert shards[0][k].shape == (4 * H // world, H)
    merged = tms.merge_megatron_shards(shards, checkpoint_version=ver)
    _same(merged, jms.merge_megatron_shards(
        [{k: v.numpy() for k, v in s.items()} for s in shards],
        checkpoint_version=ver))
    _same(merged, sd)


def test_qkv_interleave_version0_differs_from_versioned():
    """Version-0 shards carry [q_i, k_i, v_i] stacked: a plain axis-0 cat
    scrambles roles and ``merge_qkv`` re-groups them; versions 1.0/2.0
    fuse per head, so there the plain cat is right."""
    w = full_sd()[QKV_W]
    parts = [tms.split_qkv(w, 2, r, 0) for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(parts[r].numpy(),
                                      jms.split_qkv(w, 2, r, 0))
    assert not np.allclose(torch.cat(parts).numpy(), w)
    fixed = tms.merge_qkv(parts, 0)
    np.testing.assert_array_equal(fixed.numpy(), w)
    np.testing.assert_array_equal(
        fixed.numpy(), jms.merge_qkv([p.numpy() for p in parts], 0))
    parts_v1 = [tms.split_qkv(w, 2, r, 1.0) for r in range(2)]
    np.testing.assert_array_equal(torch.cat(parts_v1).numpy(), w)


def test_qkv_unknown_version_raises():
    w = full_sd()[QKV_W]
    for mod in (tms, jms):
        with pytest.raises(ValueError, match="not supported"):
            mod.merge_qkv([w], 3.0)
        with pytest.raises(ValueError, match="not supported"):
            mod.split_qkv(w, 2, 0, 0.5)


def _save(blob, path):
    torch.save({k: ({n: torch.tensor(t) for n, t in v.items()}
                    if k == "model" else v) for k, v in blob.items()},
               str(path))


def test_missing_checkpoint_version_defaults_to_0(tmp_path):
    """A blob with NO checkpoint_version key is the legacy interleaved
    format (the reference's get_checkpoint_version defaults to 0)."""
    sd = full_sd()
    for r in range(2):
        shard = jms.split_megatron_state_dict(sd, 2, r, checkpoint_version=0)
        d = tmp_path / f"mp_rank_{r:02d}"
        d.mkdir()
        _save({"model": shard}, d / "model_optim_rng.pt")
    merged = tms.load_megatron_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(merged[QKV_W].numpy(), sd[QKV_W])
    _same(merged, jms.load_megatron_checkpoint(str(tmp_path)))


def test_replicated_mismatch_is_loud():
    sd = full_sd()
    shards = [jms.split_megatron_state_dict(sd, 2, r) for r in range(2)]
    k = "language_model.transformer.layers.0.input_layernorm.weight"
    shards[1][k] = shards[1][k] + 1
    for mod in (tms, jms):
        with pytest.raises(ValueError, match="replicated param"):
            mod.merge_megatron_shards(shards)
    shards[1][k] = shards[0][k] + 5e-6     # inside both tolerances
    _same(tms.merge_megatron_shards(shards),
          jms.merge_megatron_shards(shards))


def test_divisibility_and_range_errors():
    sd = full_sd()
    for mod in (tms, jms):
        with pytest.raises(ValueError, match="not divisible"):
            mod.split_megatron_state_dict(sd, 3, 0)
        with pytest.raises(ValueError, match="out of range"):
            mod.split_megatron_state_dict(sd, 2, 5)
        with pytest.raises(ValueError, match="equal division"):
            mod.split_qkv(sd[QKV_W], 5, 0, 2.0)


def _write_shards(tmp_path, layout, ver=2.0):
    sd = full_sd()
    for r in range(2):
        blob = {"checkpoint_version": ver,
                "model": jms.split_megatron_state_dict(
                    sd, 2, r, checkpoint_version=ver)}
        if layout == "megatron":
            d = tmp_path / f"mp_rank_{r:02d}"
            d.mkdir()
            _save(blob, d / "model_optim_rng.pt")
        else:
            _save(blob, tmp_path / f"mp_rank_{r:02d}_model_states.pt")
    return sd


@pytest.mark.parametrize("layout", ["megatron", "deepspeed"])
def test_load_from_disk_both_layouts(tmp_path, layout):
    sd = _write_shards(tmp_path, layout)
    files = tms.find_megatron_shards(str(tmp_path))
    assert files == jms.find_megatron_shards(str(tmp_path))
    assert len(files) == 2
    merged = tms.load_megatron_checkpoint(str(tmp_path))
    _same(merged, sd)


class _Weird:
    """Stands in for a megatron.* object embedded in a checkpoint."""


def test_lenient_unpickling_of_foreign_classes(tmp_path):
    """Megatron blobs embed megatron.* objects (the args Namespace): they
    load as inert stubs, not an ImportError."""
    mod = types.ModuleType("megatron_args_fake_port")
    orig = (_Weird.__module__, _Weird.__qualname__)
    _Weird.__module__, _Weird.__qualname__ = "megatron_args_fake_port", \
        "Weird"
    mod.Weird = _Weird
    sys.modules["megatron_args_fake_port"] = mod
    try:
        d = tmp_path / "mp_rank_00"
        d.mkdir()
        torch.save({"model": {"w": torch.tensor([1.0, 2.0])},
                    "args": _Weird(), "checkpoint_version": 2.0},
                   str(d / "model_optim_rng.pt"))
    finally:
        del sys.modules["megatron_args_fake_port"]
        _Weird.__module__, _Weird.__qualname__ = orig
    merged = tms.load_megatron_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(merged["w"].numpy(), [1.0, 2.0])


class _Shell:
    """Pickles as a call of ``os.system``, as a hostile checkpoint would."""

    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return os.system, (self.cmd,)


@pytest.mark.parametrize("loader", ["megatron", "deepspeed"])
def test_unpickler_stubs_callables_outside_the_allowlist(tmp_path, loader):
    """A checkpoint that names ``os.system`` loads it as an inert stub:
    nothing runs, and the tensors beside it still load."""
    marker = tmp_path / "ran"
    d = tmp_path / "mp_rank_00"
    d.mkdir()
    path = d / "model_optim_rng.pt"
    torch.save({"model": {"w": torch.tensor([1.0, 2.0])},
                "args": argparse.Namespace(tensor_model_parallel_size=1),
                "hook": _Shell(f"touch {marker}"),
                "checkpoint_version": 2.0}, str(path))
    if loader == "megatron":
        merged = tms.load_megatron_checkpoint(str(tmp_path))
        np.testing.assert_array_equal(merged["w"].numpy(), [1.0, 2.0])
    else:
        blob = import_deepspeed._torch_load(str(path))
        assert isinstance(blob["args"], argparse.Namespace)
        assert blob["args"].tensor_model_parallel_size == 1
        assert type(blob["hook"]).__name__ == "system"
        assert torch.equal(blob["model"]["w"], torch.tensor([1.0, 2.0]))
    assert not marker.exists()


def test_load_state_dict_autodetects_megatron_dir(tmp_path):
    sd = _write_shards(tmp_path, "megatron", ver=1.0)
    merged = load_state_dict(str(tmp_path))
    np.testing.assert_array_equal(merged[QKV_W].numpy(), sd[QKV_W])


def test_find_shards_skips_distributed_optimizer_file(tmp_path):
    shard = jms.split_megatron_state_dict(full_sd(), 1, 0)
    d = tmp_path / "mp_rank_00"
    d.mkdir()
    _save({"model": shard}, d / "model_optim_rng.pt")
    torch.save({"optimizer": {}}, str(d / "distrib_optim.pt"))
    assert tms.find_megatron_shards(str(tmp_path))[0].endswith(
        "model_optim_rng.pt")
    with pytest.raises(FileNotFoundError, match="mp_rank"):
        tms.find_megatron_shards(str(tmp_path / "mp_rank_00"))


def test_bf16_shards_merge_in_their_dtype():
    """The port keeps a shard's dtype (JAX merges in float32): bf16
    shards merge to bf16 holding the same values."""
    sd = {k: torch.tensor(v).to(torch.bfloat16) for k, v in full_sd().items()}
    shards = [tms.split_megatron_state_dict(sd, 2, r) for r in range(2)]
    merged = tms.merge_megatron_shards(shards)
    ref = jms.merge_megatron_shards(shards)
    for k, v in merged.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, sd[k]), k
        np.testing.assert_array_equal(v.float().numpy(), ref[k])
