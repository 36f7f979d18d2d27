"""Import a REFERENCE DeepSpeed checkpoint directory.

Counterpart of ``deepspeed_tpu/checkpoint/import_deepspeed.py``: a user
switching from the reference (DeepSpeed v0.8) brings their training
checkpoint along. This reads the reference's on-disk layout directly (no
deepspeed package, no live model) and reconstructs the full fp32 weights:

* ``mp_rank_00_model_states.pt`` / ``zero_pp_rank_0_mp_rank_00_model_
  states.pt`` — ``param_shapes`` (the flattening order), buffers,
  ``module`` (for non-ZeRO checkpoints the full weights live here)
* ``*_optim_states.pt`` per DP rank — the flat fp32 partitions
  (``single_partition_of_fp32_groups`` for stage 1/2,
  ``fp32_flat_groups`` for stage 3)

Reconstruction mirrors the reference's own offline consolidation tool
(``deepspeed/utils/zero_to_fp32.py:160-330``): stage-1/2 partitions
concatenate per param group and slice sequentially with the
2*world_size alignment tolerance; stage-3 shards interleave at each
param boundary with ceil-partition padding. Constants match
``deepspeed/checkpoint/constants.py``.

The result is a flat ``{dotted_name: host tensor}``; :func:`to_param_tree`
applies the renames' transposes and :func:`import_into_engine` installs
it. These foreign pickles are the one place the port loads with
``weights_only=False``, through ``utils/lenient_pickle.py`` (they carry
argparse Namespaces and other objects); its own checkpoints load with
``weights_only=True``.
"""
from __future__ import annotations

import fnmatch
import glob
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.lenient_pickle import LenientUnpickler

OPTIMIZER_STATE_DICT = "optimizer_state_dict"
FP32_FLAT_GROUPS = "fp32_flat_groups"
SINGLE_PARTITION = "single_partition_of_fp32_groups"
ZERO_STAGE = "zero_stage"
PARTITION_COUNT = "partition_count"
PARAM_SHAPES = "param_shapes"
BUFFER_NAMES = "buffer_names"
DS_VERSION = "ds_version"


def _t(x) -> torch.Tensor:
    """A host tensor; the half dtypes widen to f32, integer buffers
    (position_ids, num_batches_tracked) keep their dtype exactly."""
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t


def _natural(text: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=LenientUnpickler)


def resolve_tag_dir(checkpoint_dir: str, tag: Optional[str] = None) -> str:
    """Follow the reference's ``latest`` tag file when ``checkpoint_dir``
    is the parent save dir."""
    latest = os.path.join(checkpoint_dir, "latest")
    if tag is None and os.path.isfile(latest):
        with open(latest) as f:
            tag = f.read().strip()
    return os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir


def _model_state_file(d: str) -> str:
    for name in ("mp_rank_00_model_states.pt",
                 "zero_pp_rank_0_mp_rank_00_model_states.pt"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no *_model_states.pt under {d!r}")


def _optim_files(d: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, "*_optim_states.pt")),
                  key=_natural)


def load_reference_fp32_state_dict(checkpoint_dir: str,
                                   tag: Optional[str] = None
                                   ) -> Dict[str, torch.Tensor]:
    """Full fp32 weights (+ buffers) from a reference checkpoint dir —
    ZeRO stages 1/2/3 or plain fp16/bf16 saves."""
    d = resolve_tag_dir(checkpoint_dir, tag)
    if glob.glob(os.path.join(d, "*mp_rank_01*")):
        raise NotImplementedError(
            "TP>1 reference checkpoints (mp_rank_01+ files) are not "
            "importable directly — merge the model-parallel shards first "
            "and import only the mp_rank_00 slice")
    model_blob = _torch_load(_model_state_file(d))
    buffers = {}
    module_sd = model_blob.get("module") or {}
    for name in model_blob.get(BUFFER_NAMES, []):
        if name in module_sd:
            buffers[name] = _t(module_sd[name])

    optim_files = _optim_files(d)
    param_shapes = model_blob.get(PARAM_SHAPES)
    if not optim_files or param_shapes is None:
        # non-ZeRO save: module holds the real (half) weights
        if not module_sd:
            raise ValueError(f"{d!r}: no optim shards and no module "
                             "weights — not a DeepSpeed checkpoint?")
        return {k: _t(v) for k, v in module_sd.items()}

    states = [_torch_load(f)[OPTIMIZER_STATE_DICT] for f in optim_files]
    stage = states[0].get(ZERO_STAGE, 2)
    world = states[0].get(PARTITION_COUNT, len(states))
    if isinstance(world, list):
        world = max(world)
    if world != len(states):
        raise ValueError(f"expected {world} optim shards, found "
                         f"{len(states)} (incomplete checkpoint?)")

    out: Dict[str, torch.Tensor] = dict(buffers)
    if stage in (1, 2):
        _reconstruct_stage2(states, param_shapes, world, out)
    elif stage == 3:
        _reconstruct_stage3(states, param_shapes, world, out)
    else:
        raise ValueError(f"unknown zero stage {stage}")
    # anything in the module blob that the fp32 partitions did not cover
    # (frozen params — they have no optimizer state — and extra buffers)
    # comes through at its stored precision
    for name, value in module_sd.items():
        if name not in out:
            out[name] = _t(value)
    return out


def _numel(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _reconstruct_stage2(states, param_shapes, world, out) -> None:
    """Concat each group's partitions, slice sequentially, tolerate the
    2*world alignment padding (zero_to_fp32.py:224-271)."""
    flat_groups = [s[SINGLE_PARTITION] for s in states]
    n_groups = len(flat_groups[0])
    for gi in range(n_groups):
        full = torch.cat([_t(flat_groups[r][gi]).reshape(-1)
                          for r in range(world)])
        offset = 0
        for name, shape in param_shapes[gi].items():
            shape = tuple(shape)
            n = _numel(shape)
            out[name] = full[offset:offset + n].reshape(shape).clone()
            offset += n
        align = 2 * world
        if align * math.ceil(offset / align) != \
                align * math.ceil(full.numel() / align):
            raise ValueError(
                f"group {gi}: consumed {offset} of {full.numel()} elements "
                "— param_shapes do not match the flat partitions")


def _reconstruct_stage3(states, param_shapes, world, out) -> None:
    """Each rank's single flat group holds ceil(n/world) elements of
    every param in order; zip at param boundaries
    (zero_to_fp32.py:279-330)."""
    shards = [_t(s[FP32_FLAT_GROUPS]).reshape(-1)
              if not isinstance(s[FP32_FLAT_GROUPS], list)
              else torch.cat([_t(x).reshape(-1)
                              for x in s[FP32_FLAT_GROUPS]])
              for s in states]
    merged = {k: tuple(v) for d_ in param_shapes for k, v in d_.items()}
    # validate BEFORE slicing: a short shard would otherwise surface as a
    # cryptic reshape error mid-loop
    need = sum(math.ceil(_numel(s) / world) for s in merged.values())
    short = [i for i, s in enumerate(shards) if s.numel() < need]
    if short:
        raise ValueError(
            f"stage-3 shards {short} hold fewer elements than "
            f"param_shapes demand ({need}) — truncated checkpoint?")
    offset = 0
    for name, shape in merged.items():
        n = _numel(shape)
        part = math.ceil(n / world)
        pieces = [shards[r][offset:offset + part] for r in range(world)]
        out[name] = torch.cat(pieces)[:n].reshape(shape).clone()
        offset += part


def import_into_engine(engine, fp32_tree: Dict[str, torch.Tensor]) -> None:
    """Install imported fp32 weights into a live engine: the names and
    shapes must match ``engine.params`` (use :func:`to_param_tree` plus
    your own renames to get there). The master and the compute params
    take the weights; the optimizer state restarts (the reference's
    consolidation tool also recovers weights only)."""
    want = {k: tuple(v.shape) for k, v in engine.params.items()}
    got = {k: tuple(torch.as_tensor(v).shape) for k, v in fp32_tree.items()}
    if want != got:
        raise ValueError(
            "imported names/shapes do not match the engine's params — "
            "map names (to_param_tree + renames) first")
    with torch.no_grad():
        if engine.host_opt is not None:
            # ZeRO-Offload: the master and the moments live on the host;
            # the params take the weights and the master is re-seeded
            # from them (JAX import_deepspeed.py:218-224)
            for k, p in engine.params.items():
                p.detach().copy_(torch.as_tensor(fp32_tree[k]))
            engine.host_opt.sync_master_from(engine.params)
            return
        engine._sync_host_state()
        master = engine._master()
        for k, m in master.items():
            m.detach().copy_(torch.as_tensor(fp32_tree[k]).float())
        if master is not engine.params:
            engine._cast_params_from(master)
    if engine._stream_opt is not None:   # restart the pinned moments
        for f in engine._stream_opt.fields:
            for t in getattr(engine.opt_state, f).values():
                t.zero_()
        engine.opt_state.count = 0
    else:
        engine.opt_state = engine.optimizer.init(
            {k: v.detach() for k, v in engine._master().items()})


def to_param_tree(flat: Dict[str, torch.Tensor],
                  transpose_linear_keys: Tuple[str, ...] = ()
                  ) -> Dict[str, torch.Tensor]:
    """The port's parameters are a flat dict, so this keeps the dotted
    names; keys matching ``transpose_linear_keys`` patterns transpose
    [out, in] → [in, out] for the ``x @ w`` layout. Match only LINEAR
    weights — embeddings keep torch's layout, and conv kernels need a
    real layout permute, so a >2-D match is rejected loudly."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        t = torch.as_tensor(arr)
        if any(fnmatch.fnmatch(name, p) for p in transpose_linear_keys):
            if t.dim() != 2:
                raise ValueError(
                    f"transpose_linear_keys matched {name!r} with ndim="
                    f"{t.dim()}; only 2-D Linear weights transpose "
                    "(conv kernels need OIHW→HWIO, embeddings none)")
            t = t.T.contiguous()
        out[name] = t
    return out
