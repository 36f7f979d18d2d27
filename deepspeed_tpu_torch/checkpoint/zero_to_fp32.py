"""Consolidate a checkpoint into one fp32 state dict.

Counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py`` (reference
``deepspeed/utils/zero_to_fp32.py``, an offline CLI). The reference
stitches per-rank flat shards back into parameters; the port's checkpoint
already holds whole tensors, so consolidation is: read the f32 master,
write one file (``torch.save``, as the reference writes its
``pytorch_model.bin``). A ZeRO-Offload checkpoint keeps its master in
``host_optimizer.npz`` beside the state (JAX
``checkpoint/zero_to_fp32.py:38``), which is read then.

CLI::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.pt>
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.checkpoint.universal import DeepSpeedCheckpoint
from deepspeed_tpu_torch.utils.logging import logger


def get_fp32_state_dict_from_zero_checkpoint(
        ckpt_dir: str, tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``{param name: fp32 host tensor}`` — the master weights (in fp32
    training, the params themselves; with the host offload, the host
    master in the leaves' shapes)."""
    ck = DeepSpeedCheckpoint(ckpt_dir, tag)
    state = ck.load()
    master = state.get("master")
    host_npz = os.path.join(ck.dir, "host_optimizer.npz")
    if not master and os.path.isfile(host_npz):
        import numpy as np
        params = state.get("params") or {}
        blob = np.load(host_npz)
        out = {}
        for key in blob.files:
            if key.startswith("master::"):
                name = key[len("master::"):].replace("/", ".")
                t = torch.from_numpy(blob[key].astype(np.float32))
                out[name] = t.reshape(tuple(params[name].shape)) \
                    if name in params else t
        if out:
            return out
    if not master:
        raise ValueError(f"checkpoint {ckpt_dir} has no master weights")
    return {k: v.to(torch.float32, copy=True) for k, v in master.items()}


def convert_zero_checkpoint_to_fp32_state_dict(
        ckpt_dir: str, output_file: str, tag: Optional[str] = None) -> str:
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    torch.save(sd, output_file)
    total = sum(v.numel() for v in sd.values())
    logger.info(f"consolidated {len(sd)} tensors ({total / 1e6:.1f}M "
                f"params) → {output_file}")
    return output_file


def load_state_dict_from_zero_checkpoint(params_like, ckpt_dir: str,
                                         tag: Optional[str] = None):
    """A dict keyed and shaped like ``params_like`` holding the
    consolidated fp32 weights (the reference's
    load_state_dict_from_zero_checkpoint, applied functionally)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    missing = set(params_like) - set(sd)
    if missing:
        raise KeyError(f"checkpoint missing params: {sorted(missing)[:5]}")
    return {k: sd[k].reshape(tuple(params_like[k].shape))
            for k in params_like}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("-t", "--tag", default=None)
    a = p.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(a.checkpoint_dir,
                                               a.output_file, tag=a.tag)


if __name__ == "__main__":
    main()
