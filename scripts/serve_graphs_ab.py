#!/usr/bin/env python3
"""Every server and ``generate`` of ``chip_smoke.py``'s serving phases with
their CUDA graphs and eagerly, on one NVIDIA GPU.

Runs ``chip_smoke.py``'s build, then its phases e2e and serve at GPT-2 XL
width and its phases pythia (Pythia-2.8B) and gptj (GPT-J-6B), with every
server run a second time with its step graphs off (``chip_smoke.py``
itself runs that eager control for ``generate`` and servers (a), (c) and
(d) only). Each server run prints its tokens/s and median step ms, graphs
and eager, and must serve the same tokens both ways; each ``generate``
prints its decode ms a step both ways.

    python3 scripts/serve_graphs_ab.py
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

GPT2_SERVERS = ("default", "prefix+chunked", "speculation K=4",
                "int8+prefix+chunked+offload", "int8 speculation K=4")


def model_servers(tag):
    return tuple(f"{tag} {pool} {what}" for pool in ("fp", "int8")
                 for what in ("prefix+chunked", "speculation K=4"))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    cfg = chip_smoke.gpt2_xl_config()
    params = chip_smoke.make_params(cfg)
    chip_smoke.phase_e2e(cfg, params)
    chip_smoke.phase_serve(cfg, params, eager=GPT2_SERVERS)
    del params
    torch.cuda.empty_cache()
    chip_smoke.phase_pythia(eager=model_servers("pythia"))
    chip_smoke.phase_gptj(eager=model_servers("gptj"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
