"""Load another checkout's kernel wrapper beside this checkout's, for the
same-call A/B scripts (``compare_layer_norm.py``, ``compare_paged_decode.py``).

The other checkout needs only its ``deepspeed_tpu_torch`` package, e.g.::

    git archive <commit> deepspeed_tpu_torch | tar -x -C build/parent

:func:`load_wrapper` executes the other checkout's ``ops/<module>.py`` as a
module of its own and points its builders at the other checkout's kernel
sources, which this checkout's builder then compiles (with this checkout's
nvcc flags, cached by the source's hash). Both wrappers run in one process,
on one card, with their own launch checks, allocations and plans.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_wrapper(checkout: str, module: str, builders, own=("head_dim",)):
    """The other checkout's ``deepspeed_tpu_torch/ops/<module>.py``, its
    ``builders`` (attribute names) building from its own ``ops/csrc``. The
    ``ops`` modules named in ``own`` that the other checkout has (the
    head-dim route, whose names change between checkouts) are its own while
    its wrapper imports them; everything else is this checkout's."""
    ops = Path(checkout).resolve() / "deepspeed_tpu_torch" / "ops"
    saved = {}
    for name in own:
        if (ops / f"{name}.py").is_file():
            key = f"deepspeed_tpu_torch.ops.{name}"
            saved[key] = sys.modules.get(key)
            sys.modules[key] = _load(ops / f"{name}.py", f"other_{name}")
    try:
        mod = _load(ops / f"{module}.py", f"other_{module}")
    finally:
        for key, m in saved.items():
            if m is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = m
    for attr in builders:
        b = getattr(mod, attr)
        b.source = ops / "csrc" / f"{b.name}.cu"
        b.name = f"other_{b.name}"   # its own cached .so
    return mod


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def in_turns(fns, iters, flush, cuda_ms):
    """Device ms of ``fns["other"]`` and ``fns["this"]`` timed in turns
    other, this, this, other: ``{"other": [a, b], "this": [c, d]}``."""
    out = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        out[tag].append(cuda_ms(fns[tag], iters, flush))
    return out
