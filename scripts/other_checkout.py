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
from pathlib import Path


def load_wrapper(checkout: str, module: str, builders):
    """The other checkout's ``deepspeed_tpu_torch/ops/<module>.py``, its
    ``builders`` (attribute names) building from its own ``ops/csrc``."""
    ops = Path(checkout).resolve() / "deepspeed_tpu_torch" / "ops"
    spec = importlib.util.spec_from_file_location(f"other_{module}",
                                                  ops / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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
