"""Import guard for the PyTorch/CUDA port.

``deepspeed_tpu_torch/``, ``chip_smoke.py`` and the port's scripts run on a
machine without JAX, ``transformers`` or ``safetensors``, so none of them
may import ``jax``, ``jaxlib``, ``flax``, the JAX package ``deepspeed_tpu``
(the exact package: the port's own ``deepspeed_tpu_torch`` is fine),
``transformers`` or ``safetensors`` (the port reads HF models by
attribute and has its own safetensors reader). ``scripts/check_imports.py`` lints only
the JAX tree; this walks the AST of every port file, so an import inside a
function is caught too.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "deepspeed_tpu", "transformers",
          "safetensors"}
PORT_FILES = sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "deepspeed_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "scripts/profile_torch_generate.py",
       "scripts/profile_speculation.py", "scripts/profile_int8.py",
       "scripts/profile_train_models.py", "scripts/train_nvme_llama.py",
       "scripts/observe_cost.py"])


def banned_imports(source: str):
    """``(line, module)`` for each import of a banned top-level package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in BANNED]
    return found


def test_guard_tells_the_port_from_the_jax_package():
    src = ("import jax.numpy as jnp\nfrom flax import linen\n"
           "import deepspeed_tpu_torch\nfrom deepspeed_tpu.ops import x\n"
           "def f():\n    import jaxlib\n"
           "from deepspeed_tpu_torch.ops import flash_attention\n"
           "def g():\n    from transformers import GPT2Config\n"
           "    import safetensors.torch\n"
           "from deepspeed_tpu_torch.utils import safetensors_io\n")
    assert banned_imports(src) == [(1, "jax.numpy"), (2, "flax"),
                                   (4, "deepspeed_tpu.ops"), (6, "jaxlib"),
                                   (9, "transformers"),
                                   (10, "safetensors.torch")]


def test_the_port_has_files_to_guard():
    assert "deepspeed_tpu_torch/__init__.py" in PORT_FILES
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    assert banned_imports((ROOT / path).read_text()) == [], path
