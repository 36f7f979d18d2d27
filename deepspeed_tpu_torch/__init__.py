"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module layout and names; inside it is PyTorch, and every Pallas
kernel on its path is a CUDA kernel written for Hopper
(``ops/csrc/``). It imports neither JAX nor ``deepspeed_tpu``.

Ported so far: one-shot inference (:func:`init_inference` →
``InferenceEngine.generate``), the paged continuous-batching server
(``inference.ContinuousBatchingServer(engine)`` → ``submit`` / ``step`` /
``drain``), single-device training (:func:`initialize` →
``DeepSpeedEngine.train_batch``, with ``models.gpt2``, ``models.llama``
and ``models.bert`` on the BERT layer ``ops.transformer``) with verified
checkpoints (``save_checkpoint`` / ``load_checkpoint``, the
``checkpoint`` toolkit), the bridge from a trained GPT-2 or LLaMA to the
server (``module_inject.convert_trained_model``, ``inference.engine.
save_serving_checkpoint`` / ``load_serving_checkpoint``), and HF models
and checkpoint directories of the policy table's eighteen architectures
served through ``init_inference`` (``module_inject/policies.py``,
``state_dict_loader.py``, ``megatron_shards.py``), and data-parallel
training over ``torch.distributed`` ranks with ZeRO stages 0-3
(:func:`init_distributed`, then :func:`initialize` on each rank; the
``comm`` facade and mesh, ``zero.Init`` / ``GatheredParameters``), the
offload tiers down to NVMe (``offload_optimizer`` / ``offload_param``
``device: nvme``), :mod:`checkpointing` (activation checkpointing) and
the training flight recorder, numerics and goodput (``telemetry``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from deepspeed_tpu_torch.utils.logging import logger  # noqa: F401

__version__ = "0.1.0"

# the JAX package's top-level names, resolved on first use (PEP 562) so
# that importing the package stays light
_LAZY = {
    "DeepSpeedConfig": ("deepspeed_tpu_torch.config.config",
                        "DeepSpeedConfig"),
    "DeepSpeedEngine": ("deepspeed_tpu_torch.runtime.engine",
                        "DeepSpeedEngine"),
    "checkpoint": ("deepspeed_tpu_torch.checkpoint", None),
    # deepspeed.checkpointing: activation checkpointing (the engine's
    # save/load is on the engine)
    "checkpointing": ("deepspeed_tpu_torch.runtime.activation_checkpointing",
                      None),
    "module_inject": ("deepspeed_tpu_torch.module_inject", None),
    "comm": ("deepspeed_tpu_torch.comm", None),
    "zero": ("deepspeed_tpu_torch.zero", None),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod, attr = _LAZY[name]
    m = importlib.import_module(mod)
    return m if attr is None else getattr(m, attr)


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.InferenceEngine`
    (counterpart of ``deepspeed_tpu.init_inference``).

    ``model`` is an ``(InferenceTransformerConfig, params)`` pair, a bare
    ``InferenceTransformerConfig`` (random weights), an HF model (a live
    ``transformers`` model or a
    ``module_inject.state_dict_loader.CheckpointModelView``), or the path
    of an HF checkpoint directory, whose files are read and converted on
    the engine's device with no model object (safetensors, sharded,
    ``.bin`` or Megatron ``mp_rank_*``); ``config.checkpoint`` names such
    a directory too (a string, a one-item list or a dict, under
    ``config.base_dir``). ``config`` is a ``DeepSpeedInferenceConfig`` or
    its dict, merged with the keyword arguments; ``device`` (default
    ``"cuda"``) is taken from those."""
    import os

    import torch

    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                      resolve_device)
    device = resolve_device(kwargs.pop("device", None))
    if config is None:
        config = {}
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**{**config, **kwargs})
    if config.checkpoint is not None:
        if model is not None:
            raise ValueError(
                "pass ONE weight source: either a model/path argument or "
                "config.checkpoint — with both, which weights serve "
                "would be ambiguous (the reference overwrites the live "
                "module from the checkpoint; here load from the "
                "checkpoint alone)")
        ckpt = config.checkpoint
        if isinstance(ckpt, dict):
            ckpt = ckpt.get("checkpoint") or ckpt.get("path") or \
                ckpt.get("checkpoints")
        if isinstance(ckpt, (list, tuple)):
            if len(ckpt) != 1:
                raise NotImplementedError(
                    "multi-file 'checkpoints' lists are model-parallel "
                    "shards — point at the directory instead (Megatron "
                    "mp_rank_* layouts merge automatically)")
            ckpt = ckpt[0]
        if not isinstance(ckpt, str):
            raise ValueError(
                "config.checkpoint must be a path (or a dict with a "
                f"'checkpoint'/'path' entry), got {config.checkpoint!r}")
        model = (os.path.join(config.base_dir, ckpt) if config.base_dir
                 else ckpt)
    if isinstance(model, str):
        from deepspeed_tpu_torch.module_inject.state_dict_loader import (
            load_inference_checkpoint)
        # dtype="int8" loads in bf16; the engine quantizes on placement
        load_dtype = (torch.bfloat16 if config.torch_dtype == torch.int8
                      else config.torch_dtype)
        model = load_inference_checkpoint(model, dtype=load_dtype,
                                          device=device)
    return InferenceEngine(model, config, device=device)


def default_inference_config():
    """Default inference configuration dict."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    return DeepSpeedInferenceConfig().model_dump()


def initialize(*args, **kwargs):
    """``(engine, optimizer, training_dataloader, lr_scheduler)`` for
    training on one device or over the ranks of a process group
    (counterpart of ``deepspeed_tpu.initialize``; see
    :func:`deepspeed_tpu_torch.runtime.engine.initialize`)."""
    from deepspeed_tpu_torch.runtime.engine import initialize as _init
    return _init(*args, **kwargs)


def init_distributed(*args, **kwargs):
    """Start the process group the launcher's environment names
    (torchrun's or the JAX launcher's variables; see
    :func:`deepspeed_tpu_torch.comm.comm.init_distributed`)."""
    from deepspeed_tpu_torch.comm.comm import init_distributed as _init
    return _init(*args, **kwargs)


def add_config_arguments(parser):
    """Augment an argparse parser with the DeepSpeed flags (reference
    ``deepspeed/__init__.py:210``)."""
    group = parser.add_argument_group("DeepSpeed-TPU",
                                      "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed-TPU json configuration")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Discover ranks via MPI environment")
    return parser
