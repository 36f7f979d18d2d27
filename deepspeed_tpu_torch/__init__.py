"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module layout and names; inside it is PyTorch, and every Pallas
kernel on its path is a CUDA kernel written for Hopper
(``ops/csrc/``). It imports neither JAX nor ``deepspeed_tpu``.

Ported so far: one-shot inference (:func:`init_inference` →
``InferenceEngine.generate``), the paged continuous-batching server
(``inference.ContinuousBatchingServer(engine)`` → ``submit`` / ``step`` /
``drain``) and single-device training (:func:`initialize` →
``DeepSpeedEngine.train_batch``, with ``models.gpt2``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from deepspeed_tpu_torch.utils.logging import logger  # noqa: F401

__version__ = "0.1.0"


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.InferenceEngine`
    (counterpart of ``deepspeed_tpu.init_inference``).

    ``model`` is an ``(InferenceTransformerConfig, params)`` pair or a bare
    ``InferenceTransformerConfig`` (random weights). ``config`` is a
    ``DeepSpeedInferenceConfig`` or its dict, merged with the keyword
    arguments; ``device`` (default ``"cuda"``) is taken from those."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    device = kwargs.pop("device", None)
    if config is None:
        config = {}
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**{**config, **kwargs})
    if config.checkpoint is not None or isinstance(model, str):
        raise NotImplementedError(
            "loading an HF checkpoint (module_inject/state_dict_loader.py) "
            "is not ported to deepspeed_tpu_torch yet (ROADMAP.md queue C); "
            "pass (InferenceTransformerConfig, params)")
    return InferenceEngine(model, config, device=device)


def default_inference_config():
    """Default inference configuration dict."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    return DeepSpeedInferenceConfig().model_dump()


def initialize(*args, **kwargs):
    """``(engine, optimizer, training_dataloader, lr_scheduler)`` for
    single-device training (counterpart of ``deepspeed_tpu.initialize``;
    see :func:`deepspeed_tpu_torch.runtime.engine.initialize`)."""
    from deepspeed_tpu_torch.runtime.engine import initialize as _init
    return _init(*args, **kwargs)
