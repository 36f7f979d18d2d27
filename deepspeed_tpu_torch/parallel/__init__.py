"""Parallel-layout helpers (counterpart of ``deepspeed_tpu/parallel``):
the process topology. Pipelines are ROADMAP.md A8."""
from deepspeed_tpu_torch.parallel.topology import (
    PipeDataParallelTopology, PipelineParallelGrid,
    PipeModelDataParallelTopology, ProcessTopology)

__all__ = ["ProcessTopology", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineParallelGrid"]
