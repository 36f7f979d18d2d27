"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/
sparse_attention/``).

The layout family ports as numpy (``sparsity_config.py``, the JAX package's
own copy), the LUT is built on the host (``ops.block_sparse_attention.
build_lut``), and the kernel is B8, a hand-written CUDA block-sparse flash
attention that walks only each query block's active key blocks
(``ops/csrc/block_sparse_attention.cu``).
"""
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, sparse_attention, sparse_attention_reference)

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
           "SparseSelfAttention", "sparse_attention",
           "sparse_attention_reference"]
