"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``ops.flash_attention`` (prefill, and the training backward),
``ops.decode_attention`` (one token against the dense KV cache or the paged
pool), ``ops.block_sparse_attention`` (block-sparse attention over a LUT,
under the ``ops.sparse_attention`` front-end ``SparseSelfAttention``) and
``ops.layer_norm`` (fused LayerNorm forward and backward). The submodules
are not re-exported here: their public functions carry the modules'
names."""
from typing import Callable, Dict


def launch_counters() -> Dict[str, Callable]:
    """Every kernel wrapper that counts its launches in ``.launches``, by
    name: the one list that a run reads its per-kernel counts from, and
    that a CUDA-graph replay (``inference/cuda_graph.py``) ticks by the
    launches its capture recorded."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import layer_norm as ln
    return {
        "flash_attention_fwd": fa.flash_attention_fwd,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "decode_attention": da.decode_attention,
        "paged_decode_attention": da.paged_decode_attention,
        "paged_chunk_attention": da.paged_chunk_attention,
        "paged_verify_attention": da.paged_verify_attention,
        "paged_decode_attention_int8": da.paged_decode_attention_int8,
        "paged_chunk_attention_int8": da.paged_chunk_attention_int8,
        "paged_verify_attention_int8": da.paged_verify_attention_int8,
        "block_sparse_attention": bsa.block_sparse_attention,
        "layer_norm_fwd": ln.layer_norm_fwd,
        "layer_norm_bwd": ln.layer_norm_bwd,
    }
