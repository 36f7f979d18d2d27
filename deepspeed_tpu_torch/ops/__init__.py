"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``ops.flash_attention`` (prefill, and the training backward),
``ops.decode_attention`` (one token against the dense KV cache or the paged
pool), ``ops.block_sparse_attention`` (block-sparse attention over a LUT,
under the ``ops.sparse_attention`` front-end ``SparseSelfAttention``) and
``ops.layer_norm`` (fused LayerNorm forward and backward). The submodules
are not re-exported here: their public functions carry the modules'
names."""
