"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``ops.flash_attention`` (prefill) and ``ops.decode_attention``
(one token against the dense KV cache). The submodules are not re-exported
here: their public functions carry the modules' names."""
