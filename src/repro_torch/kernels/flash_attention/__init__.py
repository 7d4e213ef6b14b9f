"""Flash attention forward: CUDA kernel (``flash_attention``), plain
version (``ref``), dispatch (``ops``)."""
