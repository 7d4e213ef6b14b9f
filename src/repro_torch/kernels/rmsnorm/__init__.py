"""Fused RMSNorm: CUDA kernel (``rmsnorm``), plain version (``ref``),
dispatch (``ops``)."""
