"""The legacy per-leaf LAG-trigger kernels: CUDA kernels (``lag_trigger``),
plain versions (``ref``), pytree dispatch (``ops``)."""
