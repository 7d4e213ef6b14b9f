"""``repro_torch`` — the PyTorch/CUDA port of the LAG system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/fastpath/plan.py`` → ``repro_torch/fastpath/plan.py``) and
imports neither ``jax`` nor anything of ``repro``.  The comm plane's four
batched kernels (``repro_torch.fastpath.kernels``) are CUDA C++ for Hopper
(``fastpath/csrc``), built with ``nvcc`` at first use; on CPU tensors each
wrapper runs its plain PyTorch version (``fastpath/kernels_ref.py``).

Entry point: ``python -m repro_torch.launch.train`` (runs on the GPU unless
``--device cpu`` is given).
"""
