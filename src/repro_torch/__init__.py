"""``repro_torch`` — the PyTorch/CUDA port of the LAG system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/fastpath/plan.py`` → ``repro_torch/fastpath/plan.py``) and
imports neither ``jax`` nor anything of ``repro``.  The comm plane's five
batched kernels (``repro_torch.fastpath.kernels``), the model's and the
legacy per-leaf comm route's kernels (``repro_torch.kernels``) are CUDA C++
for Hopper (``csrc/`` beside each), built with ``nvcc`` at first use; on
CPU tensors each wrapper runs its plain PyTorch version.

Entry points: ``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.serve`` (run on the GPU unless ``--device cpu`` is
given).
"""
