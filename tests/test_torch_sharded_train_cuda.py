"""The row-sharded trainer's kernel path on the card (``cuda`` marker; the
tests skip without a CUDA device).  The file imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_train_cuda.py

- ``RowShardPlan`` on 1–4 row shards of an unaligned layout, the kernels
  on each shard: sums, LAQ's steps, payloads and residuals bitwise the
  one-rank plane's kernels (every kernel output is per sub-block, and
  every sub-block lies whole on one rank).
- The reduced llama3.2-1b on the host mesh: one NCCL rank in this process,
  and two gloo ranks sharing the card, lag-wk and laq@4, 3 rounds, bitwise
  the one-process ``shards:W`` trainer on the card (masks, losses, θ, ĝ
  rows), the plane's kernels launched on the shards.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import sharded_ranks as ranks
from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch import devrun
from repro_torch.dist.lag_trainer import param_layout
from repro_torch.fastpath import kernels
from repro_torch.fastpath.layout import RowShard

ALGOS = ("lag-wk", "laq@4")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_cuda_row_shard_plan_is_bitwise_the_one_rank_plane(cuda_device, N):
    ranks.row_shard_plan_case(N, cuda_device)


def _params():
    """The reduced llama's weights drawn from a seed, as numpy (the
    ``ref_params`` form ``sharded_ranks.run_case`` takes)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    return tree_map(lambda t: t.numpy(),
                    model.init(ranks.config(), device="cpu", seed=0))


def _check(got, want, N, rank):
    sh = RowShard(param_layout(ranks.config()).rows, N, rank)
    assert got["masks"] == want["masks"]
    assert got["losses"] == want["losses"]
    assert np.array_equal(got["final"]["theta"], want["final"]["theta"])
    mine, whole = got["final"]["grad_hat"], want["final"]["grad_hat"]
    assert np.array_equal(mine[:, :sh.valid],
                          whole[:, sh.start:sh.start + sh.valid])


def cuda_rank(rank, algos, params):
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_host_mesh("cpu")
    out = {}
    for algo in algos:
        kernels.reset_launches()
        out[algo] = ranks.run_case(algo, params, mesh, device="cuda")
        out[algo]["launches"] = dict(kernels.LAUNCHES)
    return out


@pytest.mark.cuda
def test_cuda_host_mesh_one_nccl_rank_and_two_gloo_ranks(cuda_device):
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    params = _params()
    want = {a: ranks.run_case(a, params, device="cuda") for a in ALGOS}
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh("cuda")
        for a in ALGOS:
            _check(ranks.run_case(a, params, mesh, device="cuda"), want[a],
                   1, 0)
    finally:
        dist.destroy_process_group()
    got = devrun.launch(cuda_rank, 2, backend="gloo", device="cuda",
                        args=(ALGOS, params), timeout=300.0)
    for rank, res in enumerate(got):
        for a in ALGOS:
            _check(res[a], want[a], 2, rank)
            n = res[a]["launches"]
            assert n["masked_combine"] >= ranks.STEPS, n
            assert n["delta_sqnorm_blocks" if a == "lag-wk"
                     else "laq_encode_blocks"] == ranks.STEPS, n
