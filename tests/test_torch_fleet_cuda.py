"""The fleet's and the async topology's kernel paths on the card, held to
their plain versions.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py

They were ``tests/test_torch_fleet.py``'s, whose JAX imports kept them off
the card's machine.
"""
import numpy as np
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch import fleet
from repro_torch.comm import make_policy
from repro_torch.core.convex import Problem
from repro_torch.engine import Experiment
from repro_torch.fastpath import kernels, kernels_ref
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.fleet.population import MIRROR_PREFIX, Population


# ---------------------------------------------------------------------------
# The kernels on the new paths (on the card; skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_stacked_theta_view_kernels(cuda_device):
    """async: delta_sqnorm_blocks with a stacked b (‖θ̂_m − θ_m‖²) and
    masked_combine with a stacked a (the θ̂ select) vs their plain
    versions."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((2, 256, 128), device=cuda_device, generator=g)
    b = torch.randn((2, 256, 128), device=cuda_device, generator=g)
    torch.testing.assert_close(kernels.delta_sqnorm_blocks(a, b),
                               kernels_ref.delta_sqnorm_blocks(a, b),
                               rtol=1e-5, atol=0)
    mask = torch.tensor([True, False], device=cuda_device)
    assert torch.equal(kernels.masked_combine(a, b, mask, "select"),
                       kernels_ref.masked_combine(a, b, mask, "select"))


@pytest.mark.cuda
def test_cuda_fleet_cohort_innovation_kernel(cuda_device):
    """fleet: the innovation ‖∇L_m − ĝ_m‖² of gathered cohort buffers is
    kernel 1, within rtol 1e-5 of the plain version."""
    from repro_torch.fleet.rounds import _innovation
    lo = FlatLayout.for_tree({"w": torch.zeros(300, 7), "b": torch.zeros(5)})
    pop = Population.for_template(lo, ("grad_hat",), 10)
    st = pop.init_state(cuda_device)
    st[MIRROR_PREFIX + "grad_hat"].normal_()
    cohort = torch.tensor([1, 4, 8], device=cuda_device)
    gh = pop.gather_state(st, cohort)["grad_hat"]
    grads = lo.empty((3,), cuda_device)
    lo.unflatten_stacked(grads)["w"].normal_()
    before = dict(kernels.LAUNCHES)
    got = _innovation(make_policy("lag-wk"), grads, gh, lo)
    assert kernels.LAUNCHES["delta_sqnorm_blocks"] \
        == before["delta_sqnorm_blocks"] + 1
    want = _innovation(make_policy("lag-wk", fastpath=None), grads.cpu(),
                       gh.cpu(), lo)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_convex_fleet_matches_cpu(cuda_device):
    """The convex fleet on the card's plane against the CPU's plain kernel
    versions and against the plain route on the card: the same host
    draws, cohorts and masks."""
    prob = fleet.fleet_problem("linreg", num_clients=200, device=cuda_device)
    cpu = Problem(name=prob.name, kind=prob.kind, X=prob.X.cpu(),
                  y=prob.y.cpu(), L_m=prob.L_m.cpu(), L=prob.L, lam=prob.lam)
    kw = dict(algo="lag-wk", steps=30, opt_loss=0.0, topology="fleet:200@8")
    g = Experiment(problem=prob, **kw).run()
    p = Experiment(problem=prob, policy=make_policy("lag-wk", fastpath=None),
                   **kw).run()
    c = Experiment(problem=cpu, fastpath="on", **kw).run()
    assert np.array_equal(g.extras["cohort_ids"], c.extras["cohort_ids"])
    assert np.array_equal(g.extras["cohort_ids"], p.extras["cohort_ids"])
    assert np.array_equal(g.comm_mask, c.comm_mask)
    assert np.array_equal(g.comm_mask, p.comm_mask)
