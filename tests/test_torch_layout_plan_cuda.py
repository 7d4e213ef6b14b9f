"""The comm plane's kernels and the plan's LAQ steps on the card, held to
the plain versions and to the CPU's IEEE division.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_layout_plan_cuda.py

They were ``tests/test_torch_layout_plan.py``'s, whose JAX imports kept
them off the card's machine; the ragged layouts are built with the port's
``FlatLayout`` (the reference's table, bit for bit).
"""
import numpy as np
import pytest
import torch

from cuda_helpers import RAGGED, cuda_device, np_tree  # noqa: F401
from repro_torch.core.tree import tree_map
from repro_torch.fastpath import kernels, kernels_ref
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.fastpath.plan import FastPathPlan

SUM_RTOL = 1e-5


def to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def flat_inputs(W, n_ops, seed, sizes=RAGGED, scale=1.0):
    """n_ops stacked (W, rows, 128) float32 buffers of one ragged layout."""
    lo = FlatLayout.for_tree(to_torch(np_tree(sizes=sizes)))
    return lo, [lo.flatten_stacked(to_torch(np_tree(
        W=W, seed=seed + i, sizes=sizes, scale=scale))).numpy()
        for i in range(n_ops)]


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3])
def test_cuda_kernels_match_plain_versions(cuda_device, W):
    _, (a, b, c) = flat_inputs(W, 3, seed=7 * W)
    ta, tb, tc = (torch.from_numpy(x).to(cuda_device) for x in (a, b, c))
    got = kernels.delta_sqnorm_blocks(ta, tb[0]).cpu()
    want = kernels_ref.delta_sqnorm_blocks(ta.cpu(), tb[0].cpu())
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
    got = kernels.absmax_blocks(ta, tb, tc).cpu()
    assert torch.equal(got, kernels_ref.absmax_blocks(ta.cpu(), tb.cpu(),
                                                      tc.cpu()))
    steps = kernels_ref.absmax_blocks(ta, tb, tc) / 7.0
    p, r, sq = kernels.laq_encode_blocks(ta, tb, tc, steps, 4)
    wp, wr, wsq = kernels_ref.laq_encode_blocks(ta, tb, tc, steps, 4)
    assert torch.equal(p, wp) and torch.equal(r, wr)
    torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
    torch.testing.assert_close(kernels.sqnorm_blocks(ta),
                               kernels_ref.sqnorm_blocks(ta), rtol=SUM_RTOL,
                               atol=0)
    mask = torch.tensor([True, False, True][:W], device=cuda_device)
    for mode in ("add", "update", "select"):
        assert torch.equal(kernels.masked_combine(ta[0], tb, mask, mode),
                           kernels_ref.masked_combine(ta[0], tb, mask, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_plan_laq_steps_divide_exactly(cuda_device, bits):
    """On the card the plane's steps equal the CPU's IEEE division of the
    same scales, bit for bit."""
    _, (a, b, c) = flat_inputs(3, 3, seed=11)
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    ta, tb, tc = (torch.from_numpy(x).to(cuda_device) for x in (a, b, c))
    plan = FastPathPlan("on")
    steps = plan.laq_encode(ta, tb, tc, lo, bits=bits)[3]
    scales = plan._per_leaf(kernels.absmax_blocks(ta, tb, tc), lo, "max")
    qmax = float(2 ** (bits - 1) - 1)
    assert torch.equal(steps.cpu(), scales.cpu() / torch.tensor(qmax))
