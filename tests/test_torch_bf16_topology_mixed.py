"""bfloat16 training on the topologies, against the LIVE JAX reference's
trainer: mamba2-370m's tree of bfloat16 and float32 leaves on ``pods:2``,
``async:2@1`` and ``fleet:4@2``, and the float32 model with
``grad_hat_dtype="bfloat16"`` on ``async:2@1`` — the settings and
tolerances of ``test_torch_bf16_topologies.py`` (whose runs these reuse).
"""
import numpy as np
import pytest
import torch

from test_torch_bf16_topologies import (CASE_IDS, CASES, LOSS_RTOL,
                                        check_against_reference, port_run,
                                        reference_run)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are many small
    ops, which several test processes' thread pools slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES[:3], ids=CASE_IDS[:3])
def test_mixed_tree_topology_trains_like_the_reference(case):
    """mamba2-370m's tree of bfloat16 and float32 leaves, lag-wk, as
    ``test_torch_bf16_topologies`` holds the all-bfloat16 llama."""
    check_against_reference("mamba2-370m", case, "lag-wk")


def test_float32_model_with_bf16_grad_hat_on_async_matches_reference():
    """``grad_hat_dtype="bfloat16"`` on the float32 model, ``async:2@1``:
    masks equal, losses within rtol 1e-4 (the float32 trainer tests');
    ĝ bfloat16, the ring float32."""
    case = CASES[1]
    ref, ref_masks, _, _ = reference_run("llama3.2-1b", *case, "lag-wk",
                                         False, "bfloat16")
    for fastpath in ("on", "auto"):
        losses, masks, _, st, _ = port_run(
            "llama3.2-1b", *case, "lag-wk", fastpath, bf16=False,
            grad_hat_dtype="bfloat16")
        assert masks == ref_masks
        np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
        assert st["lag"]["grad_hat"].dtype == torch.bfloat16
        assert st["lag"]["theta_ring"].dtype == st["theta"].dtype \
            == torch.float32
