"""The kernel route (``use_pallas=True``: RMSNorm and flash attention on
the card) against the plain route, on the moe kind's reduced config.

Every test here needs a CUDA device (``cuda`` marker; it skips without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

It was ``tests/test_torch_moe.py``'s, whose JAX imports kept it off the
card's machine.
"""
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_inputs
from repro_torch.models import model

ARCH = "qwen3-moe-30b-a3b"
RTOL, ATOL = 1e-5, 2e-5


# ---------------------------------------------------------------------------
# On the card: the kernel route against the plain route
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernel_route_matches_plain(cuda_device):
    cfg = get_config(ARCH).reduced()
    params = model.init(cfg, device=cuda_device, seed=0)
    b = make_inputs(cfg, TokenStream(cfg.vocab_size), 0, 2, 80,
                    device=cuda_device)
    with torch.no_grad():
        got, got_aux = model.forward_with_aux(
            params, cfg.replace(use_pallas=True), b)
        want, want_aux = model.forward_with_aux(params, cfg, b)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_aux, want_aux, rtol=RTOL, atol=ATOL)
