"""Helpers shared by the card tests (``tests/test_torch_*_cuda.py``) and
their CPU counterparts.  No JAX here: the card's machine has none.

``cuda_device`` is the fixture every card test takes (it skips where no
CUDA device is); ``np_tree`` builds the ragged test trees of the layout
and plan tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.fastpath.layout import BLOCK, LANES

# ragged leaf sizes: sub-lane, LANES−1, LANES+1, one exact block, empty
RAGGED = (1, LANES - 1, LANES + 1, BLOCK, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def np_tree(W=None, seed=0, sizes=RAGGED, scale=1.0):
    """Nested tree whose insertion order differs from JAX's sorted order."""
    rng = np.random.default_rng(seed)
    lead = () if W is None else (W,)
    mk = lambda s: (scale * rng.standard_normal(lead + (s,))).astype(
        np.float32)
    return {"z": mk(sizes[0]), "b": {"y": mk(sizes[1]), "a": mk(sizes[2])},
            "m": [mk(sizes[3]), mk(sizes[4])]}
