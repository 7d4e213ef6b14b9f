"""Population-scale convex problems — port of ``repro.fleet.problems``.

``fleet_problem`` builds a synthetic ``Problem`` vectorized in N (one
batched ``eigvalsh`` over the (N, d, d) client Grams), with per-client
smoothness targets log-uniform over ``[L_base, L_base·L_spread]``.  The
data come from the reference's numpy stream and arithmetic: bitwise the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.convex import Problem, smoothness
from repro_torch.device import resolve_device


def fleet_problem(kind: str = "linreg", *, num_clients: int,
                  n_per: int = 2, d: int = 4, L_base: float = 1.0,
                  L_spread: float = 100.0, lam: float = 0.0,
                  seed: int = 0, dtype: torch.dtype = torch.float32,
                  device="cuda") -> Problem:
    """A ``Problem`` with ``num_clients`` workers of ``n_per`` samples in
    ``d`` dims, each feature-rescaled so its L_m hits a log-uniform draw
    from ``[L_base, L_base·L_spread]`` (linreg: L_m = 2λ_max(X_mᵀX_m);
    logreg: ¼λ_max + λ/N), on ``device`` ("cuda" by default)."""
    device = resolve_device(device)
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    rng = np.random.default_rng(seed)
    N = int(num_clients)
    theta_true = rng.standard_normal(d)
    G = rng.standard_normal((N, n_per, d))
    lmax = np.linalg.eigvalsh(
        np.einsum("mni,mnj->mij", G, G))[:, -1]            # (N,) batched
    L_t = L_base * np.exp(rng.uniform(0.0, np.log(L_spread), N))
    lam_w = lam / N
    if kind == "linreg":
        s = np.sqrt(L_t / (2.0 * lmax))                    # L_m = 2s²λmax
    elif kind == "logreg":
        s = np.sqrt(np.maximum(L_t - lam_w, 1e-9)
                    / (0.25 * lmax))                       # ¼s²λmax + λ_w
    else:
        raise ValueError(f"kind must be 'linreg' or 'logreg', got {kind!r}")
    X = s[:, None, None] * G
    z = np.einsum("mnd,d->mn", X, theta_true)
    if kind == "linreg":
        y = z + 0.1 * rng.standard_normal((N, n_per))
        L_m = L_t
    else:
        p = 1.0 / (1.0 + np.exp(-z))
        y = np.where(rng.uniform(size=(N, n_per)) < p, 1.0, -1.0)
        L_m = 0.25 * (s ** 2) * lmax + lam_w
    L_global = smoothness(kind, X.reshape(-1, d), lam)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dtype).to(
            device)

    return Problem(name=f"fleet-{kind}-{N}", kind=kind, X=put(X), y=put(y),
                   L_m=put(L_m), L=L_global, lam=lam)
