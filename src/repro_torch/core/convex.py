"""Convex problems of the paper's experiments (Sec. 4 / Appendix I) — port
of ``repro.core.convex``.

Linear regression (eq. 85):   L_m(θ) = Σ_n (y_n − x_nᵀθ)²
Logistic regression (eq. 86): L_m(θ) = Σ_n log(1+exp(−y_n x_nᵀθ)) + λ/2 ‖θ‖²

Smoothness constants in closed form:
  linreg:  L_m = 2 λ_max(X_mᵀ X_m),      L = 2 λ_max(Xᵀ X)
  logreg:  L_m = ¼ λ_max(X_mᵀ X_m) + λ,  L = ¼ λ_max(Xᵀ X) + λ
(the paper's α = 1/L uses the global L).

The data are the reference's: the same ``np.random.default_rng`` streams
and numpy arithmetic, so X, y, L_m and L are bitwise the reference's; the
UCI datasets are shape-matched synthetic stand-ins.  A ``Problem`` holds
torch tensors on an explicit device: the generators take ``device=``
(``"cuda"`` by default, which raises without a GPU) and ``dtype=``
(float32 by default; float64 is the paper-accuracy run).  Losses and
gradients are closed forms batched over the workers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Problem:
    """A distributed convex problem: stacked per-worker data."""
    name: str
    kind: str                 # "linreg" | "logreg"
    X: torch.Tensor           # (M, N_m, d)
    y: torch.Tensor           # (M, N_m)
    L_m: torch.Tensor         # (M,) per-worker smoothness
    L: float                  # global smoothness
    lam: float = 0.0          # ℓ2 regularizer (logreg)

    @property
    def num_workers(self) -> int:
        return self.X.shape[0]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def dtype(self) -> torch.dtype:
        return self.X.dtype

    # ---- losses and gradients (full batch, per worker) -------------------
    def _worker_losses(self, z: torch.Tensor, theta: torch.Tensor
                       ) -> torch.Tensor:
        """(M,) per-worker losses at margins ``z`` (M, N_m); the logistic
        regularizer is split evenly over the workers, so that Σ_m L_m(θ)
        is eq. (86)'s global λ/2‖θ‖²."""
        if self.kind == "linreg":
            return torch.sum(torch.square(self.y - z), dim=-1)
        u = -self.y * z
        reg = 0.5 * (self.lam / self.num_workers) * torch.sum(
            torch.square(theta), dim=-1)
        return torch.sum(torch.logaddexp(torch.zeros_like(u), u),
                         dim=-1) + reg

    def _grads(self, z: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
        """(M, d) per-worker gradients from margins ``z`` (M, N_m) and the
        iterates they were taken at (``thetas``: (d,) or (M, d))."""
        X, y = self.X, self.y
        if self.kind == "linreg":
            c = 2.0 * (z - y)
        else:
            c = -y * torch.sigmoid(-y * z)
        g = torch.matmul(c.unsqueeze(1), X).squeeze(1)
        if self.kind == "logreg":
            g = g + (self.lam / self.num_workers) * thetas
        return g

    def loss(self, theta: torch.Tensor) -> torch.Tensor:
        """Σ_m L_m(θ), a 0-d tensor on the problem's device."""
        z = torch.matmul(self.X, theta)
        return torch.sum(self._worker_losses(z, theta))

    def worker_grads(self, theta: torch.Tensor) -> torch.Tensor:
        """(M, d) stacked per-worker gradients ∇L_m(θ)."""
        return self._grads(torch.matmul(self.X, theta), theta)

    def worker_grads_at(self, thetas: torch.Tensor) -> torch.Tensor:
        """(M, d) per-worker gradients with worker m evaluated at its OWN
        iterate ``thetas[m]`` — the ∇L_m(θ̂_m) the LASG-WK trigger
        differences against."""
        z = torch.matmul(self.X, thetas.unsqueeze(-1)).squeeze(-1)
        return self._grads(z, thetas)

    def optimum(self, iters: int = 200_000) -> Tuple[torch.Tensor, float]:
        """High-accuracy reference minimizer: linreg in closed form (numpy
        float64, the reference's arithmetic); logreg by ``iters`` GD steps
        with α = 1/L on the problem's device."""
        if self.kind == "linreg":
            Xf = self.X.detach().cpu().numpy().astype(np.float64).reshape(
                -1, self.dim)
            yf = self.y.detach().cpu().numpy().astype(np.float64).reshape(-1)
            A = 2.0 * Xf.T @ Xf + 1e-12 * np.eye(self.dim)
            b = 2.0 * Xf.T @ yf
            theta64 = np.linalg.solve(A, b)
            # float64 objective value so ε = 1e-8 optimality gaps resolve
            loss64 = float(np.sum((yf - Xf @ theta64) ** 2))
            return (torch.from_numpy(theta64).to(self.device, self.dtype),
                    loss64)
        theta = torch.zeros((self.dim,), dtype=self.dtype, device=self.device)
        alpha = 1.0 / self.L
        Xf = self.X.reshape(-1, self.dim)
        yf = self.y.reshape(-1)
        for _ in range(iters):
            # ∇ Σ_m L_m(θ) = Xᵀ(−y·σ(−y·Xθ)) + λθ
            c = -yf * torch.sigmoid(-yf * torch.mv(Xf, theta))
            g = torch.mv(Xf.T, c) + self.lam * theta
            theta = theta - alpha * g
        return theta, float(self.loss(theta))


# ---------------------------------------------------------------------------
# Smoothness helpers
# ---------------------------------------------------------------------------

def _lmax(G: np.ndarray) -> float:
    return float(np.linalg.eigvalsh(G)[-1])


def smoothness(kind: str, X: np.ndarray, lam: float = 0.0) -> float:
    G = X.T @ X
    if kind == "linreg":
        return 2.0 * _lmax(G)
    return 0.25 * _lmax(G) + lam


def _problem(name: str, kind: str, X: np.ndarray, ys, Ls, L: float,
             lam: float, dtype: torch.dtype, device: torch.device
             ) -> Problem:
    """numpy float64 data → a ``Problem`` in ``dtype`` on ``device`` (the
    cast rounds on the host, to nearest, as the reference's)."""
    def put(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dtype).to(
            device)
    return Problem(name=name, kind=kind, X=put(X), y=put(np.stack(ys)),
                   L_m=put(Ls), L=L, lam=lam)


# ---------------------------------------------------------------------------
# Problem generators (paper Sec. 4)
# ---------------------------------------------------------------------------

def synthetic(kind: str, *, num_workers: int = 9, n_per: int = 50,
              d: int = 50, L_targets=None, lam: float = 0.0, seed: int = 0,
              name: str = "synthetic", dtype: torch.dtype = torch.float32,
              device="cuda") -> Problem:
    """Standard-Gaussian features rescaled per worker so the per-worker
    smoothness constant hits ``L_targets[m]`` exactly (paper: increasing
    L_m = (1.3^{m-1}+1)² for Fig. 3, uniform L_m = 4 for Fig. 4)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if L_targets is None:
        L_targets = [(1.3 ** m + 1.0) ** 2 for m in range(num_workers)]
    L_targets = np.asarray(L_targets, np.float64)
    Xs, ys, Ls = [], [], []
    theta_true = rng.standard_normal(d)
    for m in range(num_workers):
        G = rng.standard_normal((n_per, d))
        base = smoothness(kind, G, 0.0)
        lam_w = lam / num_workers
        # solve scale s: linreg L_m = s²·base;
        # logreg L_m = s²·(base−λ_w)+λ_w
        if kind == "linreg":
            s = np.sqrt(L_targets[m] / base)
        else:
            s = np.sqrt(max(L_targets[m] - lam_w, 1e-9) / (base - 0.0))
        Xm = s * G
        if kind == "linreg":
            ym = Xm @ theta_true + 0.1 * rng.standard_normal(n_per)
        else:
            p = 1.0 / (1.0 + np.exp(-(Xm @ theta_true)))
            ym = np.where(rng.uniform(size=n_per) < p, 1.0, -1.0)
        Xs.append(Xm)
        ys.append(ym)
        Ls.append(smoothness(kind, Xm, lam_w))
    X = np.stack(Xs)
    L_global = smoothness(kind, X.reshape(-1, d), lam)
    return _problem(name, kind, X, ys, Ls, L_global, lam, dtype, device)


# (N, d_used) per stand-in dataset, split across 3 workers each — the paper's
# Tables 3/4 layout. d_used = min #features across the group (paper Sec. 4).
REAL_SHAPES_LINREG = {"housing": (506, 8), "bodyfat": (252, 8),
                      "abalone": (417, 8)}
REAL_SHAPES_LOGREG = {"ionosphere": (351, 34), "adult": (1605, 34),
                      "derm": (358, 34)}


def real_standin(kind: str, *, num_workers: int = 9, lam: float = 0.0,
                 seed: int = 1, scale_spread: float = 3.0,
                 dtype: torch.dtype = torch.float32, device="cuda"
                 ) -> Problem:
    """Shape-matched stand-in for the paper's real-data tests: three
    datasets × 3 workers each; per-dataset feature scale differs by
    ``scale_spread`` to mimic the natural heterogeneity across UCI sets."""
    device = resolve_device(device)
    shapes = REAL_SHAPES_LINREG if kind == "linreg" else REAL_SHAPES_LOGREG
    per_ds = num_workers // len(shapes)
    rng = np.random.default_rng(seed)
    d = min(s[1] for s in shapes.values())
    n_per = min(s[0] for s in shapes.values()) // per_ds
    Xs, ys, Ls = [], [], []
    theta_true = rng.standard_normal(d)
    for i, (ds, (N, _)) in enumerate(shapes.items()):
        scale = scale_spread ** i
        for w in range(per_ds):
            Xm = scale * rng.standard_normal((n_per, d)) / np.sqrt(d)
            if kind == "linreg":
                ym = Xm @ theta_true + 0.1 * rng.standard_normal(n_per)
            else:
                p = 1.0 / (1.0 + np.exp(-(Xm @ theta_true)))
                ym = np.where(rng.uniform(size=n_per) < p, 1.0, -1.0)
            Xs.append(Xm)
            ys.append(ym)
            Ls.append(smoothness(kind, Xm, lam / num_workers))
    X = np.stack(Xs)
    L_global = smoothness(kind, X.reshape(-1, d), lam)
    return _problem(f"real-standin-{kind}", kind, X, ys, Ls, L_global, lam,
                    dtype, device)


def gisette_standin(*, num_workers: int = 9, n: int = 2000, d: int = 512,
                    lam: float = 1e-3, seed: int = 2,
                    dtype: torch.dtype = torch.float32, device="cuda"
                    ) -> Problem:
    """Gisette-shaped logistic problem (paper: 2000 × 4837).  The default
    d = 512 is the reference's cut for its CPU benchmark; ``d=4837`` is the
    paper's own shape."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_per = n // num_workers
    theta_true = rng.standard_normal(d) / np.sqrt(d)
    Xs, ys, Ls = [], [], []
    for m in range(num_workers):
        scale = 1.0 + 0.5 * m
        Xm = scale * rng.standard_normal((n_per, d)) / np.sqrt(d)
        p = 1.0 / (1.0 + np.exp(-(Xm @ theta_true)))
        ym = np.where(rng.uniform(size=n_per) < p, 1.0, -1.0)
        Xs.append(Xm)
        ys.append(ym)
        Ls.append(smoothness("logreg", Xm, lam / num_workers))
    X = np.stack(Xs)
    return _problem("gisette-standin", "logreg", X, ys, Ls,
                    smoothness("logreg", X.reshape(-1, d), lam), lam, dtype,
                    device)
