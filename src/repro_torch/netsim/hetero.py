"""The heterogeneity dial, convex half — port of ``repro.netsim.hetero``:
convex problems whose *data heterogeneity* is a measurable, sweepable knob.

The paper's headline theory (Sec. 3) says LAG's communication savings grow
with the spread of the per-worker smoothness constants L_m.
:func:`hetero_problem` turns that axis into a dial ``h``: a
``repro_torch.core.convex.Problem`` whose per-worker smoothness targets
ramp geometrically from uniform (h = 0, the Fig.-4 regime) to the paper's
Fig.-3-sized spread (h = 1), with the LARGEST L_m held fixed so the
stepsize regime stays comparable across the dial.  The data come from one
``np.random.default_rng(seed)`` stream with per-worker rescaling: bitwise
the reference's.

Measurables reported into ``RunReport.extras`` by the convex topology
(``repro_torch.engine.topology.SimWorkers``):

  ``L_m_spread``   realized max L_m / min L_m — the dial's direct readout
  ``hetero_score`` the fraction of workers whose L_m falls below the
                   trigger-derived skip threshold (:func:`hetero_score`)

The deep half, :func:`shard_noise_levels` and :func:`hetero_inputs`, dials
the token-noise level of each worker's batch shard; its batches are
bitwise the reference's (the same numpy ``SeedSequence([seed, step,
worker])`` streams) and land on ``device`` (the card by default).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import convex
from repro_torch.device import resolve_device

# h = 1 spread of the smoothness targets: the paper's Fig.-3 ramp
# L_m = (1.3^{m-1}+1)^2 spans (1.3^8+1)^2 / (1.3^0+1)^2 ≈ 21× over 9 workers.
PAPER_L_MAX = float((1.3 ** 8 + 1.0) ** 2)
PAPER_SPREAD = float((1.3 ** 8 + 1.0) ** 2 / (1.3 ** 0 + 1.0) ** 2)


def _host(L_m) -> np.ndarray:
    """L_m (a tensor on any device, an array or a list) as float64 numpy."""
    if isinstance(L_m, torch.Tensor):
        L_m = L_m.detach().cpu().double().numpy()
    return np.asarray(L_m, np.float64)


def hetero_L_targets(num_workers: int, h: float, *,
                     L_max: float = PAPER_L_MAX,
                     spread: float = PAPER_SPREAD) -> np.ndarray:
    """Per-worker smoothness targets for dial position ``h`` ∈ [0, 1].

    Geometric ramp ending at ``L_max`` with realized spread
    ``spread ** h``: h = 0 ⇒ all workers at L_max (uniform, Fig.-4
    regime); h = 1 ⇒ the full Fig.-3-sized spread.  Keeping the TOP of
    the ramp fixed keeps the roughest worker — which dominates the global
    L and hence the α = 1/L stepsize — on a comparable scale across the
    dial, so sweeps compare trigger behavior, not stepsize regimes.
    """
    if not 0.0 <= h <= 1.0:
        raise ValueError(f"heterogeneity dial h must be in [0, 1], got {h}")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    ratio = float(spread) ** float(h)
    if num_workers == 1:
        return np.asarray([L_max], np.float64)
    expo = np.arange(num_workers, dtype=np.float64)[::-1] / (num_workers - 1)
    return L_max * ratio ** (-expo)


def hetero_problem(kind: str = "linreg", *, h: float, num_workers: int = 9,
                   n_per: int = 50, d: int = 50, lam: float = 0.0,
                   seed: int = 0, L_max: float = PAPER_L_MAX,
                   spread: float = PAPER_SPREAD, dtype=None,
                   device="cuda") -> convex.Problem:
    """A convex problem at heterogeneity-dial position ``h``: the
    generator of ``repro_torch.core.convex.synthetic`` with the targets of
    :func:`hetero_L_targets`, so the realized ``Problem.L_m`` spread is
    ``spread ** h`` by construction."""
    kw = {} if dtype is None else {"dtype": dtype}
    L_targets = hetero_L_targets(num_workers, h, L_max=L_max, spread=spread)
    return convex.synthetic(kind, num_workers=num_workers, n_per=n_per, d=d,
                            L_targets=list(L_targets), lam=lam, seed=seed,
                            name=f"hetero-{kind}-h{h:g}", device=device,
                            **kw)


def realized_spread(L_m) -> float:
    """max L_m / min L_m — the dial's direct measurable."""
    L = _host(L_m)
    return float(L.max() / L.min())


def hetero_score(L_m, *, alpha: float, xi: float, D: int,
                 num_workers: Optional[int] = None) -> float:
    """The paper's Sec.-3 heterogeneity score for a run's trigger
    constants: the fraction of workers whose L_m satisfies the sufficient
    skip condition of the (15a)/(15b) triggers,

        L_m ≤ √(ξ / D) / (α · M),

    i.e. the workers the theory guarantees to stay lazy.  Conservative:
    measured savings exceed it."""
    L = _host(L_m)
    M = int(num_workers or L.shape[0])
    thresh = np.sqrt(float(xi) / float(D)) / (float(alpha) * M)
    return float(np.mean(L <= thresh))


# ---------------------------------------------------------------------------
# Deep shards: the predictability-noise dial
# ---------------------------------------------------------------------------

def shard_noise_levels(num_workers: int, h: float = 1.0,
                       noise_lo: float = 0.01,
                       noise_hi: float = 0.4) -> Sequence[float]:
    """Per-worker token-noise levels at dial position ``h``: h = 1 is the
    full ramp ``lo + (hi−lo)·m/(W−1)``, h = 0 puts every worker on its
    midpoint (homogeneous shards, the same total noise budget)."""
    if not 0.0 <= h <= 1.0:
        raise ValueError(f"heterogeneity dial h must be in [0, 1], got {h}")
    W = num_workers
    center = 0.5 * (noise_lo + noise_hi)
    levels = []
    for m in range(W):
        ramp = noise_lo + (noise_hi - noise_lo) * m / max(W - 1, 1)
        levels.append((1.0 - h) * center + h * ramp)
    return levels


def hetero_inputs(cfg, stream, step: int, num_workers: int, batch: int,
                  seq: int, *, h: float = 1.0, fixed: bool = True,
                  noise_lo: float = 0.01, noise_hi: float = 0.4,
                  device="cuda") -> dict:
    """Global LM batch {"tokens", "targets"} (B, seq) int32 on ``device``
    whose worker shards (rows ``m·B/W:(m+1)·B/W``, as ``engine.topology.
    split_batch`` cuts them) sit at dial position ``h``: worker m's stream
    noise is :func:`shard_noise_levels`'s m-th.  More noise ⇒ a rougher
    per-shard loss ⇒ a larger effective L_m.  ``fixed=True`` reuses step
    0's data every round (the paper's full-batch regime)."""
    device = resolve_device(device)
    W = num_workers
    per = batch // W
    eff_step = 0 if fixed else step
    levels = shard_noise_levels(W, h, noise_lo, noise_hi)
    shards = [stream.batch(eff_step, m, per, seq + 1, noise=levels[m])
              for m in range(W)]
    toks = np.concatenate(shards, axis=0)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(device)}
