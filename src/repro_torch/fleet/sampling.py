"""Cohort sampling and client churn — port of ``repro.fleet.sampling``.

``gumbel_top_k`` draws k clients without replacement with probability
proportional to their scores: the top k of log(score) + Gumbel noise.
``churn_step`` is a two-state Markov chain per client: alive clients leave
with probability ``churn``, departed ones re-join with ``REJOIN``.

The reference draws the (N,) Gumbel noise and the (N,) churn uniforms with
``jax.random``, which PyTorch cannot reproduce, so here the draws are
operands: the topology's injectable ``draw(step) → (gumbel, uniforms)``
(the parity tests inject the reference's), or by default
:func:`host_draws`, a host ``torch.Generator`` seeded from
``SeedSequence([seed, step, chain])`` — deterministic in the round, the
same on the card and on the CPU (the noise is made on the host and copied
to the population's device).

Ties: dead clients score ``z − 1e30``, which in float32 is exactly −1e30
for all of them, and ``lax.top_k`` breaks ties by index (lowest first).
``torch.topk`` promises no order, so the top k comes from a STABLE
descending sort; the cohort is then sorted ascending, as the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: re-join probability of a departed client per round (the leave side is
#: the topology's ``churn`` dial)
REJOIN = 0.25

#: the default draws' chain ids: the deep step's and the convex run's (the
#: reference folds 1 and 0x0F1EE7 into its keys)
DEEP_CHAIN, CONVEX_CHAIN = 1, 0x0F1EE7


def host_draws(seed: int, step: int, population: int, churn: float,
               chain: int = DEEP_CHAIN
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The default draws of round ``step``: (N,) float32 Gumbel noise and,
    when churn is on, (N,) float32 uniforms in [0, 1), on the host."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence(
        [seed, step, chain]).generate_state(1)[0]))
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((population,), generator=gen,
                   dtype=torch.float32).clamp_min_(tiny)
    gumbel = -torch.log(-torch.log(u))
    uniforms = None if churn == 0.0 else torch.rand(
        (population,), generator=gen, dtype=torch.float32)
    return gumbel, uniforms


def gumbel_top_k(gumbel: torch.Tensor, scores: torch.Tensor,
                 alive: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct client ids ∝ ``scores`` among ``alive`` clients, sorted
    ascending (int64).  ``gumbel`` is the round's (N,) noise.  Dead clients
    sort below every alive one but stay finite, so with fewer than k alive
    the draw back-fills with the lowest-index dead clients (the round's
    ``active`` mask zeroes their contribution)."""
    N = scores.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"cohort size must be in [1, {N}], got {k}")
    if gumbel.shape != (N,):
        raise ValueError(f"gumbel noise must have shape ({N},), got "
                         f"{tuple(gumbel.shape)}")
    z = torch.log(torch.clamp_min(scores.to(torch.float32), 1e-38)) \
        + gumbel.to(torch.float32)
    z = torch.where(alive, z, z - 1e30)
    order = torch.sort(z, descending=True, stable=True).indices
    return torch.sort(order[:k]).values


def churn_step(uniforms: Optional[torch.Tensor], alive: torch.Tensor,
               churn: float) -> torch.Tensor:
    """One Markov churn transition of the (N,) ``alive`` mask.  At churn
    exactly 0.0 it is the identity (no draw is read), which keeps the
    churn-free fleet bitwise equal to the synchronous path."""
    if churn == 0.0:
        return alive
    if not 0.0 <= churn <= 1.0:
        raise ValueError(f"churn must be in [0, 1], got {churn}")
    if uniforms is None or uniforms.shape != alive.shape:
        raise ValueError(f"churn {churn} needs (N,) uniforms, got "
                         f"{None if uniforms is None else tuple(uniforms.shape)}")
    u = uniforms.to(torch.float32)
    return torch.where(alive, ~(u < churn), u < REJOIN)
