"""Cohort selection scores: which k of the N clients to poll this round —
port of ``repro.fleet.selection``.

At fleet scale the trigger's threshold shrinks like 1/N², so nearly every
polled client fires: the lazy machinery's leverage moves from WHICH
UPLOADS to skip to WHICH CLIENTS to poll (the LASG reading).  The
``innovation`` rule carries each client's last measured trigger LHS
‖∇L_m − ĝ_m‖² forward as its score, aged so quiet clients are still
revisited.  Scores are unnormalized and positive; the sampler
(``sampling.gumbel_top_k``) is invariant to their scale.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

#: each round of absence adds this fraction of the score
AGE_BOOST = 0.1


def uniform_scores(lag_state: Dict) -> torch.Tensor:
    """Every alive client equally likely — the FedAvg-style baseline."""
    return torch.ones_like(lag_state["fleet_innov"])


def innovation_scores(lag_state: Dict) -> torch.Tensor:
    """Lazy server-side selection: the last measured innovation, linearly
    age-boosted; never-polled clients carry ``population.INNOV_INIT``."""
    innov = lag_state["fleet_innov"]
    age = lag_state["fleet_age"].to(innov.dtype)
    return innov * (1.0 + AGE_BOOST * age) + 1e-30


SELECTION_RULES: Dict[str, Callable[[Dict], torch.Tensor]] = {
    "uniform": uniform_scores,
    "innovation": innovation_scores,
}


def make_selection(name: str) -> Callable[[Dict], torch.Tensor]:
    if name not in SELECTION_RULES:
        raise ValueError(f"unknown fleet selection rule {name!r}; known: "
                         f"{tuple(SELECTION_RULES)}")
    return SELECTION_RULES[name]
