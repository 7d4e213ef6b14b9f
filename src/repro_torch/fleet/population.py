"""Flat per-client population state of a fleet run — port of
``repro.fleet.population``.

A fleet tracks N ≫ k clients, but only the sampled k-cohort computes in a
round.  Every policy mirror (``grad_hat``, ``theta_hat``, LAQ's ``resid``)
lives in ONE compact ``(N, packed_cols)`` buffer (``FlatLayout``'s compact
view: LANES padding per leaf, no 256-row tail — 128 elements a client for
a 4-element convex leaf, where the plane layout takes 32,768), plus three
``(N,)`` bookkeeping vectors:

  fleet_alive   bool, the churn process (a departed client's mirrors
                persist: it re-joins stale)
  fleet_age     int32 rounds since the client last took part
  fleet_innov   float32 last measured innovation ‖∇L_m − ĝ_m‖², the lazy
                selection score (``INNOV_INIT`` until first polled)

The round-side seam is gather → policy → scatter:

  ``gather_state``   the cohort's compact rows → fresh ``(k, rows, 128)``
                     plane buffers, the state ``engine.rounds.
                     policy_rounds`` runs on unchanged
  ``scatter_state``  the cohort's advanced plane buffers → their compact
                     rows (``index_copy_``); rows of clients that churned
                     out mid-round keep their old values exactly

Both copy leaf by leaf, so no full-width row is duplicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.fastpath.layout import LANES, FlatLayout

#: never-polled clients carry this innovation score, so the lazy selection
#: rule drafts them before any measured client
INNOV_INIT = 1e30

#: lag-group key prefix of the compact mirrors ("fleet_m_grad_hat", …)
MIRROR_PREFIX = "fleet_m_"


@dataclasses.dataclass(frozen=True)
class Population:
    """Static description of one fleet population's flat state."""
    size: int                          # N clients
    layout: FlatLayout                 # of the UNSTACKED mirror template
    state_keys: Tuple[str, ...]        # policy mirror keys
    dtypes: Tuple[torch.dtype, ...]    # each mirror's dtype

    @classmethod
    def for_template(cls, template, state_keys, size: int, dtypes=None
                     ) -> "Population":
        """Population over ``size`` clients whose mirrors are shaped like
        ``template``; ``dtypes`` (one per key) default to the layout's."""
        if size < 1:
            raise ValueError(f"population size must be >= 1, got {size}")
        lo = template if isinstance(template, FlatLayout) \
            else FlatLayout.for_tree(template)
        keys = tuple(state_keys)
        dts = (lo.dtype,) * len(keys) if dtypes is None else tuple(dtypes)
        return cls(size=int(size), layout=lo, state_keys=keys, dtypes=dts)

    @classmethod
    def for_policy(cls, layout: FlatLayout, policy, size: int
                   ) -> "Population":
        """The mirrors ``policy.init_state`` keeps, each in its dtype (LAQ's
        residual is float32 whatever the tree's)."""
        tmpl = layout.empty((1,), "meta")
        st = policy.init_state(tmpl, tmpl if policy.needs_theta_hat
                               else None)
        return cls.for_template(layout, policy.state_keys, size,
                                [st[k].dtype for k in policy.state_keys])

    # -- state construction -------------------------------------------------

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        """Fresh flat population state on ``device``: zero mirrors (the
        all-upload-on-first-contact init) and the bookkeeping vectors."""
        N = self.size
        st = {MIRROR_PREFIX + k: torch.zeros(
            (N, self.layout.packed_cols), dtype=dt, device=device)
            for k, dt in zip(self.state_keys, self.dtypes)}
        st["fleet_alive"] = torch.ones((N,), dtype=torch.bool, device=device)
        st["fleet_age"] = torch.zeros((N,), dtype=torch.int32, device=device)
        st["fleet_innov"] = torch.full((N,), INNOV_INIT, dtype=torch.float32,
                                       device=device)
        return st

    # -- the gather / scatter seam ------------------------------------------

    def gather_state(self, lag_state: Dict, cohort: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
        """The cohort's rows of every mirror as fresh ``(k, rows, 128)``
        plane buffers (zero padding), slot j holding client ``cohort[j]``."""
        k, lo = cohort.shape[0], self.layout
        out = {}
        for key in self.state_keys:
            src = lag_state[MIRROR_PREFIX + key]
            buf = torch.zeros((k, lo.rows, LANES), dtype=src.dtype,
                              device=src.device)
            flat = buf.view(k, -1)
            for c, p, n in lo.packed_segments():
                flat[:, p:p + n].copy_(src[:, c:c + n].index_select(0, cohort))
            out[key] = buf
        return out

    def scatter_state(self, lag_state: Dict, cohort: torch.Tensor,
                      new_pst: Dict[str, torch.Tensor],
                      active: Optional[torch.Tensor] = None) -> Dict:
        """Write the cohort's advanced plane buffers back into their compact
        rows, in place.  ``active`` (k,) masks mid-round dropouts: their
        rows keep their previous values exactly."""
        k, lo = cohort.shape[0], self.layout
        updates = {}
        for key in self.state_keys:
            dst = lag_state[MIRROR_PREFIX + key]
            flat = new_pst[key].view(k, -1)
            for c, p, n in lo.packed_segments():
                new = flat[:, p:p + n]
                if active is not None:
                    new = torch.where(active[:, None], new,
                                      dst[:, c:c + n].index_select(0, cohort))
                dst[:, c:c + n].index_copy_(0, cohort, new.to(dst.dtype))
            updates[MIRROR_PREFIX + key] = dst
        return updates

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Population(N={self.size}, "
                f"packed_cols={self.layout.packed_cols}, "
                f"mirrors={self.state_keys})")
