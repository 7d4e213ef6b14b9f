"""Flat per-client population state of a fleet run — port of
``repro.fleet.population``.

A fleet tracks N ≫ k clients, but only the sampled k-cohort computes in a
round.  Every policy mirror (``grad_hat``, ``theta_hat``, LAQ's ``resid``)
lives in ONE compact ``(N, packed_cols)`` buffer (the compact view: LANES
padding per leaf, no 256-row tail — 128 elements a client for a
4-element convex leaf, where the plane layout takes 32,768), plus three
``(N,)`` bookkeeping vectors:

  fleet_alive   bool, the churn process (a departed client's mirrors
                persist: it re-joins stale)
  fleet_age     int32 rounds since the client last took part
  fleet_innov   float32 last measured innovation ‖∇L_m − ĝ_m‖², the lazy
                selection score (``INNOV_INIT`` until first polled)

The compact rows are float32 whatever the tree's dtypes, as the
reference's (float64 for a float64 mirror, which the reference's x64-less
fleet never holds): a row holds every leaf in tree order, the bfloat16 and
float32 leaves of a mixed tree (``fastpath.layout.MixedLayout``)
interleaved, as the reference's ``FlatLayout.for_tree(template)`` packs
them.

The round-side seam is gather → policy → scatter:

  ``gather_state``   the cohort's compact rows → fresh ``(k, rows, 128)``
                     plane buffers at the mirror's plane dtypes (a
                     ``Parts`` pair for a mixed tree), the state
                     ``engine.rounds.policy_rounds`` runs on unchanged;
                     exact, since a row only ever holds values of its
                     plane dtype
  ``scatter_state``  the cohort's advanced plane buffers → their compact
                     rows, widened (``index_copy_``); rows of clients that
                     churned out mid-round keep their old values exactly

Both copy leaf by leaf, so no full-width row is duplicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.fastpath.layout import (LANES, FlatLayout, Layout,
                                         MixedLayout, dtype_of, layout_for,
                                         like_parts, parts_of)

#: never-polled clients carry this innovation score, so the lazy selection
#: rule drafts them before any measured client
INNOV_INIT = 1e30

#: lag-group key prefix of the compact mirrors ("fleet_m_grad_hat", …)
MIRROR_PREFIX = "fleet_m_"


def _row_dtype(plane_dtype) -> torch.dtype:
    """A compact row's dtype: float32, or float64 for a float64 mirror."""
    return torch.float64 if torch.float64 in tuple(parts_of(plane_dtype)) \
        else torch.float32


@dataclasses.dataclass(frozen=True)
class Population:
    """Static description of one fleet population's flat state."""
    size: int                          # N clients
    layout: Layout                     # of the UNSTACKED mirror template
    state_keys: Tuple[str, ...]        # policy mirror keys
    dtypes: Tuple[Any, ...]            # each mirror's plane dtype(s)

    @classmethod
    def for_template(cls, template, state_keys, size: int, dtypes=None
                     ) -> "Population":
        """Population over ``size`` clients whose mirrors are shaped like
        ``template`` (a tree or its layout); ``dtypes`` (one per key, a
        ``Parts`` of dtypes for a mixed tree) default to the layout's."""
        if size < 1:
            raise ValueError(f"population size must be >= 1, got {size}")
        lo = template if isinstance(template, (FlatLayout, MixedLayout)) \
            else layout_for(template)
        keys = tuple(state_keys)
        dts = (dtype_of(lo.empty((1,), "meta")),) * len(keys) \
            if dtypes is None else tuple(dtypes)
        return cls(size=int(size), layout=lo, state_keys=keys, dtypes=dts)

    @classmethod
    def for_policy(cls, layout: Layout, policy, size: int) -> "Population":
        """The mirrors ``policy.init_state`` keeps, each at its plane dtype
        (the parameters' for ĝ and θ̂ — the reference's gather unpacks them
        at the parameters' dtypes — and LAQ's residual float32)."""
        tmpl = layout.empty((1,), "meta")
        st = policy.init_state(tmpl, tmpl if policy.needs_theta_hat
                               else None)
        return cls.for_template(layout, policy.state_keys, size,
                                [dtype_of(st[k]) for k in policy.state_keys])

    # -- state construction -------------------------------------------------

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        """Fresh flat population state on ``device``: zero mirrors (the
        all-upload-on-first-contact init) and the bookkeeping vectors."""
        N = self.size
        st = {MIRROR_PREFIX + k: torch.zeros(
            (N, self.layout.packed_cols), dtype=_row_dtype(dt),
            device=device) for k, dt in zip(self.state_keys, self.dtypes)}
        st["fleet_alive"] = torch.ones((N,), dtype=torch.bool, device=device)
        st["fleet_age"] = torch.zeros((N,), dtype=torch.int32, device=device)
        st["fleet_innov"] = torch.full((N,), INNOV_INIT, dtype=torch.float32,
                                       device=device)
        return st

    # -- the gather / scatter seam ------------------------------------------

    def gather_state(self, lag_state: Dict, cohort: torch.Tensor
                     ) -> Dict[str, Any]:
        """The cohort's rows of every mirror as fresh ``(k, rows, 128)``
        plane buffers (zero padding) at the mirror's plane dtypes, slot j
        holding client ``cohort[j]``."""
        k, lo = cohort.shape[0], self.layout
        segs = lo.packed_segments()
        out = {}
        for key, dt in zip(self.state_keys, self.dtypes):
            src = lag_state[MIRROR_PREFIX + key]
            bufs = [torch.zeros((k, p.rows, LANES), dtype=d,
                                device=src.device)
                    for p, d in zip(lo.parts, parts_of(dt))]
            flats = [b.view(k, -1) for b in bufs]
            for c, part, p, n in segs:
                flats[part][:, p:p + n].copy_(
                    src[:, c:c + n].index_select(0, cohort))
            out[key] = like_parts(dt, bufs)
        return out

    def scatter_state(self, lag_state: Dict, cohort: torch.Tensor,
                      new_pst: Dict[str, Any],
                      active: Optional[torch.Tensor] = None) -> Dict:
        """Write the cohort's advanced plane buffers back into their compact
        rows, widened, in place.  ``active`` (k,) masks mid-round dropouts:
        their rows keep their previous values exactly."""
        k = cohort.shape[0]
        segs = self.layout.packed_segments()
        updates = {}
        for key in self.state_keys:
            dst = lag_state[MIRROR_PREFIX + key]
            flats = [t.view(k, -1) for t in parts_of(new_pst[key])]
            for c, part, p, n in segs:
                new = flats[part][:, p:p + n].to(dst.dtype)
                if active is not None:
                    new = torch.where(active[:, None], new,
                                      dst[:, c:c + n].index_select(0, cohort))
                dst[:, c:c + n].index_copy_(0, cohort, new)
            updates[MIRROR_PREFIX + key] = dst
        return updates

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Population(N={self.size}, "
                f"packed_cols={self.layout.packed_cols}, "
                f"mirrors={self.state_keys})")
