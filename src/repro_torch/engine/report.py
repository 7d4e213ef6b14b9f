"""``RunReport`` — the result of an experiment run — port of
``repro.engine.report`` (numpy only, a copy).

It carries the per-round losses, the (K, W) upload mask, the
policy-declared wire bytes and the -to-ε accessors.  For convex runs
``opt_loss`` is the reference optimum and ``iters_to`` measures the
optimality gap; a run without an oracle optimum keeps ``opt_loss`` 0.0 and
the ε-accessors measure the raw loss.

Simulated wall-clock (the ``repro_torch.netsim`` axis): when a run is
priced against a cluster cost model — ``Experiment(cluster="hetero:9@10ms/
1Gbps")`` or ``repro_torch.netsim.cluster.price_report`` —
``round_seconds`` holds the event-driven per-round times and the time
accessors (``wall_seconds``, ``cum_seconds``, ``seconds_to``) come alive;
unpriced reports raise an actionable error instead of guessing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class RunReport:
    algo: str
    losses: np.ndarray          # (K,) objective per round
    comm_mask: np.ndarray       # (K, W) bool — unit m uploaded at round k
    opt_loss: float = 0.0
    bytes_per_upload: float = 0.0   # policy-declared wire bytes of ONE upload
    server: str = "sgd"
    topology: str = "sim"
    extras: Dict = dataclasses.field(default_factory=dict)
    # extras: driver-specific scalars (e.g. rounds_skipped,
    # trigger_rhs_underflow_rounds, L_m_spread, hetero_score, cluster,
    # wall_seconds)
    round_seconds: Optional[np.ndarray] = None   # (K,) simulated seconds
    #   per round — filled by repro_torch.netsim.cluster.price_report

    @property
    def num_units(self) -> int:
        return int(self.comm_mask.shape[1])

    @property
    def comms_per_iter(self) -> np.ndarray:
        return self.comm_mask.sum(axis=1)

    @property
    def cum_comms(self) -> np.ndarray:
        return np.cumsum(self.comms_per_iter)

    @property
    def total_comms(self) -> int:
        return int(self.comm_mask.sum())

    @property
    def uploads_per_worker(self) -> np.ndarray:
        return self.comm_mask.sum(axis=0)

    @property
    def cum_wire_bytes(self) -> np.ndarray:
        """Cumulative policy-declared bytes on the wire (LAQ's b-bit uploads
        cost ~b/32 of a dense one — upload counts alone can't see that)."""
        return self.cum_comms * self.bytes_per_upload

    @property
    def wire_bytes(self) -> float:
        """Total policy-declared wire bytes over the whole run."""
        return float(self.total_comms * self.bytes_per_upload)

    # -- simulated wall-clock (repro_torch.netsim pricing) ------------------

    def _priced(self) -> np.ndarray:
        if self.round_seconds is None:
            raise ValueError(
                "this report has no simulated wall-clock — run with "
                "Experiment(cluster=\"hetero:9@10ms/1Gbps\") or price it "
                "with repro_torch.netsim.cluster.price_report(report, "
                "cluster)")
        return np.asarray(self.round_seconds)

    @property
    def cum_seconds(self) -> np.ndarray:
        """(K,) cumulative simulated seconds under the priced cluster."""
        return np.cumsum(self._priced())

    @property
    def wall_seconds(self) -> float:
        """Total simulated wall-clock of the whole run."""
        return float(self._priced().sum())

    def seconds_to(self, eps: float) -> Optional[float]:
        """Simulated seconds to the ε optimality gap (the axis the paper's
        motivation lives on: skipped uploads → wall-clock, not just
        rounds)."""
        cum = np.cumsum(self._priced())   # raise on unpriced reports even
        k = self.iters_to(eps)            # when the run never converged
        return float(cum[k]) if k is not None else None

    def iters_to(self, eps: float) -> Optional[int]:
        err = self.losses - self.opt_loss
        hit = np.nonzero(err <= eps)[0]
        return int(hit[0]) if hit.size else None

    def comms_to(self, eps: float) -> Optional[int]:
        k = self.iters_to(eps)
        return int(self.cum_comms[k]) if k is not None else None

    def bytes_to(self, eps: float) -> Optional[float]:
        k = self.iters_to(eps)
        return float(self.cum_wire_bytes[k]) if k is not None else None

    def summary(self, eps: Optional[float] = None) -> Dict:
        """CSV/JSON-able one-row view (the benchmark artifact shape)."""
        row = {
            "algo": self.algo, "server": self.server,
            "topology": self.topology, "rounds": int(len(self.losses)),
            "final_loss": float(self.losses[-1]),
            "total_comms": self.total_comms,
            "wire_bytes": self.wire_bytes,
            "bytes_per_upload": self.bytes_per_upload,
        }
        if eps is not None:
            row.update(iters_to_eps=self.iters_to(eps),
                       comms_to_eps=self.comms_to(eps),
                       bytes_to_eps=self.bytes_to(eps))
            if self.round_seconds is not None:
                row.update(seconds_to_eps=self.seconds_to(eps))
        row.update(self.extras)
        return row
