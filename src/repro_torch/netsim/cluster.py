"""Event-driven cluster cost model: price every round in seconds — port
of ``repro.netsim.cluster`` (numpy only, a copy).

The engine measures communication in ROUNDS and policy-declared WIRE
BYTES (``RunReport.comm_mask`` / ``bytes_per_upload``).  This module adds
simulated wall-clock on a network where uploads are not free:

  ``Link``          latency + bandwidth; ``transfer_seconds(nbytes)``
  ``Cluster``       per-worker uplinks, per-worker compute time with an
                    optional straggler distribution, a shared server
                    ingress NIC, and the broadcast downlink
  ``make_cluster``  spec strings — ``"hetero:9@10ms/1Gbps"``
  ``price_mask``    the event-driven round simulation:
                    (K, W) upload mask → (K,) round seconds
  ``price_report``  attach ``round_seconds`` / ``wall_seconds`` /
                    ``seconds_to(ε)`` to any ``RunReport``

The round model (one parameter-server round, eq. 4's synchronous step):

  1. every worker finishes its gradient + trigger at
     ``compute_s[m] · straggler_jitter[k, m]``;
  2. its (free, payload-less) skip decision — or its payload — reaches
     the server after the uplink latency;
  3. payloads SERIALIZE on the server's ingress NIC at
     ``min(uplink bw, server bw)`` in arrival order (a single-server
     queue, simulated event by event: every skipped upload is
     ``wire_bytes / rate`` seconds the queue never pays);
  4. once the last decision/payload is in, the server steps and
     broadcasts θ^{k+1} (dense params, every round — LAG never skips the
     downlink, only uplinks).

Pure numpy on the host: the priced object is duck-typed (anything with
``comm_mask`` / ``bytes_per_upload`` / ``extras``).  Straggler draws are
deterministic per (cluster.seed, round, worker), and every price is
bitwise the reference's on the same mask.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

#: default per-round gradient compute time (seconds) — one simulation
#: constant for every profile so comm/compute ratios are set by the link
#: spec, not hidden per-profile magic
DEFAULT_COMPUTE_S = 1e-3

#: "hetero" profile shape: slowest uplink is BW_SPREAD× slower than the
#: fastest, latencies ramp LAT_SPREAD× — worker m gets the m-th step of
#: the geometric ramp (worker 0 fastest)
BW_SPREAD = 8.0
LAT_SPREAD = 4.0

#: "straggler" profile: lognormal σ on per-(round, worker) compute time
STRAGGLER_SIGMA = 0.5


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed network link."""
    latency_s: float
    bandwidth_Bps: float

    def transfer_seconds(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` across this link (latency + wire)."""
        return self.latency_s + float(nbytes) / self.bandwidth_Bps


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A parameter-server cluster: M workers behind heterogeneous uplinks.

    ``up_latency_s`` / ``up_bw_Bps`` / ``compute_s`` are (M,) arrays;
    ``server_bw_Bps`` is the shared ingress NIC uploads serialize on;
    ``bcast`` is the θ-broadcast downlink; ``straggler_sigma`` > 0 draws
    lognormal per-(round, worker) compute jitter seeded by ``seed``.
    """
    name: str
    up_latency_s: np.ndarray
    up_bw_Bps: np.ndarray
    compute_s: np.ndarray
    bcast: Link
    server_bw_Bps: float
    straggler_sigma: float = 0.0
    seed: int = 0

    @property
    def num_workers(self) -> int:
        return int(self.up_latency_s.shape[0])

    def compute_jitter(self, num_rounds: int) -> np.ndarray:
        """(K, M) multiplicative compute-time jitter, deterministic per
        (seed, round, worker); all-ones when ``straggler_sigma == 0``."""
        K, M = num_rounds, self.num_workers
        if not self.straggler_sigma:
            return np.ones((K, M))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        return rng.lognormal(0.0, self.straggler_sigma, size=(K, M))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Cluster({self.name!r}, M={self.num_workers}, "
                f"lat={self.up_latency_s.min():.2g}–"
                f"{self.up_latency_s.max():.2g}s, "
                f"bw={self.up_bw_Bps.min():.3g}–"
                f"{self.up_bw_Bps.max():.3g}B/s)")


# ---------------------------------------------------------------------------
# Spec parsing
# ---------------------------------------------------------------------------

_TIME_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6}
_BW_PREFIX = {"": 1.0, "k": 1e3, "m": 1e6, "g": 1e9}


def _parse_time(s: str, spec: str) -> float:
    m = re.fullmatch(r"([0-9.]+)\s*(us|ms|s)", s.strip())
    if not m:
        raise ValueError(f"bad cluster spec {spec!r}: {s!r} is not a "
                         f"latency (want e.g. '10ms', '50us', '1s')")
    return float(m.group(1)) * _TIME_UNITS[m.group(2)]


def _parse_bw(s: str, spec: str) -> float:
    # the b/B case is meaningful (bits vs bytes); the k/M/G prefix is not
    m = re.fullmatch(r"([0-9.]+)\s*([kKmMgG]?)(b|B)ps", s.strip())
    if not m:
        raise ValueError(f"bad cluster spec {spec!r}: {s!r} is not a "
                         f"bandwidth (want e.g. '1Gbps', '56Kbps', "
                         f"'125MBps'; lowercase b = bits, B = bytes)")
    val = float(m.group(1)) * _BW_PREFIX[m.group(2).lower()]
    return val if m.group(3) == "B" else val / 8


def _uniform(M, lat, bw):
    return (np.full((M,), lat), np.full((M,), bw), 0.0)


def _hetero(M, lat, bw):
    # geometric ramps: worker 0 on the fast link, worker M-1 the slow one
    t = np.arange(M) / max(M - 1, 1)
    return (lat * LAT_SPREAD ** t, bw * BW_SPREAD ** (-t), 0.0)


def _straggler(M, lat, bw):
    lats, bws, _ = _uniform(M, lat, bw)
    return (lats, bws, STRAGGLER_SIGMA)


#: "fleet" profile: lognormal per-client link draws (σ below) + compute
#: jitter — consumer uplinks are heavy-tailed, not a tidy geometric ramp
FLEET_LINK_SIGMA = 0.75


def _fleet(M, lat, bw):
    # deterministic draw (fixed stream id): the same N-client fleet spec
    # always prices identically; the base lat/bw are the MEDIAN link
    rng = np.random.default_rng(np.random.SeedSequence([0xF1EE7]))
    lats = lat * rng.lognormal(0.0, FLEET_LINK_SIGMA, M)
    bws = bw * rng.lognormal(0.0, FLEET_LINK_SIGMA, M)
    return (lats, bws, STRAGGLER_SIGMA)


#: profile name → (M, base latency, base bw) → (latencies, bws, sigma)
CLUSTERS = {
    "uniform": _uniform,
    "hetero": _hetero,
    "straggler": _straggler,
    "fleet": _fleet,
}


def make_cluster(spec, num_workers: Optional[int] = None,
                 compute_s: float = DEFAULT_COMPUTE_S,
                 seed: int = 0) -> Cluster:
    """Build a ``Cluster`` from a spec string (or pass one through).

    Grammar: ``<profile>[:<workers>][@<latency>/<bandwidth>]`` —
    ``"uniform:9@10ms/1Gbps"``, ``"hetero:9@10ms/1Gbps"`` (geometric
    per-worker link spread), ``"straggler:4@1ms/10Gbps"`` (lognormal
    compute jitter).  Workers default to ``num_workers`` (e.g. the run's
    unit count); when both are given they must agree.  Latency/bandwidth
    default to 10ms/1Gbps.  The server ingress NIC and the broadcast
    downlink both get the base (fastest) latency/bandwidth.
    """
    if isinstance(spec, Cluster):
        if num_workers is not None and spec.num_workers != num_workers:
            raise ValueError(f"cluster has {spec.num_workers} workers but "
                             f"the run has {num_workers} units")
        return spec
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"cluster spec must be a non-empty string or a "
                         f"Cluster, got {spec!r}")
    head, sep_at, links = spec.partition("@")
    name, sep, workers = head.partition(":")
    name = name.strip()
    if name not in CLUSTERS:
        raise ValueError(f"unknown cluster profile {spec!r}; known: "
                         f"{tuple(CLUSTERS)} (grammar "
                         f"'<profile>[:<workers>][@<lat>/<bw>]', e.g. "
                         f"'hetero:9@10ms/1Gbps')")
    M = num_workers
    if sep:
        try:
            M = int(workers)
        except ValueError:
            raise ValueError(f"bad cluster spec {spec!r}: ':{workers}' is "
                             f"not an integer worker count") from None
        if M < 1:
            raise ValueError(f"bad cluster spec {spec!r}: worker count "
                             f"must be >= 1")
        if num_workers is not None and M != num_workers:
            raise ValueError(f"cluster spec {spec!r} names {M} workers but "
                             f"the run has {num_workers} units")
    if M is None:
        raise ValueError(f"cluster spec {spec!r} omits the worker count and "
                         f"none was supplied — spell it (e.g. "
                         f"'{name}:9@10ms/1Gbps')")
    lat, bw = 10e-3, 1e9 / 8          # default 10ms / 1Gbps
    if sep_at:
        lat_s, slash, bw_s = links.partition("/")
        if not slash:
            raise ValueError(f"bad cluster spec {spec!r}: '@{links}' must "
                             f"be '<latency>/<bandwidth>' (e.g. "
                             f"'@10ms/1Gbps')")
        lat, bw = _parse_time(lat_s, spec), _parse_bw(bw_s, spec)
    lats, bws, sigma = CLUSTERS[name](M, lat, bw)
    return Cluster(name=name, up_latency_s=lats, up_bw_Bps=bws,
                   compute_s=np.full((M,), compute_s),
                   bcast=Link(lat, bw), server_bw_Bps=bw,
                   straggler_sigma=sigma, seed=seed)


# ---------------------------------------------------------------------------
# The event-driven round simulation
# ---------------------------------------------------------------------------

def price_mask(comm_mask, bytes_per_upload: float, cluster: Cluster,
               dense_bytes: Optional[float] = None) -> np.ndarray:
    """(K, W) upload mask → (K,) simulated seconds per round.

    Event-driven single-server queue per round (vectorized over rounds,
    one pass over the worker axis in arrival order): uploads serialize on
    the server ingress NIC; skip decisions are free control messages that
    still gate the synchronous barrier.  ``dense_bytes`` sizes the θ
    broadcast (defaults to ``bytes_per_upload`` — exact for the dense
    policies, an undercount for quantized uplinks whose broadcast stays
    dense, so pass the real param bytes when you have them).
    """
    mask = np.asarray(comm_mask, bool)
    if mask.ndim != 2:
        raise ValueError(f"comm_mask must be (rounds, workers), got shape "
                         f"{mask.shape}")
    K, M = mask.shape
    if M != cluster.num_workers:
        raise ValueError(f"mask has {M} workers but cluster "
                         f"{cluster.name!r} has {cluster.num_workers}")
    finish = cluster.compute_s[None, :] * cluster.compute_jitter(K)
    arrive = finish + cluster.up_latency_s[None, :]
    rate = np.minimum(cluster.up_bw_Bps, cluster.server_bw_Bps)
    xfer = float(bytes_per_upload) / rate                       # (M,)

    order = np.argsort(arrive, axis=1, kind="stable")
    rows = np.arange(K)
    busy = np.zeros(K)          # when the ingress NIC frees up
    ready = np.zeros(K)         # when the last decision/payload is in
    for j in range(M):
        m = order[:, j]
        a = arrive[rows, m]
        up = mask[rows, m]
        start = np.maximum(busy, a)
        done = start + xfer[m]
        busy = np.where(up, done, busy)
        ready = np.maximum(ready, np.where(up, done, a))
    bcast = cluster.bcast.transfer_seconds(
        bytes_per_upload if dense_bytes is None else dense_bytes)
    return ready + bcast


def price_edge_mask(comm_mask, bytes_per_upload: float, cluster: Cluster,
                    edge_dst, dense_bytes: Optional[float] = None
                    ) -> np.ndarray:
    """(K, E) per-EDGE upload mask → (K,) simulated seconds per round.

    The decentralized pricer: there is no server, so each directed edge e
    gets its own link draw (``cluster`` is sized to E, one profile row
    per edge) and payloads serialize on the DESTINATION node's ingress
    NIC — ``edge_dst[e]`` names the node edge e drains into.  The round
    ends when the slowest node has drained its in-edges and re-broadcast
    its iterate (``dense_bytes`` sizes that dense push, exactly as in
    :func:`price_mask`).  Quiet edges are free control messages that
    still gate the barrier.  When every edge shares one destination (the
    star graph) each round is a single-queue drain in arrival order —
    identical arithmetic to :func:`price_mask`, bit-for-bit (pinned by
    the reference's tests/test_graph.py).
    """
    mask = np.asarray(comm_mask, bool)
    if mask.ndim != 2:
        raise ValueError(f"comm_mask must be (rounds, edges), got shape "
                         f"{mask.shape}")
    K, E = mask.shape
    if E != cluster.num_workers:
        raise ValueError(f"mask has {E} edges but cluster "
                         f"{cluster.name!r} has {cluster.num_workers} "
                         f"link rows — size the cluster to the DIRECTED "
                         f"edge count")
    dst = np.asarray(edge_dst, np.int64)
    if dst.shape != (E,):
        raise ValueError(f"edge_dst must be ({E},) to match the mask's "
                         f"edge axis, got shape {dst.shape}")
    n_nodes = int(dst.max()) + 1 if E else 1
    finish = cluster.compute_s[None, :] * cluster.compute_jitter(K)
    arrive = finish + cluster.up_latency_s[None, :]
    rate = np.minimum(cluster.up_bw_Bps, cluster.server_bw_Bps)
    xfer = float(bytes_per_upload) / rate                       # (E,)

    order = np.argsort(arrive, axis=1, kind="stable")
    rows = np.arange(K)
    busy = np.zeros((K, n_nodes))   # when each node's ingress NIC frees up
    ready = np.zeros(K)             # when the last decision/payload is in
    for j in range(E):
        e = order[:, j]
        a = arrive[rows, e]
        up = mask[rows, e]
        node = dst[e]
        b = busy[rows, node]
        start = np.maximum(b, a)
        done = start + xfer[e]
        busy[rows, node] = np.where(up, done, b)
        ready = np.maximum(ready, np.where(up, done, a))
    bcast = cluster.bcast.transfer_seconds(
        bytes_per_upload if dense_bytes is None else dense_bytes)
    return ready + bcast


def price_cohort_mask(cohort_ids, cohort_mask, bytes_per_upload: float,
                      cluster: Cluster,
                      dense_bytes: Optional[float] = None) -> np.ndarray:
    """(K, k) sampled cohorts + upload mask → (K,) seconds per round.

    The fleet pricer: identical event model to :func:`price_mask` (skip
    decisions gate the barrier for free, payloads serialize on the
    ingress NIC in arrival order), but the per-round link arrays are
    GATHERED at the k sampled client ids — everything is (K, k), so a
    10⁶-client population prices at the cost of its cohorts, never
    O(K·N).  On the full-population identity cohort it reduces exactly
    to :func:`price_mask` (pinned by the reference's
    tests/test_netsim.py).  Compute jitter is lognormal per (cluster.seed,
    round, slot) — deterministic per seed, like the dense path.
    """
    ids = np.asarray(cohort_ids, np.int64)
    mask = np.asarray(cohort_mask, bool)
    if ids.ndim != 2 or mask.shape != ids.shape:
        raise ValueError(f"cohort_ids/cohort_mask must both be (rounds, "
                         f"cohort), got {ids.shape} and {mask.shape}")
    if ids.size and not (0 <= ids.min() and ids.max()
                         < cluster.num_workers):
        raise ValueError(f"cohort ids in [{ids.min()}, {ids.max()}] exceed "
                         f"cluster {cluster.name!r}'s "
                         f"{cluster.num_workers} clients")
    K, k = ids.shape
    if cluster.straggler_sigma:
        rng = np.random.default_rng(
            np.random.SeedSequence([cluster.seed, 1]))
        jitter = rng.lognormal(0.0, cluster.straggler_sigma, size=(K, k))
    else:
        jitter = np.ones((K, k))
    finish = cluster.compute_s[ids] * jitter
    arrive = finish + cluster.up_latency_s[ids]                 # (K, k)
    rate = np.minimum(cluster.up_bw_Bps[ids], cluster.server_bw_Bps)
    xfer = float(bytes_per_upload) / rate                       # (K, k)

    order = np.argsort(arrive, axis=1, kind="stable")
    rows = np.arange(K)
    busy = np.zeros(K)
    ready = np.zeros(K)
    for j in range(k):
        s = order[:, j]
        a = arrive[rows, s]
        up = mask[rows, s]
        start = np.maximum(busy, a)
        done = start + xfer[rows, s]
        busy = np.where(up, done, busy)
        ready = np.maximum(ready, np.where(up, done, a))
    bcast = cluster.bcast.transfer_seconds(
        bytes_per_upload if dense_bytes is None else dense_bytes)
    return ready + bcast


def price_fleet_report(report, cluster,
                       dense_bytes: Optional[float] = None):
    """Price a fleet ``RunReport`` in place (and return it).

    Reads the per-round cohorts the fleet drivers record in
    ``report.extras`` (``cohort_ids``/``cohort_comm``) and fills
    ``round_seconds`` via :func:`price_cohort_mask`; the cluster is
    sized to the POPULATION (``report.comm_mask.shape[1]``), the pricing
    work to the cohorts.
    """
    extras = report.extras
    if "cohort_ids" not in extras or "cohort_comm" not in extras:
        raise ValueError(
            "price_fleet_report needs extras['cohort_ids'] / "
            "extras['cohort_comm'] — the per-round cohorts a fleet run "
            "records; for dense (every-unit) masks use price_report")
    N = int(np.asarray(report.comm_mask).shape[1])
    cl = make_cluster(cluster, num_workers=N)
    report.round_seconds = price_cohort_mask(
        extras["cohort_ids"], extras["cohort_comm"],
        report.bytes_per_upload, cl, dense_bytes=dense_bytes)
    report.extras["cluster"] = cl.name
    report.extras["wall_seconds"] = float(report.round_seconds.sum())
    return report


def price_edge_report(report, cluster,
                      dense_bytes: Optional[float] = None):
    """Price a graph ``RunReport`` in place (and return it).

    Reads the edge map the graph drivers record in ``report.extras``
    (``edge_dst``) and fills ``round_seconds`` via
    :func:`price_edge_mask`; the cluster is sized to the DIRECTED edge
    count E = ``report.comm_mask.shape[1]`` — one link draw per edge.
    """
    extras = report.extras
    if "edge_dst" not in extras:
        raise ValueError(
            "price_edge_report needs extras['edge_dst'] — the per-edge "
            "destination map a graph run records; for star-shaped masks "
            "use price_report")
    E = int(np.asarray(report.comm_mask).shape[1])
    cl = make_cluster(cluster, num_workers=E)
    report.round_seconds = price_edge_mask(
        np.asarray(report.comm_mask), report.bytes_per_upload, cl,
        extras["edge_dst"], dense_bytes=dense_bytes)
    report.extras["cluster"] = cl.name
    report.extras["wall_seconds"] = float(report.round_seconds.sum())
    return report


def price_report(report, cluster, dense_bytes: Optional[float] = None,
                 num_workers: Optional[int] = None):
    """Price a ``RunReport``-shaped object in place (and return it).

    Fills ``report.round_seconds`` from :func:`price_mask` and records the
    cluster name + total ``wall_seconds`` in ``report.extras``; after
    this, ``report.seconds_to(eps)`` / ``report.wall_seconds`` work.
    ``cluster`` may be a spec string or a ``Cluster``.
    """
    mask = np.asarray(report.comm_mask)
    cl = make_cluster(cluster, num_workers=num_workers or mask.shape[1])
    report.round_seconds = price_mask(mask, report.bytes_per_upload, cl,
                                      dense_bytes=dense_bytes)
    report.extras["cluster"] = cl.name
    report.extras["wall_seconds"] = float(report.round_seconds.sum())
    return report
