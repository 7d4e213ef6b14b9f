"""Collective traffic counted at the call — the port's counterpart of
``repro.dist.hlo_analysis``.

The reference parses the optimized HLO of a compiled multi-device program
and charges every collective op its ring-algorithm wire bytes.  A PyTorch
program has no HLO: the device plane (``repro_torch.devrun``) calls its
collectives one by one, so :func:`all_gather` writes one record per call
(kind, output bytes, group) and :func:`collective_bytes` totals the records
with the reference's cost model (:func:`all_to_all` and
:func:`all_gather_rows`, the row-sharded trainer's, likewise).  LAQ (Sun et al., 2019) argues that
communication savings must be measured in bytes on the wire, not upload
counts; with ``pod_size`` the bytes that cross a pod boundary are totalled
too.

Cost model (per participating rank, ring algorithms, group size n; the
reference's ``_wire_bytes``):

  all-reduce           2·B·(n−1)/n      (reduce-scatter + all-gather phases)
  all-gather           B·(n−1)/n        (B = full gathered output bytes)
  reduce-scatter       B·(n−1)          (B = scattered output bytes)
  all-to-all           B·(n−1)/n
  collective-permute   B                (each rank forwards its buffer)

:func:`all_gather` moves every dtype as its bytes (gloo has no 16-bit
integer type: LAQ's 16-bit codes cross as bytes, the same bytes).  Over
gloo a CUDA tensor is staged through host memory explicitly: copied to
the host, gathered there, and the gathered tensor left on the host for the
caller to move back the parts it needs; the record counts those bytes as
``staged_bytes``, beside the collective's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch


def _wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Ring-algorithm bytes moved per participating rank.  ``n == 0``
    means an unknown global group: use the asymptotic (n−1)/n → 1 factor
    (reduce-scatter, whose exact cost grows with n, is charged its output
    bytes once — a lower bound)."""
    if n == 1:
        return 0.0
    frac = 1.0 if n == 0 else (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "all-gather":
        return nbytes * frac
    if kind == "reduce-scatter":
        return nbytes * (n - 1) if n else nbytes
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return nbytes
    return nbytes


@dataclasses.dataclass
class CollectiveStats:
    """Aggregated wire traffic of a run's (or a round's) collectives."""
    ops: List[dict] = dataclasses.field(default_factory=list)
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_kind_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    total_bytes: float = 0.0
    cross_pod_bytes: float = 0.0
    staged_bytes: float = 0.0

    def add(self, op: dict):
        self.ops.append(op)
        k = op["kind"]
        self.by_kind[k] = self.by_kind.get(k, 0.0) + op["wire_bytes"]
        self.by_kind_count[k] = self.by_kind_count.get(k, 0) + 1
        self.total_bytes += op["wire_bytes"]
        if op["cross_pod"]:
            self.cross_pod_bytes += op["wire_bytes"]
        self.staged_bytes += op.get("staged_bytes", 0)

    def as_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "cross_pod_bytes": self.cross_pod_bytes,
            "staged_bytes": self.staged_bytes,
            "by_kind_bytes": dict(self.by_kind),
            "by_kind_count": dict(self.by_kind_count),
            "n_ops": len(self.ops),
        }


def _crosses_pod(groups: List[List[int]], pod_size: Optional[int]) -> bool:
    if not pod_size:
        return False
    return any(len({m // pod_size for m in grp}) > 1 for grp in groups)


def logical_upload_bytes(policy, grad_like, uploads: int = 1) -> float:
    """Policy-declared wire bytes of ``uploads`` gradient uploads —
    ``policy.wire_bytes`` per triggered upload (what a deployment's
    transport would move), to pair with the counted physical bytes."""
    return float(uploads) * float(policy.wire_bytes(grad_like))


def policy_traffic_summary(stats: "CollectiveStats", policy, grad_like,
                           uploads: int) -> dict:
    """One report combining the counted collective traffic with the
    policy's logical wire cost."""
    return {
        "collectives": stats.as_dict(),
        "policy": getattr(policy, "name", type(policy).__name__),
        "uploads": int(uploads),
        "logical_upload_bytes": logical_upload_bytes(policy, grad_like,
                                                     uploads),
    }


def collective_bytes(records: List[dict], n_devices: Optional[int] = None,
                     pod_size: Optional[int] = None) -> CollectiveStats:
    """Total the records of collective calls (``{"kind", "bytes",
    "group"}``, as :func:`all_gather` writes them; ``bytes`` the output's
    for a gather, the reduced buffer's for an all-reduce).

    ``group`` lists the participating ranks; an empty or absent one means
    every rank of ``n_devices`` (charged the asymptotic ring factor when
    that is unknown too).  ``pod_size``: ranks per pod; a collective whose
    group spans two pods is charged to ``cross_pod_bytes`` as well.
    """
    st = CollectiveStats()
    for rec in records:
        kind, nbytes = rec["kind"], float(rec["bytes"])
        groups = [list(rec["group"])] if rec.get("group") else []
        if not groups and n_devices and kind != "collective-permute":
            groups = [list(range(n_devices))]
        if groups:
            n = max(len(g) for g in groups)
        elif kind == "collective-permute":
            n = 2
        else:
            n = 0
        pairs = rec.get("pairs")
        cross = _crosses_pod(groups, pod_size)
        if kind == "collective-permute" and pod_size and pairs:
            cross = any(a // pod_size != b // pod_size for a, b in pairs)
        st.add({"kind": kind, "bytes": nbytes, "group_size": n,
                "wire_bytes": _wire_bytes(kind, nbytes, n),
                "cross_pod": cross,
                "staged_bytes": rec.get("staged_bytes", 0),
                "what": rec.get("what")})
    return st


def all_gather(x: torch.Tensor, *, records: Optional[List[dict]] = None,
               what: Optional[str] = None, group=None) -> torch.Tensor:
    """Gather ``x`` from every rank of ``group`` → ``(n,) + x.shape``, in
    rank order, written as one record into ``records``.

    NCCL gathers a CUDA tensor on the card.  gloo gathers host tensors: a
    CUDA ``x`` is copied to the host first and the result stays there
    (``staged_bytes`` counts both copies' bytes: ``x`` down, nothing back
    — the caller moves back what it needs).
    """
    import torch.distributed as dist

    n = dist.get_world_size(group)
    staged = dist.get_backend(group) == "gloo" and x.is_cuda
    src = x.detach().to("cpu") if staged else x.detach()
    src = src.contiguous()
    nbytes = src.numel() * src.element_size()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    if nbytes:
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out.view(-1).view(torch.uint8),
               src.view(-1).view(torch.uint8), group=group)
    if records is not None:
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(n))
        records.append({"kind": "all-gather", "bytes": n * nbytes,
                        "group": ranks, "what": what,
                        "staged_bytes": nbytes if staged else 0})
    return out


def _ranks(group, n: int) -> List[int]:
    import torch.distributed as dist
    return dist.get_process_group_ranks(group) if group is not None \
        else list(range(n))


def all_to_all(x: torch.Tensor, *, records: Optional[List[dict]] = None,
               what: Optional[str] = None, group=None) -> torch.Tensor:
    """``x``'s dim 0 cut into n equal chunks, chunk s sent to rank s of
    ``group``; returns the chunks every rank sent here, in rank order, in
    ``x``'s shape, on ``x``'s device — written as one record (``bytes``:
    ``x``'s, as the reference's all-to-all is charged).

    NCCL exchanges CUDA tensors on the card.  gloo exchanges host tensors:
    a CUDA ``x`` is staged through host memory, down and back, and
    ``staged_bytes`` counts both copies."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is not a "
                         f"multiple of the group's {n} ranks")
    staged = dist.get_backend(group) == "gloo" and x.is_cuda
    src = (x.detach().to("cpu") if staged else x.detach()).contiguous()
    nbytes = src.numel() * src.element_size()
    out = torch.empty_like(src)
    if nbytes:
        dist.all_to_all_single(out.view(-1).view(torch.uint8),
                               src.view(-1).view(torch.uint8), group=group)
    if records is not None:
        records.append({"kind": "all-to-all", "bytes": nbytes,
                        "group": _ranks(group, n), "what": what,
                        "staged_bytes": 2 * nbytes if staged else 0})
    return out.to(x.device) if staged else out


def all_gather_rows(buf: torch.Tensor, *, records: Optional[List[dict]]
                    = None, what: Optional[str] = None, group=None
                    ) -> torch.Tensor:
    """Every rank's row range of ``buf`` into every rank's ``buf``, in
    place: ``buf`` is ``(n·R, …)`` and rank r owns rows ``[r·R,
    (r+1)·R)``, which it has written; one record (``bytes``: the gathered
    buffer's, as :func:`all_gather`'s).  NCCL gathers into ``buf`` on the
    card; gloo stages a CUDA ``buf``'s rows through host memory, down and
    back (``staged_bytes``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    if buf.shape[0] % n or not buf.is_contiguous():
        raise ValueError(f"all_gather_rows: want a contiguous buffer of n·R "
                         f"rows for the group's {n} ranks, got "
                         f"{tuple(buf.shape)}")
    R = buf.shape[0] // n
    staged = dist.get_backend(group) == "gloo" and buf.is_cuda
    mine = buf[r * R:(r + 1) * R]
    src = mine.to("cpu") if staged else mine.clone()
    out = torch.empty((n * R,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device="cpu") if staged else buf
    nbytes = src.numel() * src.element_size()
    if nbytes:
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out.view(-1).view(torch.uint8),
               src.view(-1).view(torch.uint8), group=group)
    if staged:
        buf.copy_(out)
    if records is not None:
        records.append({"kind": "all-gather", "bytes": n * nbytes,
                        "group": _ranks(group, n), "what": what,
                        "staged_bytes": (1 + n) * nbytes if staged else 0})
    return buf
