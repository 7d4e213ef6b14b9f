"""The communication-policy protocol — port of ``repro.comm.base``.

A policy owns one worker's round: ``encode`` (candidate upload),
``should_upload`` (the trigger), ``decode`` (mask the payload into the
server's ledger and advance the worker's mirror state) and ``wire_bytes``.
The batched fast path adds ``fast_precompute`` (one kernel launch for all
workers' trigger/encode reductions, before the trigger) and ``fast_decode``
(the masked state folds, after it).

Trees here are nested dicts of tensors (``repro_torch.core.tree``); a flat
``(W, rows, 128)`` buffer of ``repro_torch.fastpath.layout`` is a one-leaf
tree, so the fast route runs ``encode``/``should_upload`` ONCE on the
stacked buffers with the worker dim written out (the reference vmaps them).

The fast route works in place to fit full-width models on one card:
``fast_decode`` folds the payload into ``grad_hat`` (and ``theta_hat``) in
place and turns the payload buffer into the masked delta in place.  The
plain route is functional.  A tree of bfloat16 and float32 leaves keeps
each state as a ``fastpath.layout.Parts`` pair, a node of two leaves:
the fast route's ``tree_map``s step each part.

The collective wire format (``wire_pack``/``wire_unpack``/
``wire_slot_bytes``) is what the device plane (``repro_torch.devrun``)
moves between ranks: the dense family ships the masked float32 flat
buffer, LAQ packed codes and per-leaf steps (``repro_torch.comm.laq``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map

Pytree = Any
PolicyState = Dict[str, Any]


@dataclasses.dataclass
class CommRound:
    """Everything one worker (or, on the fast route, every worker at once)
    sees when deciding/encoding one round."""
    theta: Pytree                        # current iterate θ^k (shared)
    grad_new: Pytree                     # fresh gradient ∇L_m(θ^k)
    hist: torch.Tensor                   # (D,) iterate-lag ring buffer
    cfg: lag.LAGConfig                   # α, M, D, ξ — the trigger constants
    L_m: Optional[torch.Tensor] = None   # smoothness (PS rule only)
    fast: Optional[Dict[str, Any]] = None    # the batched precompute
    grad_at_hat: Optional[Pytree] = None     # ∇ℓ_m(θ̂_m) (LASG-WK only)
    k: Optional[int] = None                  # round index (schedules)
    # this worker's id: an int on the plain route, the (W,) ids on the
    # device on the fast route
    worker_id: Any = None
    draw: Optional[int] = None   # the worker a sampled schedule drew


def _innovation(g: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    """g − ĝ at g's dtype: ĝ cast to it first when it is wider (the
    reference's ``g - gh.astype(g.dtype)``)."""
    if torch.promote_types(g.dtype, gh.dtype) == g.dtype:
        return g - gh
    return g - gh.to(g.dtype)


def _mask_like(comm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Broadcast a () or (W,) mask against a payload leaf."""
    m = comm.to(p.dtype)
    return m.reshape(m.shape + (1,) * (p.dim() - m.dim()))


class CommPolicy:
    """Base class: the dense δ∇ = ∇L_m(θ^k) − ĝ_m upload family.

    Every shipped policy implements :meth:`fast_precompute`; the base
    method raises — the tripwire against a new policy silently bypassing
    the plane.
    """
    name: str = "base"
    state_keys: Tuple[str, ...] = ("grad_hat",)
    needs_theta_hat: bool = False
    needs_L_m: bool = False
    needs_grad_at_hat: bool = False  # the trainer's 2nd backward pass at θ̂_m
    needs_rng: bool = False          # the trainer passes a per-round draw

    def __init__(self, sqnorm_fn: Callable[[Pytree], torch.Tensor]
                 = lag.tree_sqnorm, fastpath="auto"):
        from repro_torch.fastpath import plan as plan_lib
        # the triggers' squared norm off the plane; injectable so the
        # trainer can supply the per-leaf kernels' fused_tree_sqnorm
        self.sqnorm_fn = sqnorm_fn
        # the batched plane ("auto", "on" or a plan), or None: no plan,
        # where make_policy(use_pallas=True) selected the per-leaf kernels
        # or the convex driver the plain route of a float64 problem
        self.fastpath = None if fastpath is None \
            else plan_lib.make_plan(fastpath)

    # -- state --------------------------------------------------------------
    def init_state(self, grad0, theta0=None) -> PolicyState:
        """Mirror state from zero templates: zero ``grad_hat`` with an empty
        history makes round 0 trigger every worker."""
        st: PolicyState = {"grad_hat": grad0}
        if self.needs_theta_hat:
            if theta0 is None:
                raise ValueError(f"{self.name} policy needs theta0")
            st["theta_hat"] = theta0
        return st

    # -- the four protocol methods ------------------------------------------
    def encode(self, ctx: CommRound, st: PolicyState
               ) -> Tuple[Pytree, Dict[str, Any]]:
        """Candidate upload: the gradient innovation g − ĝ, at g's dtype.
        Bfloat16 ĝ mirrors of float32 gradients are widened inside the
        subtraction (no float32 copy of ĝ: exact either way)."""
        payload = tree_map(_innovation, ctx.grad_new, st["grad_hat"])
        return payload, {}

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, ctx: CommRound, st: PolicyState, payload: Pytree,
               aux: Dict[str, Any], comm: torch.Tensor
               ) -> Tuple[Pytree, PolicyState]:
        """(server-side δ∇ contribution, advanced worker state); the delta
        is all-zero when ``comm`` is False and ``grad_hat`` absorbs exactly
        it (the Σ_m ĝ_m = ∇^k invariant)."""
        delta = tree_map(lambda p: comm.to(p.dtype) * p, payload)
        new_st = dict(st)
        new_st["grad_hat"] = tree_map(lambda gh, d: gh + d.to(gh.dtype),
                                      st["grad_hat"], delta)
        if "theta_hat" in st:
            new_st["theta_hat"] = lag.tree_select(comm, ctx.theta,
                                                  st["theta_hat"])
        return delta, new_st

    # -- the batched fast path ----------------------------------------------
    def fast_precompute(self, plan, grads: torch.Tensor, st: PolicyState, *,
                        theta: torch.Tensor, layout,
                        grad_at_hat: Optional[torch.Tensor] = None
                        ) -> Optional[Dict[str, Any]]:
        """Batched per-round precompute over the (W, rows, 128) buffers: a
        dict of (W, …) tensors routed into ``ctx.fast``, or None when the
        policy has nothing kernel-served (the plain route then runs).
        ``grad_at_hat`` is LASG-WK's stacked ∇ℓ_m(θ̂_m), read here only."""
        raise NotImplementedError(
            f"{type(self).__name__} does not declare a fast-path route: "
            f"implement fast_precompute() to serve its trigger/encode "
            f"reductions from the batched plane (repro_torch.fastpath), or "
            f"'return None' to explicitly opt out")

    def fast_decode(self, plan, st: PolicyState, payload: torch.Tensor,
                    aux: Dict[str, Any], comm: torch.Tensor, *,
                    theta: torch.Tensor, layout
                    ) -> Tuple[torch.Tensor, PolicyState]:
        """Batched :meth:`decode` over the (W, rows, 128) buffers, IN PLACE:
        ĝ ← ĝ + m·payload and θ̂ ← where(m, θ, θ̂) update the state buffers,
        then the payload buffer becomes the masked delta m·payload."""
        new_st = dict(st)
        new_st["grad_hat"] = plan.masked_add(payload, st["grad_hat"], comm,
                                             out=st["grad_hat"])
        if "theta_hat" in st:
            new_st["theta_hat"] = plan.masked_select(
                theta, st["theta_hat"], comm, out=st["theta_hat"])
        delta = tree_map(lambda p: p.mul_(_mask_like(comm, p)), payload)
        return delta, new_st

    def wire_bytes(self, grad_like: Pytree) -> float:
        """Bytes ONE triggered upload of ``grad_like`` puts on the wire:
        the raw payload (size × itemsize per leaf)."""
        return float(sum(l.numel() * l.element_size()
                         for l in tree_leaves(grad_like)))

    # -- the collective wire format (repro_torch.devrun) ---------------------
    #
    # When each worker is a rank of its own, the masked payloads cross
    # between processes as concrete tensors, so each policy declares what
    # they are: ``wire_pack`` turns the round's stacked (W, rows, 128)
    # delta (the decode's, a quiet worker's rows zero; plus the encode's
    # ``aux`` and the upload mask) into a dict of fixed-shape tensors with
    # a leading worker dim — a quiet worker's slot is all-zero, absorbing
    # under the sum — ``wire_unpack`` turns gathered ones back into
    # per-worker float32 summands, and ``wire_slot_bytes`` is one worker's
    # exact byte count.  The contract is an exact round trip:
    # ``wire_unpack(wire_pack(delta))`` equals the delta's float32 buffer
    # (bit for bit but for LAQ's codes rounded to −0, which come back +0),
    # so summing it in worker order is ``sum_reduce``.

    def wire_pack(self, layout, payload: torch.Tensor, aux: Dict[str, Any],
                  comm: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(W, rows, 128) delta → ``{"payload": its float32 buffer}``.
        The delta is the round's decoded one, whose quiet rows the decode
        has zeroed and which ``sum_reduce`` sums in-process, so a float32
        delta goes on the wire as it is: no mask pass, no second copy."""
        return {"payload": payload.to(torch.float32)}

    def wire_unpack(self, layout, wire: Dict[str, torch.Tensor], *,
                    rows: Optional[slice] = None, device=None
                    ) -> torch.Tensor:
        """Gathered wire tensors (leading worker dim) → (W, rows, 128)
        float32 summands; summed over dim 0 in worker order they are
        ``engine.rounds.sum_reduce``'s.  ``rows`` (a slice of
        whole 256-row blocks) unpacks those rows alone and ``device``
        moves only what they need there first: the device plane sums a
        full-width wire staged on the host chunk by chunk."""
        buf = wire["payload"]
        if rows is not None:
            buf = buf[:, rows]
        return buf if device is None else buf.to(device)

    def wire_slot_bytes(self, layout) -> Dict[str, int]:
        """Exact bytes of ONE worker's wire tensors, keyed like
        :meth:`wire_pack`'s dict (framing included: the layout's padding)."""
        from repro_torch.fastpath.layout import LANES
        return {"payload": layout.rows * LANES * 4}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(name={self.name!r})"
